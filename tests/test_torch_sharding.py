"""The port's logical-axis sharding rules (``repro_torch/sharding/rules.py``)
against the reference's ``repro.sharding.rules``.

Placements: the port's spec of every leaf of ``param_axes()`` and of
``cache_axes`` equals the reference's ``logical_to_pspec`` (as a tuple of
the reference's ``PartitionSpec``), for every arch in ``ASSIGNED_ARCHS``
at full width (shapes only: no weights are made), under ``RULES_TRAIN``,
``RULES_TRAIN`` with the client axis prepended (the train state's
stacks), ``RULES_TRAIN_DP`` and ``RULES_SERVE``, on the meshes (1, 1),
(1, 2), (2, 2), (1, 4), (1, 8), (16, 16) and (2, 16, 16), each built as
``tests/test_sharding.py`` builds its meshes, over one tiled CPU device;
the port takes the same ``Mesh`` object (it reads its axis names and
sizes).  The reference's own cases (``tests/test_sharding.py``) run on
the port as one parametrised test; ``local_block`` and ``assemble`` are
each other's inverse; the block init draws the unsharded init's values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.sharding import rules as R  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "1x2": ((1, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
TABLES = {
    "train": (R.RULES_TRAIN, TR.RULES_TRAIN, False),
    "train_client": (dict(R.RULES_TRAIN, client=[("pod", "data"), ("data",)]),
                     TR.RULES_TRAIN_CLIENT, True),
    "train_dp": (RS.RULES_TRAIN_DP, TS.RULES_TRAIN_DP, True),
    "serve": (R.RULES_SERVE, TR.RULES_SERVE, False),
}
N_CLIENTS = 32  # the client stacks' leading dim (divides every data axis)
CACHE = (128, 32_768)  # decode_32k's batch and cache length


def _mesh(shape, axes):
    n = int(np.prod(shape))
    devs = np.tile(np.array(jax.devices()[:1]), n).reshape(shape)
    return Mesh(devs, axes)


@pytest.fixture(scope="module")
def meshes():
    return {k: _mesh(*v) for k, v in MESHES.items()}


def _is_dims(x):
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None)))
                                        for i in x)


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=_is_dims)


def test_rule_tables_equal_the_reference():
    for _, (ref, port, _) in TABLES.items():
        assert {k: list(v) for k, v in port.items()} == \
            {k: list(v) for k, v in ref.items()}


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_reference(arch, table, meshes):
    """Every parameter leaf's spec (with ``client`` prepended for the
    client stacks) equal to the reference's, on every mesh."""
    ref_rules, port_rules, client = TABLES[table]
    model = build_model(get_config(arch))
    tmodel = t_build_model(t_get_config(arch))
    axes, shapes = model.param_axes(), R.shapes_tree(model.specs)
    taxes, tshapes = tmodel.param_axes(), TR.shapes_tree(tmodel.specs)
    if client:
        axes = R.prepend_axis(axes, "client")
        taxes = TR.prepend_axis(taxes, "client")
        shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            (N_CLIENTS,) + s.shape, s.dtype), shapes)
    dims = _ref_leaves(axes)
    sh = jax.tree.leaves(shapes)
    tdims = tree_flatten(taxes)[1]
    tsh = [t.shape for t in tree_flatten(tshapes)[1]]
    if client:
        tsh = [(N_CLIENTS,) + tuple(s) for s in tsh]
    assert len(dims) == len(tdims) == len(sh) == len(tsh)
    for name, mesh in meshes.items():
        for d, s, td, ts in zip(dims, sh, tdims, tsh):
            assert tuple(td) == tuple(d) and tuple(ts) == tuple(s.shape)
            want = tuple(R.logical_to_pspec(tuple(d), tuple(s.shape),
                                            ref_rules, mesh))
            got = TR.logical_to_pspec(tuple(td), tuple(ts), port_rules, mesh)
            assert got == want, (arch, table, name, d, s.shape)
        if not client:  # the tree functions agree with the leaf function
            got = tree_flatten(TR.pspec_tree(taxes, tshapes, port_rules,
                                             mesh))[1]
            want = [tuple(p) for p in jax.tree.leaves(
                R.pspec_tree(axes, shapes, ref_rules, mesh),
                is_leaf=lambda x: isinstance(x, P))]
            assert got == want, (arch, table, name)


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_equal_reference(arch, table, meshes):
    """Every cache leaf's spec (decode_32k's batch and length) equal to
    the reference's, on every mesh."""
    ref_rules, port_rules, _ = TABLES[table]
    cfg, tcfg = get_config(arch), t_get_config(arch)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    cache = jax.eval_shape(lambda: model.init_cache(cfg, *CACHE))
    tcache = tmodel.init_cache(tcfg, *CACHE, device="meta")
    axes, taxes = model.cache_axes(cfg), tmodel.cache_axes(tcfg)
    assert {k: tuple(v) for k, v in taxes.items()} == \
        {k: tuple(v) for k, v in axes.items()}
    for name, mesh in meshes.items():
        for key, d in axes.items():
            shape = tuple(cache[key].shape)
            tt = tcache[key]
            tshape = tuple(tt.shape) if isinstance(tt, torch.Tensor) else ()
            assert tshape == shape, (arch, key)
            want = tuple(R.logical_to_pspec(tuple(d), shape, ref_rules, mesh))
            got = TR.logical_to_pspec(tuple(taxes[key]), tshape, port_rules,
                                      mesh)
            assert got == want, (arch, table, name, key)


CASES = {
    # tests/test_sharding.py's cases: (dims, shape, rules, mesh, want)
    "heads_divisible_sharded": (
        ("embed", "heads", "head_dim"), (512, 8, 64), "train",
        ((2, 4), ("data", "model")), P(None, "model")),
    "heads_indivisible_falls_back_to_head_dim": (
        ("embed", "kv_heads", "head_dim"), (3584, 4, 128), "train",
        ((1, 16), ("data", "model")), P(None, None, "model")),
    "experts_indivisible_unsharded": (
        ("experts", "embed", "expert_mlp"), (60, 2048, 1408), "train",
        ((1, 16), ("data", "model")), P(None, None, "model")),
    "axis_used_once_per_tensor": (
        ("mlp", "embed", "heads"), (64, 64, 64), "train",
        ((2, 4), ("data", "model")), None),
    "batch_priority_pod_data": (
        ("batch", "seq"), (64, 128), "serve",
        ((2, 2, 2), ("pod", "data", "model")), P(("pod", "data"))),
    "long_context_cache_seq_sharded_when_batch_one": (
        ("layers", "batch", "seq", "kv_heads", "head_dim"),
        (28, 1, 8192, 8, 128), "serve", ((4, 2), ("data", "model")),
        P(None, None, "data", "model")),
    "client_axis_on_data": (
        ("client", "embed", "mlp"), (4, 64, 64), "client",
        ((4, 2), ("data", "model")), P("data", None, "model")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_cases_on_the_port(case):
    dims, shape, table, (mshape, maxes), want = CASES[case]
    rules = {"train": TR.RULES_TRAIN, "serve": TR.RULES_SERVE,
             "client": dict(TR.RULES_TRAIN, client=[("pod", "data"),
                                                     ("data",)])}[table]
    mesh = _mesh(mshape, maxes)
    got = TR.logical_to_pspec(dims, shape, rules, mesh)
    assert got == TR.logical_to_pspec(dims, shape, rules,
                                      dict(zip(maxes, mshape)))
    if want is None:  # no mesh axis used twice
        used = [a for a in got if a is not None]
        assert len(used) == len(set(used)) and used
    else:
        assert got == tuple(want)


def test_param_spec_tree_roundtrip():
    tmodel = t_build_model(t_get_config("llama3.2-3b").reduced())
    axes = tree_flatten(tmodel.param_axes())[1]
    shapes = tree_flatten(TR.shapes_tree(tmodel.specs))[1]
    assert len(axes) == len(shapes)
    for d, s in zip(axes, shapes):
        assert len(d) == len(s.shape) and s.device.type == "meta"


def test_local_block_and_assemble_are_inverse():
    """Every rank's block of a leaf put back together is the leaf, on a
    (2, 2) mesh and a (2, 2, 2) one, for specs over one axis, a tuple of
    axes and none; ranks row-major over the axes."""
    gen = torch.Generator().manual_seed(0)
    leaf = torch.randn(8, 6, 4, generator=gen)
    for sizes, spec in (({"data": 2, "model": 2}, (None, "model")),
                        ({"data": 2, "model": 2}, ("data", None, "model")),
                        ({"pod": 2, "data": 2, "model": 2},
                         (("pod", "data"), "model")),
                        ({"data": 2, "model": 2}, ())):
        world = int(np.prod(list(sizes.values())))
        coords = [TR.rank_coords(sizes, r) for r in range(world)]
        assert coords[1] == dict(zip(sizes, [0] * (len(sizes) - 1) + [1]))
        blocks = [TR.local_block(leaf, spec, sizes, c) for c in coords]
        assert torch.equal(TR.assemble(blocks, leaf.shape, spec, sizes), leaf)
    # a JAX mesh names the same sizes
    assert TR.axis_sizes(_mesh((2, 4), ("data", "model"))) == {"data": 2,
                                                               "model": 4}


def test_block_init_draws_the_unsharded_values():
    """``init_params(blocks=)`` keeps each leaf's block of the same draws,
    also for a leaf drawn in row blocks (a small ``DRAW_CHUNK``)."""
    tcfg = t_get_config("qwen3-32b").reduced()
    tmodel = t_build_model(tcfg)
    whole = tmodel.init(torch.Generator().manual_seed(3))
    sizes = {"data": 1, "model": 4}
    for m in range(4):
        blocks = tmodel.blocks(TR.RULES_TRAIN, sizes, {"data": 0, "model": m})
        got = tree_flatten(tmodel.init(torch.Generator().manual_seed(3),
                                       blocks=blocks))[1]
        want = [l[b] for l, b in zip(tree_flatten(whole)[1],
                                     tree_flatten(blocks)[1])]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), m
    chunk = TR.DRAW_CHUNK
    try:
        TR.DRAW_CHUNK = 4096
        whole = tmodel.init(torch.Generator().manual_seed(3))
        blocks = tmodel.blocks(TR.RULES_TRAIN, sizes, {"data": 0, "model": 2})
        got = tree_flatten(tmodel.init(torch.Generator().manual_seed(3),
                                       blocks=blocks))[1]
    finally:
        TR.DRAW_CHUNK = chunk
    want = [l[b] for l, b in zip(tree_flatten(whole)[1],
                                 tree_flatten(blocks)[1])]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_one_process_blocks_are_whole_leaves(shape):
    """Without a mesh every block a step keeps is its whole leaf, from
    index 0 (a leaf drawn in row blocks copies these slices)."""
    from repro_torch.configs import INPUT_SHAPES

    built = TS.build_step(t_get_config("qwen2-moe-a2.7b").reduced(),
                          INPUT_SHAPES[shape])
    specs = tree_flatten(built["model"].specs)[1]
    blocks = tree_flatten(built["blocks"])[1]
    assert len(specs) == len(blocks)
    for sp, bl in zip(specs, blocks):
        assert bl == tuple(slice(0, n) for n in sp.shape), (sp.shape, bl)

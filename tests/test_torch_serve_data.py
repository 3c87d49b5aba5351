"""Serve steps over a (data, model) mesh's ``data`` axis (gloo on the CPU)
against one process and against the JAX reference.

``launch/steps.py::build_step`` places a serve step as the reference's
``RULES_SERVE`` does: over ``data`` each rank runs its rows of the batch,
or where the batch does not divide (long_500k at batch 1) the whole batch
over its block of the ring cache's slots, whose attentions are merged
over the ranks (``collectives.merge_softmax``); an MoE dispatch group
that spans ranks exchanges its expert counts (``collectives.
counts_before``).  Gloo ranks are spawned once for the module on file
stores, as ``tests/test_torch_model_axis.py`` spawns them: meshes (2, 1),
(2, 2) and (4, 1), all at the same time.  Every case runs in float32 at
``reduced()`` size on the reference's weights (``load_params``, then the
rank's blocks, ``steps.local_args``), on whole inputs drawn with numpy:

* the reference test's serve cases (``tests/test_dryrun_small.py:26-28,
  30``): Qwen2-MoE prefill, Mamba2 decode, Zamba2 long_500k (2,047
  positions in 8,192 slots, so every rank past the first holds no valid
  slot) and Qwen2-VL decode;
* a reduced Llama long_500k whose new token lands past rank 0's slots, a
  Qwen3-MoE decode whose one dispatch group spans every data rank, a
  Qwen2-MoE prefill of 4 x 192 tokens whose 512-token groups straddle
  ranks (the last group padded on the last rank), a Whisper decode, and
  a Llama decode at batch 1 whose cache (no ring) puts its slots on
  ``data``: each rank attends over its block through ``decode_attn``'s
  partials entry at its own count of valid slots.

Each rank's logits and cache block are held against the port's one-process
step on the whole inputs, and that step against the reference's unsharded
jitted step, at ``tests/test_torch_steps.py``'s standard (rtol/atol 1e-4,
the caches' atol from ``_cache_atol``); the MoE ``keep`` and slots of the
rank's tokens bit-equal to one process's; no NaN anywhere; the collectives
each rank counts on both axes equal to ``roofline.step_collectives``; each
cache leaf's block and each input's rows the ones the reference's
``logical_to_pspec(..., RULES_SERVE, mesh)`` gives on that mesh.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models.registry import input_specs  # noqa: E402
from repro.sharding.rules import RULES_SERVE, logical_to_pspec  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.registry import load_params, local_cache  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.sharding.collectives import ModelAxis  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300  # seconds a spawned process may take
MESHES = {"2x1": (2, 1), "2x2": (4, 2), "4x1": (4, 1)}  # (world, model)
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-4
CASES = {
    "qwen2moe-prefill": ("qwen2-moe-a2.7b",
                         InputShape("prefill_32k", 256, 8, "prefill")),
    "mamba2-decode": ("mamba2-2.7b", InputShape("decode_32k", 256, 8,
                                                "decode")),
    "zamba2-long": ("zamba2-7b", InputShape("long_500k", 2048, 1, "decode")),
    "qwen2vl-decode": ("qwen2-vl-72b", InputShape("decode_32k", 256, 8,
                                                  "decode")),
    # position 13,192 goes to slot 5,000: rank 1 of 2, rank 2 of 4
    "llama-long": ("llama3.2-3b", InputShape("long_500k", 13193, 1,
                                             "decode")),
    # 8 tokens, one group of 8 over every data rank
    "qwen3moe-decode": ("qwen3-moe-30b-a3b",
                        InputShape("decode_32k", 64, 8, "decode")),
    # 768 tokens in two groups of 512 (256 pads): rank boundaries at 384
    # (data 2) and 192, 384, 576 (data 4) cut them
    "qwen2moe-straddle": ("qwen2-moe-a2.7b",
                          InputShape("prefill_32k", 192, 4, "prefill")),
    "whisper-decode": ("whisper-large-v3",
                       InputShape("decode_32k", 64, 8, "decode")),
    # batch 1 of a cache without a ring: its slots on data, each rank's
    # block attended through decode_attn's partials and merged
    "llama-decode-b1": ("llama3.2-3b", InputShape("decode_32k", 64, 1,
                                                  "decode")),
    # the VLM prefill, the step factory's own code: vision embeddings and
    # M-RoPE positions on the rank's rows; at batch 1 every rank runs the
    # whole prefill and keeps its block of the cache's slots
    "qwen2vl-prefill": ("qwen2-vl-72b",
                        InputShape("prefill_32k", 256, 4, "prefill")),
    "qwen2vl-prefill-b1": ("qwen2-vl-72b",
                           InputShape("prefill_32k", 256, 1, "prefill")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# what every rank runs, and this process for one process's step
SETUP = textwrap.dedent(r"""
import torch
from repro_torch import configs as TC
from repro_torch.launch import steps as TS
from repro_torch.models import moe as MOE
from repro_torch.models.registry import load_params

F32 = dict(dtype="float32", param_dtype="float32")
ROUTES = []  # each MoE dispatch's (keep, slot, own rows) while recording
_dispatch = MOE.dispatch


def _spy(logits, cfg, **kw):
    out = _dispatch(logits, cfg, **kw)
    ROUTES.append((out[1], out[3], kw.get("own")))
    return out


MOE.dispatch = _spy


def run_case(data, mesh):
    arch, (name, seq, batch, kind) = data["arch"], data["shape"]
    shape = TC.InputShape(name, seq, batch, kind)
    cfg = TC.get_config(arch).reduced().replace(**F32)
    built = TS.build_step(cfg, shape, mesh)
    params = load_params(built["model"], data["params"])
    args = TS.local_args(built, (params, *data["args"]))
    del ROUTES[:]
    with torch.no_grad():
        logits, cache = built["step"](*args)
    return built, logits, cache, list(ROUTES)
""")

RANK_SCRIPT = SETUP + textwrap.dedent(r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch.mesh import make_client_mesh

torch.set_num_threads(1)
rank, world, m, tmp, tag = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4], sys.argv[5])
mesh = make_client_mesh(world // m, device="cpu", model=m, family="dense",
                        store=dist.FileStore(f"{tmp}/{tag}_store", world),
                        rank=rank, world_size=world)
for case in %r:
    data = torch.load(f"{tmp}/{case}.pt", weights_only=False)
    da, ma = mesh.data_axis(), mesh.model_axis()
    for ax in (da, ma):
        if ax is not None:
            ax.counts.clear()
    built, logits, cache, routes = run_case(data, mesh)
    torch.save(dict(
        logits=logits, cache=cache, routes=routes, split=built["split"],
        counts={"data": dict(da.counts),
                "model": {} if ma is None else dict(ma.counts)},
        arg_shapes={k: tuple(v.shape) for k, v in built["args"][-1].items()}
        if len(built["args"]) == 2 else None),
        f"{tmp}/{tag}_{case}_{rank}.pt")
mesh.close()
print("RESULT " + json.dumps({"coords": mesh.coords}))
""" % (list(CASES),))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _rand_cache(cache, pos: int, rng) -> dict:
    """The reference's cache (shape structs) filled as ``steps.materialize``
    fills the port's: N(0, 1) values, the positions before ``pos`` in
    their slots, ``length`` their count."""
    out = {}
    for k, s in cache.items():
        if k == "pos":
            slots = s.shape[1]
            a = np.full(s.shape, -1, np.int32)
            past = np.arange(max(0, pos - slots), pos)
            a[:, past % slots] = past
            out[k] = a
        elif k == "length":
            out[k] = np.asarray(min(pos, cache["pos"].shape[1]), np.int32)
        else:
            out[k] = rng.normal(0, 1, s.shape).astype(np.float32)
    return out


def _t_cache(cache):
    return {k: (int(v) if k == "length" else torch.from_numpy(np.array(v)))
            for k, v in cache.items()}


def _np(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float64)


def _close(got, want, name, family="dense", key="", pos=0):
    """rtol/atol 1e-4; a cache's atol as ``tests/test_torch_steps.py::
    _cache_atol`` sets it (1e-4 x max(1, its largest entry) for Mamba2's
    conv tails and the MoE, hybrid, audio and VLM caches).  A key cache
    written at position ``pos`` holds keys rotated by pos x frequency,
    an f32 angle whose rounding differs between the packages by up to a
    unit in its last place or two: there the atol is twice that unit
    times max(1, its largest entry) (the slot at 13,192: 2^-9 x |k|)."""
    want = _np(want)
    atol = TOL
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    if key.startswith("conv_") or family in ("moe", "hybrid", "audio",
                                             "vlm"):
        atol = TOL * scale
    if key in ("k", "attn_k"):
        atol = max(atol, 2 * float(np.spacing(np.float32(pos))) * scale)
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=atol,
                               err_msg=name)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's weights, whole inputs and unsharded jitted step
    for each case, then every mesh's ranks spawned at the same time."""
    tmp = tmp_path_factory.mktemp("serve_data")
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref = {}
    for i, (case, (arch, shape)) in enumerate(CASES.items()):
        cfg = get_config(arch).reduced().replace(**F32)
        built = RS.build_step(cfg, shape, mesh1)
        params = jax.tree.map(np.asarray, built["model"].init(
            jax.random.key(i)))
        rng = np.random.default_rng(100 + i)
        rcfg = built["cfg"]
        if shape.kind == "prefill":
            tree, _ = input_specs(rcfg, shape)
            batch = {k: (rng.integers(0, rcfg.vocab_size, v.shape)
                         .astype(np.int32) if v.dtype == jnp.int32
                         else rng.normal(0, 0.02, v.shape).astype(np.float32))
                     for k, v in tree.items()}
            want = jax.jit(built["step"])(params, batch)
            args = ({k: torch.from_numpy(v) for k, v in batch.items()},)
        else:
            pos = shape.seq_len - 1
            cache = _rand_cache(built["args"][1], pos, rng)
            token = rng.integers(0, rcfg.vocab_size,
                                 (shape.global_batch,)).astype(np.int32)
            want = jax.jit(built["step"])(
                params, jax.tree.map(jnp.asarray, cache), jnp.asarray(token),
                jnp.asarray(pos, jnp.int32))
            args = (_t_cache(cache), torch.from_numpy(token), pos)
        data = {"arch": arch, "shape": (shape.name, shape.seq_len,
                                        shape.global_batch, shape.kind),
                "params": params, "args": args}
        torch.save(data, tmp / f"{case}.pt")
        ref[case] = (rcfg, jax.tree.map(np.asarray, want), data)
    procs = {(tag, r): subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(m),
         str(tmp), tag], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for tag, (world, m) in MESHES.items() for r in range(world)}
    out = {"tmp": tmp, "ref": ref}
    try:
        for key, p in procs.items():
            text, err = p.communicate(timeout=TIMEOUT)
            # a signal (a negative code) tells a killed rank from an error
            assert p.returncode == 0, (key, p.returncode, err[-6000:])
            line = [l for l in text.splitlines() if l.startswith("RESULT ")][-1]
            out[key] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.fixture(scope="module")
def one(spawned):
    """This process's one-process port step of each case on the whole
    inputs, with its MoE routes."""
    ns = {}
    exec(SETUP, ns)
    out = {}
    try:
        for case in CASES:
            data = spawned["ref"][case][2]
            built, logits, cache, routes = ns["run_case"](data, None)
            out[case] = dict(built=built, logits=logits, cache=cache,
                             routes=routes)
    finally:
        TMOE.dispatch = ns["_dispatch"]
    return out


def _load(spawned, tag, case, rank):
    return torch.load(spawned["tmp"] / f"{tag}_{case}_{rank}.pt",
                      weights_only=False)


def _coords(tag, rank):
    world, m = MESHES[tag]
    return {"data": rank // m, "model": rank % m}


def _sizes(tag):
    world, m = MESHES[tag]
    return {"data": world // m, "model": m}


def _ref_mesh(tag):
    """The reference's view of a (data, model) mesh: ``logical_to_pspec``
    reads its axis names and device array's shape alone."""
    d, m = _sizes(tag).values()
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((d, m)))


def _ref_data_block(dims, shape, tag, rank):
    """The rank's block on ``data`` of a leaf, from the reference's spec."""
    spec = tuple(logical_to_pspec(tuple(dims), tuple(shape), RULES_SERVE,
                                  _ref_mesh(tag)))
    return TR.block_slices(tuple(shape), tuple(
        e if e == "data" else None for e in spec), _sizes(tag),
        _coords(tag, rank))


def _want_cache(one_case, tag, rank):
    """One process's cache cut to the rank's block: its data block by the
    reference's spec of each leaf, then its model part (``local_cache``)."""
    built = one_case["built"]
    model = built["model"]
    axes = model.cache_axes(model.cfg)
    cut = {k: (v[_ref_data_block(axes[k], v.shape, tag, rank)]
               if isinstance(v, torch.Tensor) else v)
           for k, v in one_case["cache"].items()}
    m = MESHES[tag][1]
    ma = None if m == 1 else ModelAxis(None, rank % m, m)
    return local_cache(model, cut, ma)


CELLS = [(tag, case) for tag in MESHES for case in CASES]


def _ids(cells):
    return [f"{t}-{c}" for t, c in cells]


def test_mesh_coordinates(spawned):
    for tag, (world, m) in MESHES.items():
        for r in range(world):
            assert spawned[(tag, r)]["coords"] == _coords(tag, r)


@pytest.mark.parametrize("case", list(CASES))
def test_one_process_matches_reference(spawned, one, case):
    """The port's one-process step on the whole inputs against the
    reference's unsharded jitted step: logits and every cache leaf."""
    rcfg, want, _ = spawned["ref"][case]
    shape = CASES[case][1]
    pos = shape.seq_len - 1 if shape.kind == "decode" else 0
    got = one[case]
    fam = rcfg.family
    _close(got["logits"], want[0], f"{case} logits", fam)
    for key, w in want[1].items():
        g = got["cache"][key]
        if key == "length":
            assert g == int(w)
        elif key == "pos":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, f"{case} cache {key}", fam, key, pos)


@pytest.mark.parametrize("tag,case", CELLS, ids=_ids(CELLS))
def test_rank_matches_one_process(spawned, one, tag, case):
    """Each rank's logits within tolerance of one process's rows of them
    (the whole batch's where the slots are split), its cache block equal
    to one process's block of the cache (positions exactly), no NaN."""
    rcfg = spawned["ref"][case][0]
    o = one[case]
    for r in range(MESHES[tag][0]):
        res = _load(spawned, tag, case, r)
        rows = _ref_data_block(("batch",), o["logits"].shape[:1], tag, r)
        assert torch.isfinite(res["logits"]).all()
        _close(res["logits"], o["logits"][rows], f"{tag} {case} rank {r}",
               rcfg.family)
        want = _want_cache(o, tag, r)
        assert sorted(res["cache"]) == sorted(want)
        for key, w in want.items():
            g = res["cache"][key]
            if not isinstance(w, torch.Tensor):
                assert g == w, key
            elif key == "pos":
                assert torch.equal(g, w), (tag, case, r)
            else:
                assert g.shape == w.shape, (key, g.shape, w.shape)
                assert torch.isfinite(g).all(), key
                _close(g, w, f"{tag} {case} rank {r} cache {key}",
                       rcfg.family, key)


def test_splits_are_the_rules():
    """What each case puts on ``data``: the rows of every case whose
    batch divides, the cache's slots at batch 1, nothing for Mamba2's
    recurrent long_500k state."""
    for tag in MESHES:
        for case, (arch, shape) in CASES.items():
            cfg = TC.get_config(arch).reduced()
            built = TS.build_step(cfg, _t_shape(shape), TDR.plan_mesh(
                *MESHES[tag]))
            assert built["split"] == ("seq" if shape.global_batch == 1
                                      else "batch"), (tag, case)
    cfg = TC.get_config("mamba2-2.7b").reduced()
    built = TS.build_step(cfg, TC.INPUT_SHAPES["long_500k"],
                          TDR.plan_mesh(4, 1))
    assert built["split"] is None and built["args"][2].shape == (1,)


def test_cache_slot_gives_each_rank_its_length():
    """A decode whose batch does not divide the data axis puts its
    cache's slots there, a ring or not: ``cache_slot`` names the rank
    that owns the token's slot and each rank's count of valid slots (its
    ``local_length``: a cache without a ring holds the whole cache's
    first ``length``), and ``within`` nests the model axis's block."""
    cfg = TC.get_config("llama3.2-3b").reduced()
    built = TS.build_step(cfg, TC.InputShape("decode_32k", 64, 1, "decode"),
                          TDR.plan_mesh(2, 1))
    assert built["split"] == "seq" and built["cfg"].sliding_window == 0
    assert built["args"][1]["k"].shape[2] == 32
    for pos, lengths in ((63, (32, 32)), (40, (32, 9)), (20, (21, 0))):
        got = [TL.cache_slot(pos, 32, False, ModelAxis(None, r, 2))
               for r in range(2)]
        assert [c.local_length for c in got] == list(lengths), pos
        assert [c.local for c in got] == [pos if pos < 32 else None,
                                          pos - 32 if pos >= 32 else None]
        assert all(c.length == pos + 1 and c.window == 64 for c in got)
    # a ring's slot wraps; the model axis's block of 32 slots nests in it
    ring = TL.cache_slot(70, 32, True, ModelAxis(None, 0, 2))
    assert ring.local == 6 and ring.length == 64
    inner = ring.within(slice(5, 10))
    assert (inner.local, inner.start, inner.size) == (1, 5, 5)
    assert inner.local_length == 5
    with pytest.raises(IndexError):
        TL.cache_slot(64, 32, False, ModelAxis(None, 1, 2))


def _t_shape(shape):
    return TC.InputShape(shape.name, shape.seq_len, shape.global_batch,
                         shape.kind)


@pytest.mark.parametrize("tag,case", CELLS, ids=_ids(CELLS))
def test_blocks_are_the_reference_specs(spawned, tag, case):
    """Each rank's cache leaves have the shapes of their block under the
    reference's ``logical_to_pspec(..., RULES_SERVE, mesh)`` on that mesh
    (the data entries; the model part is the rank's head plan, held by
    ``tests/test_torch_sharding.py``), and its inputs the rows of theirs,
    every other dim whole: a prefill whose batch does not divide runs its
    whole inputs on every rank."""
    arch, shape = CASES[case]
    rcfg = spawned["ref"][case][0]
    tree, dims = input_specs(rcfg, shape)
    if shape.kind == "decode":
        built = RS.build_step(rcfg, shape, Mesh(
            np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")))
        axes = built["model"].cache_axes(rcfg)
    for r in range(MESHES[tag][0]):
        res = _load(spawned, tag, case, r)
        if shape.kind == "prefill":
            for k, v in tree.items():
                rows = _ref_data_block(dims[k], v.shape, tag, r)[0]
                assert dims[k][0] == "batch"
                assert res["arg_shapes"][k] == (
                    rows.stop - rows.start, *v.shape[1:]), (k, tag, r)
            continue
        for key, v in built["args"][1].items():
            if key == "length":
                continue
            bl = _ref_data_block(axes[key], v.shape, tag, r)
            got = res["cache"][key].shape
            for i, name in enumerate(axes[key]):
                if name in ("batch", "seq"):
                    assert got[i] == bl[i].stop - bl[i].start, (key, i, tag)


@pytest.mark.parametrize("tag,case", [c for c in CELLS
                                      if "moe" in c[1]],
                         ids=_ids([c for c in CELLS if "moe" in c[1]]))
def test_moe_routes_bit_equal(spawned, one, tag, case):
    """Each MoE layer's ``keep`` and slots of the rank's tokens (and on
    the last rank the whole batch's pads) equal one process's on the
    whole batch, bit for bit."""
    o = one[case]
    shape = CASES[case][1]
    d, m = _sizes(tag)["data"], MESHES[tag][1]
    per = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                else 1) // d  # a rank's tokens
    for r in range(MESHES[tag][0]):
        res = _load(spawned, tag, case, r)
        start = r // m * per
        assert len(res["routes"]) == len(o["routes"]) > 0
        for (keep, slot, own), (wk, ws, _) in zip(res["routes"],
                                                  o["routes"]):
            e, k = keep.shape[-1], slot.shape[-1]
            rows = own.reshape(-1) > 0
            n = int(rows.sum())
            assert n == (per if r // m < d - 1 else
                         wk.shape[0] * wk.shape[1] - start)
            want_keep = wk.reshape(-1, e)[start:start + n]
            assert want_keep.any()  # the rank's tokens hold slots
            assert torch.equal(keep.reshape(-1, e)[rows], want_keep)
            assert torch.equal(slot.reshape(-1, k)[rows],
                               ws.reshape(-1, k)[start:start + n])


@pytest.mark.parametrize("tag,case", CELLS, ids=_ids(CELLS))
def test_counts_equal_the_plan(spawned, tag, case):
    """The collectives each rank counted over ``data`` and ``model``
    equal ``step_collectives``'s count for the step (the rank's tokens
    and rows on the model axis)."""
    arch, shape = CASES[case]
    world, m = MESHES[tag]
    cfg = TC.get_config(arch).reduced().replace(**F32)
    tsh = _t_shape(shape)
    for r in range(world):
        res = _load(spawned, tag, case, r)
        rows = res["logits"].shape[0]
        tokens = rows * (shape.seq_len if shape.kind == "prefill" else 1)
        want = TRL.step_collectives(shape.kind, 0, world, model=m,
                                    cfg=TS.resolve_cfg(cfg, tsh),
                                    tokens=tokens, batch=rows,
                                    seqs=rows, shape=tsh).count_by_kind
        got = {}
        for axis in res["counts"].values():
            for kind, (n, _) in axis.items():
                got[kind] = got.get(kind, 0) + n
        assert got == want, (tag, case, r, res["counts"], want)
        data_only = TRL.step_collectives(shape.kind, 0, world // m,
                                         cfg=cfg, shape=tsh).count_by_kind
        assert {k: n for k, (n, _) in res["counts"]["data"].items()} \
            == data_only, (tag, case, r)

"""The ``model`` axis for the audio, vision and trajectory families over
``torch.distributed`` (gloo on the CPU), against one process and against
the JAX reference.

Gloo ranks are spawned once for the module on file stores, as
``tests/test_torch_model_axis_families.py`` spawns its ranks: a (1, 2)
mesh, a (1, 4) mesh and a (2, 2) mesh, all at the same time, each process
with its own timeout.  Each rank runs, in float32 with the reference's
weights carried across (``load_params``, then the rank's blocks):

* ResNet-9 at width 4 (every conv's out-channels, scale and bias cut on
  ``mlp``, the FC row-parallel) and, at (1, 4), at width 2 (``c1``'s 2
  channels do not divide over 4: whole on every rank, feeding the split
  ``c2`` through ``copy_to``);
* LaneGCN at ``tests/test_torch_lanegcn.py``'s width (d_model 32, d_ff 64:
  every linear and conv column-parallel, the fusion's scores all-reduced)
  and, at (1, 2), with d_ff 63 (``head1`` whole on every rank: its inputs
  gathered with the gradient sliced, ``head2``'s input through
  ``copy_to``);
* reduced Whisper (4 heads, 2 kv heads: at M = 4 the kv heads fall back
  to ``head_dim``; 2 + 2 layers, encoder_seq 64) with a vocabulary of
  1,024 (vocab-parallel) and of 1,026 (2 x 513: whole at M = 4, as
  Whisper-large-v3's 51,866 is),

and saves what it computed; this process holds it:

* the forward output (the logits, every vocabulary block gathered; the
  predicted tracks) and ``loss_fn`` against the reference's at rtol 1e-4,
  atol 1e-4 x max(1, the largest entry);
* ``core/afl.py::device_grads`` of one client on the rank's blocks, leaf
  by leaf against the unsharded gradient's blocks at the same tolerance,
  the whole leaves (ResNet-9's FC bias, a whole layer, the norms, a
  vocabulary that does not divide) among them;
* Whisper: a prefill then 3 greedy decode steps against the unsharded
  port, each rank's cache (the self-attention's and the cross-attention's
  ``xk`` / ``xv``) equal to its part of the unsharded cache
  (``local_cache``);
* the distributed step (N = 2, two ``mads`` rounds) against the port's
  world-1 step under ``tests/test_torch_model_axis.py``'s standard (the
  sampled threshold bit-equal given the same x; k within 2, or for
  Whisper no further from the f64 rounds than 3x world 1 is, plus 2; w
  within 1e-6 of its largest entry at 97 % of the coordinates and 1e-4
  everywhere), and ResNet-9's rounds against the reference's
  ``make_afl_train_step``;
* ``ModelAxis.counts`` of each round equal to the collectives the plan
  counts (``launch/roofline.py::step_collectives``), and of one client's
  gradient equal in bytes too (``axis_collectives``);
* ``dp_client`` against world 1 (whole parameters, each client's batch
  split over ``model`` where its 2 rows divide the axis, on (1, 2) and
  (2, 2); on (1, 4) they run whole on every rank): ResNet-9's
  batch-norm statistics the whole batch's over the ranks
  (``collectives.all_sum``), and each round's ``ModelAxis.counts`` equal
  to the plan's (``step_collectives(dp_rows=)``: the gradient's
  all-reduce, ResNet-9's four a batch-norm layer).

In this process: Whisper-large-v3's three pairs sized by the plan at
M = 2, 4 and 8 on the meta device, and each family's build on a (1, 2)
mesh.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.core.mads import MadsController  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import sparsify as SP  # noqa: E402
from repro_torch.core.distributed import placement  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.dryrun import plan_mesh  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import local_cache, local_params  # noqa: E402
from repro_torch.sharding.collectives import ModelAxis  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_unflatten  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300  # seconds a spawned process may take
# name: (arch, reduced, config changes made alike on both sides)
ARCHS = {"resnet9": ("resnet9-cifar10", False, {"d_model": 4}),
         "resnet9-w2": ("resnet9-cifar10", False, {"d_model": 2}),
         "lanegcn": ("lanegcn-argoverse", False, {"d_model": 32, "d_ff": 64}),
         "lanegcn-ff63": ("lanegcn-argoverse", False,
                          {"d_model": 32, "d_ff": 63}),
         "whisper": ("whisper-large-v3", True, {}),
         "whisper-v1026": ("whisper-large-v3", True, {"vocab_size": 1026})}
MESHES = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}  # (world, model)
ONLY = {"resnet9-w2": "1x4", "lanegcn-ff63": "1x2"}  # the variants' mesh
ON = {tag: [a for a in ARCHS if ONLY.get(a, tag) == tag] for tag in MESHES}
F32 = dict(dtype="float32", param_dtype="float32")
N, B, S, GEN = 2, 4, 16, 3  # clients, global batch, seq, decode steps
LR, SAMPLE = 0.01, 65536
ROUNDS = ((1.0, 0.0), (1.0, 1.0))  # zeta of the two rounds
TAU, H2, BUDGET = 2.0, 1e-9, 100.0
DP = ("resnet9", "lanegcn", "whisper")  # dp_client's archs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# what every rank runs, and this process for world 1
SETUP = textwrap.dedent(r"""
import torch
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.core.afl import device_grads
from repro_torch.core.mads import MadsController
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model, load_params

F32 = dict(dtype="float32", param_dtype="float32")
N, B, S, GEN, LR, SAMPLE = %d, %d, %d, %d, %r, %d
ROUNDS, TAU, H2, BUDGET = %r, %r, %r, %r
ARCHS = %r


def config(name):
    arch, reduced, kw = ARCHS[name]
    cfg = get_config(arch)
    return (cfg.reduced() if reduced else cfg).replace(**F32, **kw)


def setup(name, data, key="params", dtype=None):
    cfg = config(name)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    model = build_model(cfg)
    return cfg, model, load_params(model, data[key])


def run_steps(model, cfg, data, params, mesh, rules=None, dtype="float32",
              counts=None):
    dcfg = D.DistConfig(num_clients=N, learning_rate=LR, rounds=50,
                        state_dtype=dtype, upload_dtype=dtype,
                        accum_dtype=dtype, sample_size=SAMPLE)
    ctl = MadsController(s=model.num_params())
    step = D.make_afl_train_step(model, cfg, dcfg, ctl, mesh=mesh,
                                 rules=rules)
    state = D.init_state(model, dcfg, mesh=mesh, device="cpu",
                         params=params, rules=rules)
    batch = {k: torch.as_tensor(v) for k, v in data["step_batch"].items()}
    ma = None if mesh is None else mesh.model_axis()
    hist = []
    for zeta in ROUNDS:
        z = torch.tensor(zeta)
        o = torch.ones(N)
        if ma is not None:
            ma.counts.clear()
        state, m = step(state, batch, z, o * TAU, o * H2, o * BUDGET)
        if counts is not None and ma is not None:
            counts.append({k: v[0] for k, v in ma.counts.items()})
        hist.append({k: m[k].tolist() for k in ("k", "bits", "uploads")})
    return state.w, hist


def output(model, cfg, params, batch, ma):
    kw = {} if ma is None else {"model_axis": ma}
    if cfg.family == "vision":
        return model.forward(params, cfg, batch["images"], **kw)
    if cfg.family == "trajectory":
        return model.forward(params, cfg, batch["past"], batch["lanes"],
                             **kw)[0]
    return L.gather_vocab(model.forward(params, cfg, batch["tokens"],
                                        frames=batch["frames"], **kw)[0],
                          cfg, ma)


def grads(model, cfg, params, data, layout=None, ma=None):
    batch = {k: torch.as_tensor(v)[None] for k, v in data["batch"].items()}
    w = (layout or model.layout).flatten(params)[None]
    return device_grads(model, w, batch, layout=layout, model_axis=ma)[0]


def serve(model, cfg, params, data, ma):
    kw = {} if ma is None else {"model_axis": ma}
    tokens = torch.as_tensor(data["prompt"])
    frames = torch.as_tensor(data["batch"]["frames"])
    logits, cache = model.prefill(params, cfg, tokens, frames=frames,
                                  max_seq=S + GEN, **kw)
    out = [logits]
    for i in range(GEN):
        tok = out[-1].argmax(-1)
        logits, cache = model.decode_step(params, cfg, cache, tok, S + i, **kw)
        out.append(logits)
    return torch.stack(out), cache
""" % (N, B, S, GEN, LR, SAMPLE, ROUNDS, TAU, H2, BUDGET, ARCHS))

RANK_SCRIPT = SETUP + textwrap.dedent(r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.launch.steps import RULES_TRAIN_DP
from repro_torch.models.registry import local_params
from repro_torch.sharding import rules as R

torch.set_num_threads(1)
rank, world, m, tmp, tag = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4], sys.argv[5])
names = sys.argv[6].split(",")
mesh = make_client_mesh(N, device="cpu", model=m, family="audio",
                        store=dist.FileStore(f"{tmp}/{tag}_store", world),
                        rank=rank, world_size=world)
ma = mesh.model_axis()
for name in names:
    data = torch.load(f"{tmp}/{name}.pt", weights_only=False)
    cfg, model, params = setup(name, data)
    blocks = model.blocks(R.RULES_TRAIN, mesh.axis_sizes, mesh.coords)
    lp = local_params(model, params, blocks)
    batch = {k: torch.as_tensor(v) for k, v in data["batch"].items()}
    res = {}
    with torch.no_grad():
        res["out"] = output(model, cfg, lp, batch, ma)
        res["loss"] = model.loss_fn(lp, cfg, batch, model_axis=ma)
        if cfg.family == "audio":
            res["serve"], res["cache"] = serve(model, cfg, lp, data, ma)
    pl = D.placement(model, mesh)
    ma.counts.clear()
    res["grads"] = grads(model, cfg, lp, data, pl.layout, ma)
    res["grad_counts"] = dict(ma.counts)
    if "drawn" in data:  # the weights as drawn
        _, _, pd = setup(name, data, "drawn")
        res["grads_drawn"] = grads(model, cfg, local_params(
            model, pd, blocks), data, pl.layout, ma)
    with torch.no_grad():
        x = local_params(model, model.layout.unflatten(data["x"]),
                         blocks, lead=1)
        res["threshold"] = D.block_threshold(pl.layout.flatten(x, lead=1),
                                             model, pl, data["k"], SAMPLE)
    res["counts"] = []
    res["w"], res["hist"] = run_steps(model, cfg, data, params, mesh,
                                      counts=res["counts"])
    if data["dp"]:
        res["counts_dp"] = []
        res["w_dp"], res["hist_dp"] = run_steps(model, cfg, data, params,
                                                mesh, RULES_TRAIN_DP,
                                                counts=res["counts_dp"])
    torch.save(res, f"{tmp}/{tag}_{name}_{rank}.pt")
mesh.close()
print("RESULT " + json.dumps({"coords": mesh.coords}))
""")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _ref_pair(name):
    arch, reduced, kw = ARCHS[name]
    cfg = get_config(arch)
    cfg = (cfg.reduced() if reduced else cfg).replace(**F32, **kw)
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(0)))
    return cfg, model, params


def _conditioned(name, params):
    """The reference's draws with each stacked ``normal`` leaf scaled to
    one layer's deviation (``chip_smoke.py::conditioned``, phase 25b-c's
    method): the reference's rule takes a stacked leaf's layer count as
    its fan-in, and so drawn, the reduced Whisper's f32 forward sits
    ~3e-4 from f64's in both packages (``tests/test_torch_families.py``
    holds it at twice the tolerance), and no 1e-4 standard can hold a
    mesh to it (``test_gradients_as_drawn_within_the_reference_s_distance``
    holds the drawn weights' gradient to the reference's own distance)."""
    arch, reduced, kw = ARCHS[name]
    cfg = t_get_config(arch)
    cfg = (cfg.reduced() if reduced else cfg).replace(**kw)
    paths, leaves = tree_flatten(params)
    out = []
    for sp, leaf in zip(tree_flatten(t_build_model(cfg).specs)[1], leaves):
        if (sp.init == "normal" and sp.dims[:1] == ("layers",)
                and len(sp.shape) >= 3):
            leaf = (leaf * (sp.shape[0] / sp.shape[1]) ** 0.5).astype(
                leaf.dtype)
        out.append(leaf)
    return tree_unflatten(paths, out)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's weights and inputs written once, then every mesh's
    ranks spawned at the same time; their results by (mesh, arch, rank)."""
    tmp = tmp_path_factory.mktemp("model_axis_more")
    ref = {}
    for i, name in enumerate(ARCHS):
        cfg, model, drawn = _ref_pair(name)
        audio = cfg.family == "audio"
        params = _conditioned(name, drawn) if audio else drawn
        rng = np.random.default_rng(40 + i)
        batch = demo_batch(cfg, 2, S, rng)
        step_batch = demo_batch(cfg, B, S, rng)
        s = int(sum(np.size(l) for l in jax.tree.leaves(params)))
        gen = torch.Generator().manual_seed(i)
        data = {"params": params, "batch": batch, "step_batch": step_batch,
                "prompt": rng.integers(0, max(cfg.vocab_size, 1),
                                       (2, S)).astype(np.int32),
                "x": torch.randn(N, s, generator=gen),
                "k": torch.tensor([s / 400.0, s / 7.0]), "dp": name in DP}
        if audio:
            data["drawn"] = drawn
        torch.save(data, tmp / f"{name}.pt")
        ref[name] = (cfg, model, params, data)
    procs = {(tag, r): subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(m),
         str(tmp), tag, ",".join(ON[tag])], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag, (world, m) in MESHES.items() for r in range(world)}
    out = {"tmp": tmp, "ref": ref}
    try:
        for key, p in procs.items():
            text, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (key, err[-3000:])
            line = [l for l in text.splitlines() if l.startswith("RESULT ")][-1]
            out[key] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    atol = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=name)


def _hold_step(w_block, hist, w_want_block, hist_want, s, name,
               hist64=None, w64_block=None):
    """``tests/test_torch_model_axis.py``'s standard: k within 2 of the
    wanted rounds' (or no further from the f64 rounds ``hist64`` than 3x
    the wanted f32 rounds are, plus 2); bits = bits_for_k(k); w within
    1e-6 of its largest entry at 97 % of the coordinates and 1e-4
    everywhere (or no further from the f64 w than 3x the wanted f32 w
    is)."""
    for r, (got, want) in enumerate(zip(hist, hist_want)):
        assert got["uploads"] == want["uploads"], name
        d = np.abs(np.subtract(got["k"], want["k"]))
        if hist64 is not None:
            kf = hist64[r]["k"]
            floor = 3 * np.abs(np.subtract(want["k"], kf)) + 2
            d = np.where(np.abs(np.subtract(got["k"], kf)) <= floor, 0, d)
        assert np.all(d <= 2), (name, got["k"], want["k"], hist64)
        bits = SP.bits_for_k(torch.tensor(got["k"]), s, 32)
        assert torch.equal(bits * torch.tensor(got["uploads"]),
                           torch.tensor(got["bits"])), name
    assert sum(sum(h["k"]) for h in hist) > 0, name
    big = float(w_want_block.abs().max())
    off = (w_block - w_want_block).abs() / big
    assert float((off > 1e-6).float().mean()) <= 0.03, (name, off.max())
    if w64_block is not None and float(off.max()) > 1e-4:
        far = float((w_block - w64_block).abs().max())
        assert far <= 3 * float((w_want_block - w64_block).abs().max()), (
            name, float(off.max()), far)
        return
    assert float(off.max()) <= 1e-4, (name, float(off.max()))


def _mesh(tag, rank):
    world, m = MESHES[tag]
    return TM.ClientMesh(group=None, rank=rank, world_size=world,
                         device=torch.device("cpu"), model=m)


def _want_block(model, w, tag, rank):
    """The rank's flat blocks of a whole flat ``w``."""
    pl = placement(model, _mesh(tag, rank))
    blocks = tree_unflatten(model.layout.paths, list(pl.blocks))
    return pl.layout.flatten(local_params(model, model.layout.unflatten(w),
                                          blocks))


def _load(spawned, tag, name, rank):
    return torch.load(spawned["tmp"] / f"{tag}_{name}_{rank}.pt",
                      weights_only=False)


def _ranks(tag):
    return range(MESHES[tag][0])


def _axis(tag, rank):
    m = MESHES[tag][1]
    return ModelAxis(None, rank % m, m)


def _f64(cfg):
    """The f64 world-1 rounds' config, for the enc-dec: the vision and
    trajectory models cast their inputs to f32 (as the reference's)."""
    return cfg.replace(dtype=torch.float64, param_dtype=torch.float64)


@pytest.fixture(scope="module")
def one(spawned):
    """This process's world-1 runs of the same work, by arch."""
    ns = {}
    exec(SETUP, ns)
    out = {}
    for name in ARCHS:
        data = spawned["ref"][name][3]
        cfg, model, params = ns["setup"](name, data)
        o = dict(cfg=cfg, model=model)
        if cfg.family == "audio":
            with torch.no_grad():
                o["served"], o["cache"] = ns["serve"](model, cfg, params,
                                                      data, None)
        o["grads"] = ns["grads"](model, cfg, params, data)
        if "drawn" in data:
            o["grads_drawn"] = ns["grads"](model, cfg, ns["setup"](
                name, data, "drawn")[2], data)
        o["w"], o["hist"] = ns["run_steps"](model, cfg, data, params, None)
        o["hist64"] = o["w64"] = None
        if cfg.family == "audio":
            # the same rounds in f64: the f32 rounds' distance from it is
            # the floor that another summation order cannot be held under
            m64 = t_build_model(_f64(cfg))
            paths, leaves = tree_flatten(params)
            w64, o["hist64"] = ns["run_steps"](
                m64, _f64(cfg), data,
                tree_unflatten(paths, [v.double() for v in leaves]), None,
                dtype=torch.float64)
            o["w64"] = w64.float()
        o["threshold"] = SP.tree_threshold(data["x"], model.layout, data["k"],
                                           method="sampled", sample=SAMPLE)
        out[name] = o
    return out


CASES = [(tag, name) for tag in MESHES for name in ON[tag]]
AUDIO = [(t, a) for t, a in CASES if "whisper" in a]
DP_CASES = [(t, a) for t, a in CASES if a in DP]


def _ids(cases):
    return [f"{t}-{a}" for t, a in cases]


def _ref_output(cfg, model, params, batch):
    if cfg.family == "vision":
        return model.forward(params, cfg, batch["images"])[0]
    if cfg.family == "trajectory":
        return model.forward(params, cfg, batch["past"], batch["lanes"])[0]
    return model.forward(params, cfg, batch["tokens"],
                         frames=batch["frames"])[0]


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_forward_and_loss_match_reference(spawned, tag, name):
    cfg, model, params, data = spawned["ref"][name]
    batch = {k: jnp.asarray(v) for k, v in data["batch"].items()}
    want = _ref_output(cfg, model, params, batch)
    want_loss = float(model.loss_fn(params, cfg, batch))
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        _close(res["out"], want, 1e-4, f"{tag} {name} rank {r} output")
        assert abs(float(res["loss"]) - want_loss) <= 1e-4 * abs(want_loss), (
            tag, name, r, float(res["loss"]), want_loss)


@pytest.mark.parametrize("tag,name", AUDIO, ids=_ids(AUDIO))
def test_prefill_and_decode_match_unsharded(spawned, one, tag, name):
    """Logits of the prefill and each decode step; each rank's cache, the
    cross-attention's ``xk`` / ``xv`` among it, is the unsharded cache's
    part (the kv heads of its q heads)."""
    o = one[name]
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        _close(res["serve"], o["served"], 1e-4, f"{tag} {name} rank {r}")
        want = local_cache(o["model"], o["cache"], _axis(tag, r))
        assert set(res["cache"]) == set(want) >= {"xk", "xv"}, (tag, name)
        for key, got in res["cache"].items():
            assert got.shape == want[key].shape, (tag, name, key)
            _close(got, want[key], 1e-4, f"{tag} {name} rank {r} {key}")
        if tag != "1x4":  # the rank's kv heads: a half of them
            assert res["cache"]["xk"].shape[3] == 1, (tag, name)


# whole leaves (every rank holds them) that carry a gradient, by arch
NAMED = {"resnet9": ("fc/b",), "resnet9-w2": ("c1/w", "c1/scale", "fc/b"),
         "lanegcn": ("head2/w",),
         "lanegcn-ff63": ("head1/w", "head1/b", "head2/w"),
         "whisper": ("enc_layers/ln_attn/scale", "dec_layers/mlp/bo",
                     "dec_layers/cross_attn/wk", "dec_ln_f/bias"),
         "whisper-v1026": ("embed/tok", "unembed/w", "dec_layers/mlp/bo")}


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_gradients_match_unsharded_blocks(spawned, one, tag, name):
    """One client's gradient on the rank's blocks, leaf by leaf, against
    the unsharded gradient's blocks: a whole leaf carries the whole
    gradient on every rank, a gathered input the sum of the ranks' parts
    (a split consumer) or one rank's (a whole consumer), never M times
    it."""
    o = one[name]
    model = o["model"]
    whole = model.layout.unflatten(o["grads"][None].clone())
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        want = _want_block(model, o["grads"], tag, r)
        layout = placement(model, _mesh(tag, r)).layout
        for path, got, exp in zip(layout.paths, layout.leaves(
                res["grads"][None]), layout.leaves(want[None])):
            _close(got[0], exp[0], 1e-4,
                   f"{tag} {name} rank {r} {'/'.join(path)}")
    for key in NAMED[name]:
        leaf = whole
        for part in key.split("/"):
            leaf = leaf[part]
        assert float(leaf.abs().max()) > 0, (name, key)


@pytest.mark.parametrize("tag,name", AUDIO, ids=_ids(AUDIO))
def test_gradients_as_drawn_within_the_reference_s_distance(spawned, one,
                                                            tag, name):
    """As drawn (not ``_conditioned``): one client's f32 gradient on the
    rank's blocks no further from the unsharded port's, leaf by leaf, than
    3x the reference's own gradient is (plus 1e-6 of the gradient's
    largest entry): the reduced Whisper's gradients sit ~5e-4 of a leaf
    apart under any other summation order, the mesh's or XLA's."""
    cfg, model, _, data = spawned["ref"][name]
    batch = {k: jnp.asarray(v) for k, v in data["batch"].items()}
    g = jax.grad(lambda p: model.loss_fn(p, cfg, batch))(
        jax.tree.map(jnp.asarray, data["drawn"]))
    ref = torch.cat([torch.as_tensor(np.array(l, np.float32)).reshape(-1)
                     for l in jax.tree.leaves(g)])
    o = one[name]
    tm = o["model"]
    big = float(o["grads_drawn"].abs().max())
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        want = _want_block(tm, o["grads_drawn"], tag, r)
        far = _want_block(tm, ref, tag, r)
        layout = placement(tm, _mesh(tag, r)).layout
        for path, got, exp, rf in zip(
                layout.paths, layout.leaves(res["grads_drawn"][None]),
                layout.leaves(want[None]), layout.leaves(far[None])):
            off = float((got - exp).abs().max())
            assert off <= 3 * float((rf - exp).abs().max()) + 1e-6 * big, (
                tag, name, r, "/".join(path), off)


def test_whole_layers_where_widths_do_not_divide():
    """The rules' fallback, which the variants exercise: ResNet-9's ``c1``
    at width 2 (and at width 4 on 8) and LaneGCN's ``head1`` at d_ff 63
    are whole on every rank, their neighbours cut; Whisper-large-v3's
    vocabulary is whole at 4 and its 20 heads run whole at 8."""
    from repro_torch.sharding.rules import RULES_TRAIN

    def specs(name, m, **kw):
        arch, reduced, ch = ARCHS[name]
        cfg = t_get_config(arch)
        cfg = (cfg.reduced() if reduced else cfg).replace(**dict(ch, **kw))
        return t_build_model(cfg).param_pspecs(RULES_TRAIN,
                                               {"data": 1, "model": m})

    w2 = specs("resnet9-w2", 4)
    assert w2["c1"]["w"] == () and w2["c2"]["w"] == (None, None, None,
                                                       "model")
    assert specs("resnet9", 8)["c1"]["scale"] == ()
    assert specs("resnet9", 4)["fc"]["w"] == ("model",)
    ff = specs("lanegcn-ff63", 2)
    assert ff["head1"]["w"] == () and ff["head2"]["w"] == (None, "model")
    assert specs("lanegcn", 8, d_model=128, d_ff=256)["head2"]["b"] == ()
    big = t_build_model(t_get_config("whisper-large-v3"))
    p4 = big.param_pspecs(RULES_TRAIN, {"data": 1, "model": 4})
    assert p4["embed"]["tok"] == () and p4["unembed"]["w"] == ()
    assert p4["dec_layers"]["cross_attn"]["wk"] == (None, None, "model")
    from repro_torch.models.layers import head_plan

    assert not head_plan(big.cfg, ModelAxis(None, 1, 8)).split
    cache = big.init_cache(big.cfg.replace(num_layers=1), 8, 16,
                           device="meta", model_axis=ModelAxis(None, 1, 4))
    assert cache["xk"].shape == (1, 8, 1500, 5, 64)


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_threshold_bit_equal_given_the_same_x(spawned, one, tag, name):
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        assert torch.equal(res["threshold"], one[name]["threshold"]), (tag, r)


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_step_matches_world_one(spawned, one, tag, name):
    o = one[name]
    s = o["model"].num_params()
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        _hold_step(res["w"], res["hist"],
                   _want_block(o["model"], o["w"], tag, r), o["hist"],
                   s, f"{tag} {name} rank {r}", o["hist64"],
                   None if o["w64"] is None
                   else _want_block(o["model"], o["w64"], tag, r))


@pytest.mark.parametrize("tag", list(MESHES))
def test_step_matches_reference_step(spawned, one, tag):
    """ResNet-9's rounds against the reference's jitted step."""
    name = "resnet9"
    cfg, model, params, data = spawned["ref"][name]
    rd = RD.DistConfig(num_clients=N, learning_rate=LR, rounds=50,
                       state_dtype="float32", sample_size=SAMPLE)
    rstep = jax.jit(RD.make_afl_train_step(
        model, cfg, rd, MadsController(s=model.num_params())))
    state = RD.init_state(model, rd, jax.random.key(0))
    state = state._replace(
        w=jax.tree.map(jnp.asarray, params),
        w_n=jax.tree.map(lambda l: jnp.broadcast_to(
            jnp.asarray(l)[None], (N,) + l.shape), params))
    batch = {k: jnp.asarray(v) for k, v in data["step_batch"].items()}
    hist = []
    o = np.ones(N, np.float32)
    for zeta in ROUNDS:
        state, m = rstep(state, batch, jnp.asarray(zeta, jnp.float32),
                         jnp.asarray(o * TAU), jnp.asarray(o * H2),
                         jnp.asarray(o * BUDGET))
        hist.append({k: np.asarray(m[k]).tolist()
                     for k in ("k", "bits", "uploads")})
    tmodel = one[name]["model"]
    w = torch.cat([torch.as_tensor(np.array(l, np.float32)).reshape(-1)
                   for l in jax.tree.leaves(state.w)])
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        _hold_step(res["w"], res["hist"], _want_block(tmodel, w, tag, r),
                   hist, tmodel.num_params(), f"{tag} reference rank {r}")


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_axis_counts_equal_the_plan(spawned, one, tag, name):
    """Each round's collectives over ``model`` (``ModelAxis.counts``)
    equal to ``step_collectives``'s count on a mesh of data 1 (the
    model's, and the round's norms, count and sample)."""
    world, m = MESHES[tag]
    cfg = one[name]["cfg"]
    seqs = B // (world // m)
    tokens = seqs * (S if cfg.family == "audio" else 1)
    want = TRL.step_collectives("train", 0, m, N // (world // m), model=m,
                                cfg=cfg, tokens=tokens,
                                seqs=seqs).count_by_kind
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        for got in res["counts"]:
            assert got == want, (tag, name, r, got, want)


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_gradient_collectives_equal_the_plan_in_bytes(spawned, one, tag,
                                                      name):
    """One client's gradient (2 samples): its collectives over ``model``
    and their bytes (``ModelAxis.counts``: a gather's block) equal to
    ``axis_collectives``'s (a gather's result, m blocks), which counts the
    enc-dec's from its layers and runs the vision and trajectory models on
    the meta device."""
    world, m = MESHES[tag]
    cfg = one[name]["cfg"]
    seqs = 2
    tokens = seqs * (S if cfg.family == "audio" else 1)
    want = {}
    for k, b, n in TRL.axis_collectives("train", cfg, m, tokens, 1,
                                        seqs=seqs):
        c, t = want.get(k, (0, 0))
        want[k] = (c + n, t + b * n / (m if k == "all-gather" else 1))
    for r in _ranks(tag):
        got = _load(spawned, tag, name, r)["grad_counts"]
        assert {k: (n, float(b)) for k, (n, b) in got.items()} == want, (
            tag, name, r, got, want)


@pytest.mark.parametrize("tag,name", DP_CASES, ids=_ids(DP_CASES))
def test_dp_client_matches_default(spawned, one, tag, name):
    """``dp_client`` (whole parameters on every rank, each client's batch
    split over ``model`` where its rows divide, the gradient all-reduced;
    ResNet-9's batch-norm statistics the whole batch's) against world
    1."""
    o = one[name]
    s = o["model"].num_params()
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        assert res["w_dp"].numel() == s
        _hold_step(res["w_dp"], res["hist_dp"], o["w"], o["hist"], s,
                   f"{tag} {name} dp rank {r}", o["hist64"], o["w64"])


@pytest.mark.parametrize("tag,name", DP_CASES, ids=_ids(DP_CASES))
def test_dp_client_counts_equal_the_plan(spawned, one, tag, name):
    """Each ``dp_client`` round's collectives over ``model`` equal to
    ``step_collectives(dp_rows=)``'s: where a client's rows divide the
    axis, the gradient's all-reduce and ResNet-9's two sums a batch-norm
    layer both ways; the round's norms, count and sample everywhere."""
    world, m = MESHES[tag]
    data = world // m
    cfg = one[name]["cfg"]
    s = one[name]["model"].num_params()
    rows = B // N
    per = rows // m if rows % m == 0 else rows
    tokens = per * (S if cfg.family == "audio" else 1)
    want = TRL.step_collectives("train", s, m, N // data, model=m, cfg=cfg,
                                tokens=tokens, params_per_card=s,
                                dp_rows=rows).count_by_kind
    for r in _ranks(tag):
        res = _load(spawned, tag, name, r)
        assert len(res["counts_dp"]) == len(ROUNDS)
        for got in res["counts_dp"]:
            assert got == want, (tag, name, r, got, want)


# ---------------------------------------------------------------------------
# Plans and builds, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_plan_sizes_whisper_on_meta(shape, m):
    """Whisper-large-v3's pairs built and sized by the plan on the meta
    device: no longer from the rules alone, each rank's arguments its
    blocks, the collectives counted; the serve steps' cross cache holds
    the rank's kv heads where its 20 heads divide (M = 2, 4)."""
    from repro_torch.launch import dryrun as DR

    cfg = t_get_config("whisper-large-v3")
    rec, built = DR.plan(cfg, INPUT_SHAPES[shape], world=m, model=m)
    one, _ = DR.plan(cfg, INPUT_SHAPES[shape], world=1, model=1)
    assert rec["status"] == "ok" and "not_ported" not in json.dumps(rec)
    assert built["model_axis"].size == m
    assert rec["mem"]["argument_gb"] < one["mem"]["argument_gb"]
    assert sum(rec["roofline"]["coll_counts"].values()) > 0
    if shape == "decode_32k":
        assert built["args"][1]["xk"].shape[3] == (20 // m if m < 8 else 20)


@pytest.mark.parametrize("arch,family", [
    ("whisper-large-v3", "audio"), ("resnet9-cifar10", "vision"),
    ("lanegcn-argoverse", "trajectory")])
def test_family_builds_on_a_mesh_of_two(arch, family):
    """Each family that had no model axis builds on a (1, 2) mesh: the
    mesh is made, the train step is built on the rank's blocks (its
    parameters fewer than the whole model's), and an unknown family is
    still refused."""
    cfg = t_get_config(arch)
    assert cfg.family == family and family in TM.MODEL_AXIS_FAMILIES
    TM.require_model_axis(family, 2)
    built = TS.build_step(cfg, INPUT_SHAPES["train_4k"], plan_mesh(2, 2))
    pl = built["system"]["placement"]
    assert pl.model_axis.size == 2
    assert pl.layout.size < built["model"].num_params()
    with pytest.raises(ValueError, match="unknown family"):
        TM.require_model_axis("speech", 2)

"""The codecs of ``compression/`` in the distributed round on a (data,
model) mesh, over ``torch.distributed`` (gloo on the CPU), against one
process and against the JAX reference.

Gloo ranks are spawned once for the module on file stores, as
``tests/test_torch_model_axis_more.py`` spawns its ranks: a (1, 2) mesh,
a (2, 2) mesh and, for ResNet-9, a (1, 4) mesh, all at the same time,
each process with its own timeout.  Each rank runs, in float32 with the
reference's weights carried across (``load_params``, then the rank's
blocks):

* ResNet-9 at width 4 (``fc``'s bias whole, owned by model index 0);
* LaneGCN at ``tests/test_torch_lanegcn.py``'s width (d_model 32, d_ff
  64);
* reduced InternLM2 (the vocabulary cut over ``model``, GQA);
* reduced Mamba2 (the whole ``copy_to`` leaves owned by model index 0),

every codec policy (``mads-joint``, global and with
``per_layer_budget``, ``mads-topk``, ``qsgd``, ``fixed-kb``) in sampled
mode with a sample of 4,096 (well under every model's s, so that the
strided sample is a real subsample), and exact mode (the owned
magnitudes, gathered) on ResNet-9 and LaneGCN.  Held:

* given the same x, budget bits and dither seeds, every codec's payload
  and error on each rank's blocks equal world 1's on those coordinates,
  bit for bit, and its k, bits, b and step equal (the quantising
  ``mads-topk`` at u = 8 and the raw ``fixed-kb`` at b = 32 too); the
  per-layer codec with world 1's leaf energies fed in (an all-reduced sum
  of blocks adds in another order), the unfed energies within rtol 1e-5;
* ``sparsify_quantize_ef_blocks_plain`` on each rank's blocks under its
  counter map: the upload, error and (owned, summed over the ranks)
  counts of the whole row's plain call, bit for bit;
* two rounds (N = 2) of each policy against world 1, under
  ``tests/test_torch_model_axis.py``'s standard (uploads equal, k within
  2, w within 1e-6 of its largest entry at 97 % of the coordinates and
  within 1e-4 everywhere), bits within each round's contact budget, and
  every rank of a data index with the same k, bits and b;
* ResNet-9's rounds against the reference's ``make_afl_train_step``
  (global view, one device) given the reference's dither seeds;
* ``dp_client`` with ``mads-joint`` against world 1;
* ``ModelAxis.counts`` of every codec round equal to
  ``launch/roofline.py::step_collectives(codec=)``.
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

from repro.compression.quant import seed_from_key  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.core import sparsify as SP  # noqa: E402
from repro_torch.core.distributed import placement  # noqa: E402
from repro_torch.kernels import ref as KR  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402
from repro_torch.models.registry import local_params  # noqa: E402
from repro_torch.utils.tree import tree_unflatten  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300  # seconds a spawned process may take
# name: (arch, reduced, config changes made alike on both sides)
ARCHS = {"resnet9": ("resnet9-cifar10", False, {"d_model": 4}),
         "lanegcn": ("lanegcn-argoverse", False, {"d_model": 32, "d_ff": 64}),
         "internlm2": ("internlm2-1.8b", True, {}),
         "mamba2": ("mamba2-2.7b", True, {})}
MESHES = {"1x2": (2, 2), "2x2": (4, 2), "1x4": (4, 4)}  # (world, model)
ON = {"1x2": list(ARCHS), "2x2": list(ARCHS), "1x4": ["resnet9"]}
F32 = dict(dtype="float32", param_dtype="float32")
N, B, S, LR, SAMPLE = 2, 4, 16, 0.01, 4096  # clients, batch, seq, eta
ROUNDS = ((1.0, 0.0), (1.0, 1.0))  # zeta of the two rounds
# each client's contact bits a parameter at p_max (qsgd sends from 2),
# the channel gain and the energy budget
BPP, H2, BUDGET = (1.0, 2.5), 1e-9, 100.0
POLICIES = ("mads-joint", "mads-joint-pl", "mads-topk", "qsgd", "fixed-kb")
EXACT = ("resnet9", "lanegcn")  # the archs whose codecs also run exact
# the archs whose world-1 rounds also run in f64 (LaneGCN's inputs are
# taken in f32, as the reference's): their rounds are held to the f64
# floor of ``_hold_rounds``, as the measured f32 noise needs.  Without it
# reduced InternLM2's k lands 3-21 coordinates of 17,688-111,181 from
# world 1's on both meshes (``mads-joint``, ``mads-topk``, ``fixed-kb``),
# its per-layer w 1.69e-2 of its largest entry off (k within 2: one
# dither code that flips moves a coordinate by a whole step), and
# ResNet-9's ``mads-joint`` k 3 from the reference's (872 against 869)
F64 = ("resnet9", "internlm2", "mamba2")
DP = ("resnet9", "lanegcn", "internlm2")  # dp_client's archs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# what every rank runs, and this process for world 1
SETUP = textwrap.dedent(r"""
import torch
from repro_torch.compression.joint import JointCompressor
from repro_torch.compression.perlayer import (placed_energies,
                                              compress_per_layer,
                                              leaf_energies)
from repro_torch.compression.qsgd import QSGDCompressor
from repro_torch.compression.topk import FixedKbCompressor, TopKCompressor
from repro_torch.configs import FLConfig, get_config
from repro_torch.core import baselines as BL
from repro_torch.core import distributed as D
from repro_torch.models.registry import build_model, load_params, local_params
from repro_torch.utils.tree import tree_unflatten

F32 = dict(dtype="float32", param_dtype="float32")
N, B, S, LR, SAMPLE = %d, %d, %d, %r, %d
ROUNDS, BPP, H2, BUDGET = %r, %r, %r, %r
ARCHS, POLICIES = %r, %r
# the same-x codecs: name -> (class, fields)
VARIANTS = {"mads-joint": (JointCompressor, {}),
            "mads-topk": (TopKCompressor, {"u": 32}),
            "mads-topk-u8": (TopKCompressor, {"u": 8}),
            "qsgd": (QSGDCompressor, {}),
            "fixed-kb": (FixedKbCompressor, {"b": 8}),
            "fixed-kb-b32": (FixedKbCompressor, {"b": 32})}


def config(name):
    arch, reduced, kw = ARCHS[name]
    cfg = get_config(arch)
    return (cfg.reduced() if reduced else cfg).replace(**F32, **kw)


def setup(name, data):
    cfg = config(name)
    model = build_model(cfg)
    return cfg, model, load_params(model, data["params"])


def policy(name, s, method="sampled"):
    fl = FLConfig(num_devices=N, rounds=50, learning_rate=LR,
                  sparsifier=method, sample_size=SAMPLE,
                  per_layer_budget=name.endswith("-pl"))
    return BL.ALL[name.removesuffix("-pl")](s, fl)


def run_steps(model, cfg, data, params, mesh, name, rules=None, counts=None,
              dtype="float32"):
    pol = policy(name, model.num_params())
    dcfg = D.DistConfig(num_clients=N, learning_rate=LR, rounds=50,
                        state_dtype=dtype, upload_dtype=dtype,
                        accum_dtype=dtype, sample_size=SAMPLE)
    step = D.make_afl_train_step(model, cfg, dcfg, pol.controller,
                                 compressor=pol.compressor,
                                 staleness=pol.staleness, mesh=mesh,
                                 rules=rules)
    state = D.init_state(model, dcfg, mesh=mesh, device="cpu",
                         params=params, rules=rules)
    batch = {k: torch.as_tensor(v) for k, v in data["step_batch"].items()}
    ma = None if mesh is None else mesh.model_axis()
    hist = []
    for r, zeta in enumerate(ROUNDS):
        o = torch.ones(N)
        if ma is not None:
            ma.counts.clear()
        state, m = step(state, batch, torch.tensor(zeta), o * data["tau"],
                        o * H2, o * BUDGET, seeds=data["seeds"][r])
        if counts is not None and ma is not None:
            counts.append({k: v[0] for k, v in ma.counts.items()})
        hist.append({k: m[k].tolist()
                     for k in ("k", "bits", "b", "uploads", "power")})
    return state.w, hist


def blocks_of(model, pl, x):
    blocks = tree_unflatten(model.layout.paths, list(pl.blocks))
    return pl.layout.flatten(local_params(
        model, model.layout.unflatten(x), blocks, lead=1), lead=1)


def same_x(model, pl, data, methods):
    '''Each codec on the rank's blocks of one (x, error) against world 1's
    on the whole rows (computed here, with no collective).'''
    s = model.num_params()
    x, e = data["x"], data["e"]
    xb, eb = blocks_of(model, pl, x), blocks_of(model, pl, e)
    budget, seeds = data["budget"], data["seeds"][0]
    out = {}

    def hold(key, one, got):
        out[key] = dict(
            payload=bool(torch.equal(got[0], blocks_of(model, pl, one[0]))),
            error=bool(torch.equal(got[1], blocks_of(model, pl, one[1]))),
            stats={k: v.tolist() for k, v in got[2].items()},
            stats_one={k: v.tolist() for k, v in one[2].items()})

    for method in methods:
        for name, (cls, kw) in VARIANTS.items():
            comp = cls(s=s, method=method, sample=SAMPLE, **kw)
            hold((name, method),
                 comp.compress(x, budget, e, seeds, model.layout),
                 comp.compress(xb, budget, eb, seeds, pl.layout, pl))
        comp = JointCompressor(s=s, method=method, sample=SAMPLE,
                               per_layer=True)
        fed = leaf_energies(x + e, model.layout)
        hold(("mads-joint-pl", method),
             compress_per_layer(comp, x + e, model.layout, budget, seeds),
             compress_per_layer(comp, xb + eb, pl.layout, budget, seeds, pl,
                                energies=fed))
    out["energies"] = placed_energies(xb + eb, pl)
    return out
""" % (N, B, S, LR, SAMPLE, ROUNDS, BPP, H2, BUDGET, ARCHS, POLICIES))

RANK_SCRIPT = SETUP + textwrap.dedent(r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.launch.steps import RULES_TRAIN_DP

torch.set_num_threads(1)
rank, world, m, tmp, tag = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4], sys.argv[5])
names = sys.argv[6].split(",")
exact = sys.argv[7].split(",")
dp = sys.argv[8].split(",")
mesh = make_client_mesh(N, device="cpu", model=m, family="vision",
                        store=dist.FileStore(f"{tmp}/{tag}_store", world),
                        rank=rank, world_size=world)
for name in names:
    data = torch.load(f"{tmp}/{name}.pt", weights_only=False)
    cfg, model, params = setup(name, data)
    pl = D.placement(model, mesh)
    with torch.no_grad():
        res = {"same_x": same_x(model, pl, data, ["sampled"] + (
            ["exact"] if name in exact else []))}
    res["rounds"], res["counts"] = {}, {}
    for pol in POLICIES:
        res["counts"][pol] = []
        res["rounds"][pol] = run_steps(model, cfg, data, params, mesh, pol,
                                       counts=res["counts"][pol])
    if name in dp:
        res["dp"] = run_steps(model, cfg, data, params, mesh, "mads-joint",
                              RULES_TRAIN_DP)
    torch.save(res, f"{tmp}/{tag}_{name}_{rank}.pt")
mesh.close()
print("RESULT " + json.dumps({"coords": mesh.coords}))
""")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _ref_seeds(ckey):
    """The (N,) dither seeds the reference's ``compress_uploads`` draws
    from ``ckey``, and the advanced carry."""
    ckey, sub = jax.random.split(ckey)
    seeds = np.array([int(seed_from_key(k)) for k in jax.random.split(sub, N)],
                     np.int32)
    return torch.as_tensor(seeds), ckey


def _ref_cfg(name):
    arch, reduced, kw = ARCHS[name]
    cfg = get_config(arch)
    return (cfg.reduced() if reduced else cfg).replace(**F32, **kw)


# the reference's jitted step (one device, global view) over ResNet-9's
# rounds of every policy, given its own seeds, in a process of its own
# (its compiles take longer than the ranks' work)
REF_SCRIPT = textwrap.dedent(r"""
import sys
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import FLConfig, get_config
from repro.core import baselines as BL
from repro.core import distributed as RD
from repro.models.registry import build_model

N, LR, SAMPLE, ROUNDS, H2, BUDGET = %d, %r, %d, %r, %r, %r
ARCHS, POLICIES = %r, %r
tmp, name = sys.argv[1], sys.argv[2]
data = torch.load(f"{tmp}/{name}.pt", weights_only=False)
arch, reduced, kw = ARCHS[name]
cfg = get_config(arch)
cfg = (cfg.reduced() if reduced else cfg).replace(
    dtype="float32", param_dtype="float32", **kw)
model = build_model(cfg)
rd = RD.DistConfig(num_clients=N, learning_rate=LR, rounds=50,
                   state_dtype="float32", sample_size=SAMPLE)
state0 = jax.jit(lambda k: RD.init_state(model, rd, k))(jax.random.key(0))
params = data["params"]
state0 = state0._replace(
    w=jax.tree.map(jnp.asarray, params),
    w_n=jax.tree.map(lambda l: jnp.broadcast_to(
        jnp.asarray(l)[None], (N,) + l.shape), params))
batch = {k: jnp.asarray(v) for k, v in data["step_batch"].items()}
o = np.ones(N, np.float32)
out = {}
for pol_name in POLICIES:
    fl = FLConfig(num_devices=N, rounds=50, learning_rate=LR,
                  sparsifier="sampled", sample_size=SAMPLE,
                  per_layer_budget=pol_name.endswith("-pl"))
    pol = BL.ALL[pol_name.removesuffix("-pl")](model.num_params(), fl)
    step = jax.jit(RD.make_afl_train_step(model, cfg, rd, pol.controller,
                                          compressor=pol.compressor))
    state, hist = state0, []
    for zeta in ROUNDS:
        state, m = step(state, batch, jnp.asarray(zeta, jnp.float32),
                        jnp.asarray(data["tau"].numpy()), jnp.asarray(o * H2),
                        jnp.asarray(o * BUDGET))
        hist.append({k: np.asarray(m[k]).tolist()
                     for k in ("k", "bits", "b", "uploads", "power")})
    out[pol_name] = (torch.cat([torch.as_tensor(np.array(l, np.float32))
                                .reshape(-1) for l in jax.tree.leaves(state.w)]),
                     hist)
torch.save(out, f"{tmp}/reference.pt")
""" % (N, LR, SAMPLE, ROUNDS, H2, BUDGET, ARCHS, POLICIES))


def _f64(ns, name, data):
    """World 1's rounds of every policy in f64, from the same weights: the
    f32 rounds' distance from them is the floor that another summation
    order cannot be held under (``F64``'s archs)."""
    cfg = ns["config"](name).replace(dtype=torch.float64,
                                     param_dtype=torch.float64)
    model = ns["build_model"](cfg)
    params = ns["load_params"](model, data["params"])
    out = {}
    for pol in POLICIES:
        w, hist = ns["run_steps"](model, cfg, data, params, None, pol,
                                  dtype=torch.float64)
        out[pol] = (w.float(), hist)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's weights and inputs written once, every mesh's ranks
    and the reference's ResNet-9 rounds spawned at the same time, and
    while they run, this process's world-1 rounds (f32, and f64 for
    ``F64``); the ranks' results by (mesh, arch, rank)."""
    ns = {}
    exec(SETUP, ns)
    tmp = tmp_path_factory.mktemp("codec_axis")
    ref = {}
    for i, name in enumerate(ARCHS):
        cfg = _ref_cfg(name)
        model = build_model(cfg)
        params = jax.tree.map(np.asarray,
                              jax.jit(model.init)(jax.random.key(0)))
        rng = np.random.default_rng(50 + i)
        s = model.num_params()
        # the reference's init_state's ckey
        ckey = jax.random.fold_in(jax.random.key(0), 0x5EED)
        seeds = []
        for _ in ROUNDS:
            sd, ckey = _ref_seeds(ckey)
            seeds.append(sd)
        gen = torch.Generator().manual_seed(70 + i)
        data = {"params": params, "seeds": seeds,
                "step_batch": demo_batch(cfg, B, S, rng),
                "tau": torch.tensor(BPP) * s / 15.6e6,
                "x": torch.randn(N, s, generator=gen),
                "e": 0.25 * torch.randn(N, s, generator=gen),
                "budget": torch.tensor([2.0 * s, 9.0 * s])}
        torch.save(data, tmp / f"{name}.pt")
        ref[name] = data
    procs = {(tag, r): subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(m),
         str(tmp), tag, ",".join(ON[tag]), ",".join(EXACT), ",".join(DP)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag, (world, m) in MESHES.items() for r in range(world)}
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp), "resnet9"], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"tmp": tmp, "ref": ref, "one": {}}
    try:
        for name in ARCHS:
            data = ref[name]
            cfg, model, params = ns["setup"](name, data)
            out["one"][name] = dict(cfg=cfg, model=model, rounds={
                pol: ns["run_steps"](model, cfg, data, params, None, pol)
                for pol in POLICIES},
                f64=_f64(ns, name, data) if name in F64 else None)
        for key, p in procs.items():
            text, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (key, err[-3000:])
            if key != "reference":
                line = [l for l in text.splitlines()
                        if l.startswith("RESULT ")][-1]
                out[key] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    out["reference"] = torch.load(tmp / "reference.pt", weights_only=False)
    return out


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


CASES = [(tag, name) for tag in MESHES for name in ON[tag]]
ROUND_CASES = [(tag, name, pol) for tag, name in CASES for pol in POLICIES]
DP_CASES = [(t, a) for t, a in CASES if a in DP]


def _ids(cases):
    return ["-".join(c) for c in cases]


def _hold_rounds(w_block, hist, w_want_block, hist_want, name, f64=None,
                 w64_block=None):
    """``tests/test_torch_model_axis_more.py``'s standard for the rounds:
    uploads equal; k within 2 of the wanted rounds', or no further from
    the f64 rounds ``f64`` (a history) than 3x the wanted rounds are, plus
    2; w within 1e-6 of its largest entry at 97 % of the coordinates, and
    within 1e-4 everywhere or no further from the f64 w than 3x the
    wanted w is."""
    for r, (got, want) in enumerate(zip(hist, hist_want)):
        assert got["uploads"] == want["uploads"], name
        d = np.abs(np.subtract(got["k"], want["k"]))
        if f64 is not None:
            kf = f64[r]["k"]
            floor = 3 * np.abs(np.subtract(want["k"], kf)) + 2
            d = np.where(np.abs(np.subtract(got["k"], kf)) <= floor, 0, d)
        assert np.all(d <= 2), (name, got["k"], want["k"], f64)
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


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_same_x_payload_and_error_bit_equal(spawned, tag, name):
    """Given the same x, error, budget bits and seeds, every codec (and
    method) on each rank's blocks: payload and error world 1's on those
    coordinates, bit for bit; k, bits, b and step equal; the per-layer
    codec with world 1's energies fed in."""
    for r in _ranks(tag):
        got = _load(spawned, tag, name, r)["same_x"]
        keys = [k for k in got if k != "energies"]
        assert len(keys) == 7 * (2 if name in EXACT else 1), keys
        for key in keys:
            o = got[key]
            assert o["payload"] and o["error"], (tag, name, r, key)
            assert o["stats"] == o["stats_one"], (tag, name, r, key, o)
            assert sum(o["stats"]["k"]) > 0, (tag, name, r, key)


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_unfed_leaf_energies_within_rtol(spawned, tag, name):
    """The per-layer codec's leaf energies from the rank's owned blocks,
    all-reduced over ``model``: world 1's within rtol 1e-5 (another float
    order of the same squares)."""
    from repro_torch.compression.perlayer import leaf_energies

    data = spawned["ref"][name]
    model = spawned["one"][name]["model"]
    want = leaf_energies(data["x"] + data["e"], model.layout)
    for r in _ranks(tag):
        got = _load(spawned, tag, name, r)["same_x"]["energies"]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_plain_kernel_block_draws_bit_equal(spawned, tag, name):
    """``sparsify_quantize_ef_blocks_plain`` on each rank's blocks under
    its counter map against the whole row's segmented plain call, sliced
    to the blocks: upload and error bit-equal (the dither of each
    element's whole-model coordinate), and the owned counts, summed over
    the model indices, the whole row's."""
    model = spawned["one"][name]["model"]
    data = spawned["ref"][name]
    x = data["x"]
    layout = model.layout
    leaves = len(layout.sizes)
    gen = torch.Generator().manual_seed(3)
    t = 0.5 * torch.rand(N, leaves, generator=gen)
    steps = 0.01 + 0.05 * torch.rand(N, leaves, generator=gen)
    levels = torch.full((N, leaves), 7.0)
    seeds = data["seeds"][0]
    up, err, cnt = KR.sparsify_quantize_ef_segmented_plain(
        x, t, steps, levels, seeds, layout.offsets + (layout.size,))
    world, m = MESHES[tag]
    total = torch.zeros(N, leaves, dtype=torch.int64)
    for r in range(m):  # one data index: its model indices
        pl = placement(model, _mesh(tag, r))
        lay = pl.layout
        xb = _want_block(model, x[0], tag, r)[None].expand(N, -1).clone()
        xb[1] = _want_block(model, x[1], tag, r)
        bu, be, bc = KR.sparsify_quantize_ef_blocks_plain(
            xb, t, steps, levels, seeds, lay.offsets + (lay.size,),
            pl.counters)
        for i in range(N):
            assert torch.equal(bu[i], _want_block(model, up[i], tag, r))
            assert torch.equal(be[i], _want_block(model, err[i], tag, r))
        total += bc
    assert torch.equal(total.to(torch.float32), cnt)


@pytest.mark.parametrize("tag,name,pol", ROUND_CASES, ids=_ids(ROUND_CASES))
def test_rounds_match_world_one(spawned, tag, name, pol):
    """Two rounds of each policy against world 1; bits within each round's
    contact budget tau * A(p); every rank of a data index (and, gathered,
    every rank) with the same k, bits and b."""
    from repro_torch.core import mads as TMads

    o = spawned["one"][name]
    data = spawned["ref"][name]
    ctl = TMads.MadsController(s=o["model"].num_params())
    w1, hist1 = o["rounds"][pol]
    w64, hist64 = o["f64"][pol] if o["f64"] else (None, None)
    first = None
    for r in _ranks(tag):
        w, hist = _load(spawned, tag, name, r)["rounds"][pol]
        _hold_rounds(w, hist, _want_block(o["model"], w1, tag, r), hist1,
                     f"{tag} {name} {pol} rank {r}", hist64,
                     None if w64 is None
                     else _want_block(o["model"], w64, tag, r))
        for h in hist:
            cap = data["tau"] * TMads.rate_bps(
                torch.tensor(h["power"], dtype=torch.float64), H2,
                ctl.bandwidth, ctl.noise_w_hz)
            assert bool(torch.all(torch.tensor(h["bits"], dtype=torch.float64)
                                  <= cap * (1 + 1e-5) + 1e-3)), (h, cap)
        stats = [{k: h[k] for k in ("k", "bits", "b")} for h in hist]
        assert first is None or stats == first, (tag, name, pol, r)
        first = stats


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("pol", POLICIES)
def test_resnet9_rounds_match_reference_step(spawned, tag, pol):
    """ResNet-9's codec rounds on the mesh against the reference's jitted
    step on one device (global view), given its own dither seeds."""
    w, hist = spawned["reference"][pol]
    o = spawned["one"]["resnet9"]
    w64, hist64 = o["f64"][pol]
    tmodel = o["model"]
    for r in _ranks(tag):
        got_w, got = _load(spawned, tag, "resnet9", r)["rounds"][pol]
        _hold_rounds(got_w, got, _want_block(tmodel, w, tag, r), hist,
                     f"{tag} {pol} reference rank {r}", hist64,
                     _want_block(tmodel, w64, tag, r))


@pytest.mark.parametrize("tag,name", DP_CASES, ids=_ids(DP_CASES))
def test_dp_client_joint_matches_default(spawned, tag, name):
    """``dp_client`` (whole parameters on every rank: the codec runs on
    whole rows with no ``model`` collective) with ``mads-joint`` against
    world 1's rounds."""
    o = spawned["one"][name]
    w1, hist1 = o["rounds"]["mads-joint"]
    for r in _ranks(tag):
        w, hist = _load(spawned, tag, name, r)["dp"]
        assert w.numel() == o["model"].num_params()
        _hold_rounds(w, hist, w1, hist1, f"{tag} {name} dp rank {r}")


@pytest.mark.parametrize("tag,name", CASES, ids=_ids(CASES))
def test_axis_counts_equal_the_plan(spawned, tag, name):
    """Each codec round's collectives over ``model`` (``ModelAxis.counts``)
    equal to ``step_collectives(codec=)``'s count on a mesh of data 1: the
    model's, the norms', and the codec's threshold gather, amax and
    count (per-layer: its energies too)."""
    ns = {}
    exec(SETUP, ns)
    world, m = MESHES[tag]
    cfg = spawned["one"][name]["cfg"]
    seqs = B // (world // m)
    tokens = seqs * (1 if cfg.family in ("vision", "trajectory") else S)
    model = spawned["one"][name]["model"]
    s = model.num_params()
    for pol in POLICIES:
        want = TRL.step_collectives(
            "train", 0, m, N // (world // m), model=m, cfg=cfg,
            tokens=tokens, seqs=seqs, codec=ns["policy"](pol, s).compressor,
            leaves=len(model.layout.sizes)).count_by_kind
        for r in _ranks(tag):
            for got in _load(spawned, tag, name, r)["counts"][pol]:
                assert got == want, (tag, name, pol, r, got, want)


def test_counter_map_of_a_cut_leaf():
    """``block_counters``: a leaf cut on one dim maps its block's local
    columns to their whole-leaf coordinates; a whole leaf is its offset
    and size; a block cut on two dims is refused."""
    from repro_torch.utils.tree import TreeLayout

    full = TreeLayout((("a",), ("b",)), ((3, 4, 5), (6,)))
    blocks = [(slice(0, 3), slice(1, 3), slice(0, 5)), (slice(0, 6),)]
    (g0, run, stride, own), whole = SP.block_counters(full, blocks,
                                                      [True, False])
    assert (g0, run, stride, own) == (5, 10, 20, True)
    assert whole == (60, 6, 6, False)
    c = torch.arange(3 * 2 * 5)
    idx = torch.arange(60).reshape(3, 4, 5)[:, 1:3].reshape(-1)
    assert torch.equal(g0 + (c // run) * stride + c % run, idx)
    with pytest.raises(ValueError, match="counter map"):
        SP.block_counters(full, [(slice(0, 3), slice(1, 3), slice(0, 2)),
                                 (slice(0, 6),)], [True, True])


def test_codec_builds_on_every_model_axis_family():
    """``make_afl_train_step`` takes every codec on a (2, 2) mesh for every
    family with a model axis (reduced configs, the meta device), on both
    model indices, and each rank's counter map is built (at most one dim
    of a leaf cut)."""
    from repro_torch.compression.joint import JointCompressor
    from repro_torch.compression.qsgd import QSGDCompressor
    from repro_torch.compression.topk import FixedKbCompressor, TopKCompressor
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core import distributed as TD
    from repro_torch.core.mads import MadsController
    from repro_torch.models.registry import build_model as t_build_model

    fams = {}
    for arch in ("internlm2-1.8b", "qwen2-vl-72b", "qwen3-moe-30b-a3b",
                 "mamba2-2.7b", "zamba2-7b", "whisper-large-v3",
                 "resnet9-cifar10", "lanegcn-argoverse"):
        cfg = t_get_config(arch)
        cfg = cfg if cfg.family in ("vision", "trajectory") else cfg.reduced()
        fams[cfg.family] = cfg
    assert set(fams) == set(TM.MODEL_AXIS_FAMILIES)
    for cfg in fams.values():
        model = t_build_model(cfg)
        s = model.num_params()
        for rank in (0, 1):  # model indices 0 and 1 of data index 0
            mesh = _mesh("2x2", rank)
            pl = TD.placement(model, mesh)
            assert len(pl.counters) == len(model.layout.sizes)
            for comp in (JointCompressor(s=s),
                         JointCompressor(s=s, per_layer=True),
                         TopKCompressor(s=s), TopKCompressor(s=s, u=8),
                         QSGDCompressor(s=s), FixedKbCompressor(s=s),
                         FixedKbCompressor(s=s, b=32)):
                TD.make_afl_train_step(
                    model, cfg, TD.DistConfig(num_clients=2),
                    MadsController(s=s), compressor=comp, mesh=mesh)
    assert not hasattr(TM, "CODEC_AXIS_ITEM")

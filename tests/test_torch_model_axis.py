"""The ``model`` axis over ``torch.distributed`` (gloo on the CPU): the
dense and VLM families tensor-parallel on (data, model) meshes against
one process and against the JAX reference.

Gloo ranks are spawned once for the module on file stores, as
``tests/test_torch_mesh.py`` spawns its ranks: a (1, 2) mesh, a (1, 4)
mesh and a (2, 2) mesh, all at the same time, each process with its own
timeout.  Each rank runs reduced Llama-3.2-3B (tied embeddings),
Qwen3-32B (qk-norm: its norms are gathered) and Qwen2-VL-72B (qkv bias,
M-RoPE, vision embeddings) in float32 with the reference's weights
carried across (``load_params``, then the rank's blocks), and saves what
it computed; this process holds it:

* forward logits (every vocabulary block gathered) and ``loss_fn``
  against the reference's, at ``tests/test_torch_families.py``'s f32
  tolerance (rtol 1e-4, atol 1e-4 x max(1, the largest entry));
* at (1, 4) the reduced configs' 2 kv heads do not divide over the axis:
  the rules put ``wk`` / ``wv`` and the serve cache on ``head_dim``; each
  rank gathers the leaves and keeps the one kv head its q head reads,
  and its serve cache holds both kv heads over its block of the slots
  (``sharding/rules.py::model_slots``);
* prefill then 3 greedy decode steps against the unsharded port: logits
  at the same tolerance, each rank's KV cache equal to the unsharded
  cache's part (``local_cache``: at (1, 2) the kv head of its q heads, at
  (1, 4) its block of the slots);
* the distributed step at f32 (N = 2, two rounds) against the port's
  world-1 step: the sampled threshold bit-equal given the same x; bits =
  ``bits_for_k(k)``; the rank's block of w within 1e-6 of its largest
  entry at 97 % of the coordinates or more and within 1e-4 everywhere
  (the standard ``tests/test_torch_distributed.py`` holds the step to);
  k within 2, or, where the f32 world-1 round is itself more than that
  from the same round in f64, no further from the f64 round than 3x the
  world-1 round is, plus 2 (the tensor-parallel sums add in another
  order, and the reduced Llama's and Qwen2-VL's f32 gradients are only
  ~1e-4 from f64: measured, world 1's k is 16-255 from f64's at ~600k
  of 1.44M coordinates, Qwen3's within 2; so too w's largest distance,
  1e-4 or 3x world 1's from f64, which for the reduced Llama is 1.5e-4
  of its largest entry); Qwen3-32B also against the
  reference's ``make_afl_train_step`` within the same bounds;
* ``dp_client`` (``RULES_TRAIN_DP``: whole parameters, each client's
  batch split over ``model``, one gradient all-reduce) against
  ``default``, within the same bounds.

The refusals run in this process: clients that do not split over data,
an unknown family; a codec on a model axis and a serve step over the
(2, 2) mesh build (the latter on the rank's block of the batch and
cache); and the families whose model axis came later build on a (1, 2)
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
from repro_torch.compression.topk import TopKCompressor  # noqa: E402
from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import sparsify as SP  # noqa: E402
from repro_torch.core.mads import MadsController as TMadsController  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import local_params  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_unflatten  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300  # seconds a spawned process may take
ARCHS = ("llama3.2-3b", "qwen3-32b", "qwen2-vl-72b")
MESHES = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}  # (world, model)
F32 = dict(dtype="float32", param_dtype="float32")
N, B, S, GEN = 2, 4, 16, 3  # clients, global batch, seq, decode steps
LR, SAMPLE = 0.01, 65536
ROUNDS = ((1.0, 0.0), (1.0, 1.0))  # zeta of the two rounds
TAU, H2, BUDGET = 2.0, 1e-9, 100.0


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
from repro_torch.core.mads import MadsController
from repro_torch.launch.steps import RULES_TRAIN_DP
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model, load_params, local_params
from repro_torch.sharding import rules as R

F32 = dict(dtype="float32", param_dtype="float32")
N, B, S, GEN, LR, SAMPLE = %d, %d, %d, %d, %r, %d
ROUNDS, TAU, H2, BUDGET = %r, %r, %r, %r


def setup(arch, data):
    cfg = get_config(arch).reduced().replace(**F32)
    model = build_model(cfg)
    return cfg, model, load_params(model, data["params"])


def run_steps(model, cfg, data, params, mesh, rules=None,
              dtype="float32"):
    dcfg = D.DistConfig(num_clients=N, learning_rate=LR, rounds=50,
                        state_dtype=dtype, upload_dtype=dtype,
                        accum_dtype=dtype, sample_size=SAMPLE)
    ctl = MadsController(s=model.num_params())
    step = D.make_afl_train_step(model, cfg, dcfg, ctl, mesh=mesh,
                                 rules=rules)
    state = D.init_state(model, dcfg, mesh=mesh, device="cpu",
                         params=params, rules=rules)
    batch = {k: torch.as_tensor(v) for k, v in data["step_batch"].items()}
    hist = []
    for zeta in ROUNDS:
        z = torch.tensor(zeta)
        o = torch.ones(N)
        state, m = step(state, batch, z, o * TAU, o * H2, o * BUDGET)
        hist.append({k: m[k].tolist() for k in ("k", "bits", "uploads")})
    return state.w, hist


def serve(model, cfg, params, tokens, ma):
    kw = {} if ma is None else {"model_axis": ma}
    logits, cache = model.prefill(params, cfg, tokens, max_seq=S + GEN, **kw)
    out = [logits]
    for i in range(GEN):
        tok = out[-1].argmax(-1)
        logits, cache = model.decode_step(params, cfg, cache, tok, S + i, **kw)
        out.append(logits)
    return torch.stack(out), cache
""" % (N, B, S, GEN, LR, SAMPLE, ROUNDS, TAU, H2, BUDGET))

RANK_SCRIPT = SETUP + textwrap.dedent(r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch.mesh import make_client_mesh

torch.set_num_threads(1)
rank, world, m, tmp, tag = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4], sys.argv[5])
mesh = make_client_mesh(N, device="cpu", model=m, family="dense",
                        store=dist.FileStore(f"{tmp}/{tag}_store", world),
                        rank=rank, world_size=world)
ma = mesh.model_axis()
out = {"coords": mesh.coords, "rows": [mesh.rows(N).start, mesh.rows(N).stop]}
for arch in %r:
    data = torch.load(f"{tmp}/{arch}.pt", weights_only=False)
    cfg, model, params = setup(arch, data)
    blocks = model.blocks(R.RULES_TRAIN, mesh.axis_sizes, mesh.coords)
    lp = local_params(model, params, blocks)
    batch = {k: torch.as_tensor(v) for k, v in data["batch"].items()}
    res = {}
    with torch.no_grad():
        logits, _ = model.forward(lp, cfg, batch["tokens"],
                                  vision_embeds=batch.get("vision_embeds"),
                                  model_axis=ma) if cfg.family == "vlm" else \
            model.forward(lp, cfg, batch["tokens"], model_axis=ma)
        res["logits"] = L.gather_vocab(logits, cfg, ma)
        res["loss"] = model.loss_fn(lp, cfg, batch, model_axis=ma)
        res["serve"], cache = serve(model, cfg, lp, batch["tokens"], ma)
        res["cache_k"], res["cache_v"] = cache["k"], cache["v"]
        pl = D.placement(model, mesh)
        x = local_params(model, model.layout.unflatten(data["x"]),
                         blocks, lead=1)
        res["threshold"] = D.block_threshold(pl.layout.flatten(x, lead=1),
                                             model, pl, data["k"], SAMPLE)
    res["w"], res["hist"] = run_steps(model, cfg, data, params, mesh)
    res["w_dp"], res["hist_dp"] = run_steps(model, cfg, data, params, mesh,
                                            RULES_TRAIN_DP)
    torch.save(res, f"{tmp}/{tag}_{arch}_{rank}.pt")
mesh.close()
print("RESULT " + json.dumps(out))
""" % (ARCHS,))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _ref_pair(arch):
    cfg = get_config(arch).reduced().replace(**F32)
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(0)))
    return cfg, model, params


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's weights and inputs written once, then every mesh's
    ranks spawned at the same time; their results by (mesh, arch, rank)."""
    tmp = tmp_path_factory.mktemp("model_axis")
    ref = {}
    for i, arch in enumerate(ARCHS):
        cfg, model, params = _ref_pair(arch)
        rng = np.random.default_rng(10 + i)
        batch = demo_batch(cfg, 2, S, rng)
        step_batch = demo_batch(cfg, B, S, rng)
        tmodel = t_build_model(t_get_config(arch).reduced().replace(**F32))
        s = tmodel.num_params()
        gen = torch.Generator().manual_seed(i)
        data = {"params": params, "batch": batch, "step_batch": step_batch,
                "x": torch.randn(N, s, generator=gen),
                "k": torch.tensor([s / 400.0, s / 7.0])}
        torch.save(data, tmp / f"{arch}.pt")
        ref[arch] = (cfg, model, params, data)
    procs = {(tag, r): subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(m),
         str(tmp), tag], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
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


def _load(spawned, tag, arch, rank):
    return torch.load(spawned["tmp"] / f"{tag}_{arch}_{rank}.pt",
                      weights_only=False)


def _ranks(tag):
    return range(MESHES[tag][0])


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    atol = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def one(spawned):
    """This process's world-1 runs of the same work, by arch."""
    ns = {}
    exec(SETUP, ns)
    out = {}
    for arch in ARCHS:
        data = spawned["ref"][arch][3]
        cfg, model, params = ns["setup"](arch, data)
        tokens = torch.as_tensor(data["batch"]["tokens"])
        with torch.no_grad():
            served, cache = ns["serve"](model, cfg, params, tokens, None)
        w, hist = ns["run_steps"](model, cfg, data, params, None)
        # the same rounds in f64: the f32 rounds' distance from it is the
        # floor that another summation order cannot be held under
        f64 = cfg.replace(dtype=torch.float64, param_dtype=torch.float64)
        m64 = t_build_model(f64)
        p64 = {k: v for k, v in zip(*tree_flatten(params))}
        p64 = tree_unflatten(list(p64), [v.double() for v in p64.values()])
        w64, hist64 = ns["run_steps"](m64, f64, data, p64, None,
                                      dtype=torch.float64)
        thr = SP.tree_threshold(data["x"], model.layout, data["k"],
                                method="sampled", sample=SAMPLE)
        out[arch] = dict(cfg=cfg, model=model, served=served, cache=cache,
                         w=w, hist=hist, threshold=thr, w64=w64.float(),
                         hist64=hist64)
    return out


CASES = [(tag, arch) for tag in MESHES for arch in ARCHS]


def _ids(cases):
    return [f"{t}-{a}" for t, a in cases]


def test_mesh_coordinates_and_rows(spawned):
    """Rank r at (r // M, r % M); each data rank's clients."""
    for tag, (world, m) in MESHES.items():
        for r in range(world):
            got = spawned[(tag, r)]
            assert got["coords"] == {"data": r // m, "model": r % m}
            per = N // (world // m)
            assert got["rows"] == [(r // m) * per, (r // m + 1) * per]


@pytest.mark.parametrize("tag,arch", CASES, ids=_ids(CASES))
def test_forward_and_loss_match_reference(spawned, tag, arch):
    cfg, model, params, data = spawned["ref"][arch]
    batch = {k: jnp.asarray(v) for k, v in data["batch"].items()}
    if cfg.family == "vlm":
        want, _ = model.forward(params, cfg, batch["tokens"],
                                vision_embeds=batch["vision_embeds"])
    else:
        want, _ = model.forward(params, cfg, batch["tokens"])
    want_loss = float(model.loss_fn(params, cfg, batch))
    for r in _ranks(tag):
        res = _load(spawned, tag, arch, r)
        _close(res["logits"], want, 1e-4, f"{tag} {arch} rank {r} logits")
        assert abs(float(res["loss"]) - want_loss) <= 1e-4 * abs(want_loss), (
            tag, arch, r, float(res["loss"]), want_loss)


@pytest.mark.parametrize("tag,arch", CASES, ids=_ids(CASES))
def test_prefill_and_decode_match_unsharded(spawned, one, tag, arch):
    """Logits of the prefill and each decode step; each rank's cache is
    the unsharded cache's part: the kv heads of its q heads, or at (1, 4)
    both kv heads over its block of the slots."""
    from repro_torch.models.registry import local_cache
    from repro_torch.sharding.collectives import ModelAxis

    o = one[arch]
    m = MESHES[tag][1]
    for r in _ranks(tag):
        res = _load(spawned, tag, arch, r)
        _close(res["serve"], o["served"], 1e-4, f"{tag} {arch} rank {r}")
        want = local_cache(t_build_model(o["cfg"]), o["cache"],
                           ModelAxis(None, r % m, m))
        for key in ("k", "v"):
            assert res[f"cache_{key}"].shape == want[key].shape
            _close(res[f"cache_{key}"], want[key], 1e-4,
                   f"{tag} {arch} {key}")


def test_kv_heads_fall_back_at_four():
    """At M = 4 the reduced configs' 2 kv heads fall back to head_dim:
    the layers gather wk and wv (and Qwen3's norms), and each rank's
    attention reads the one kv head of its q head (its serve cache holds
    both over its block of the slots); at M = 2 they divide."""
    from repro_torch.sharding.collectives import ModelAxis

    for arch in ARCHS:
        cfg = t_get_config(arch).reduced()
        specs = t_build_model(cfg).param_pspecs(TR.RULES_TRAIN,
                                                {"data": 1, "model": 4})
        assert specs["layers"]["attn"]["wk"] == (None, None, None, "model")
        names = [n for n, _, _ in TL.gathered_leaves(cfg, 4)]
        assert {"wk", "wv"} <= set(names)
        assert ("q_norm" in names) == cfg.qk_norm
        assert set(names) <= {"wk", "wv", "bk", "bv", "q_norm", "k_norm"}
        for r in range(4):
            plan = TL.head_plan(cfg, ModelAxis(None, r, 4))
            assert plan.split and not plan.kv_block
            assert plan.kv == (r // 2,)
        two = TL.head_plan(cfg, ModelAxis(None, 1, 2))
        assert two.kv_block and two.kv == (1,)
        assert [n for n, _, _ in TL.gathered_leaves(cfg, 2)] == (
            ["k_norm", "q_norm"] if cfg.qk_norm else [])


@pytest.mark.parametrize("tag,arch", CASES, ids=_ids(CASES))
def test_threshold_bit_equal_given_the_same_x(spawned, one, tag, arch):
    for r in _ranks(tag):
        res = _load(spawned, tag, arch, r)
        assert torch.equal(res["threshold"], one[arch]["threshold"]), (tag, r)


def _hold_step(w_block, hist, w_want_block, hist_want, s, name,
               hist64=None, w64_block=None):
    """k within 2 of the wanted rounds' (with ``hist64``, the same rounds
    in f64: or no further from them than 3x the wanted f32 rounds are,
    plus 2); bits = bits_for_k(k); w to the standard above (with
    ``w64_block``: its largest distance, or no further from the f64 w
    than 3x the wanted f32 w is)."""
    for r, (got, want) in enumerate(zip(hist, hist_want)):
        assert got["uploads"] == want["uploads"], name
        d = np.abs(np.subtract(got["k"], want["k"]))
        if hist64 is not None:
            k64 = hist64[r]["k"]
            floor = 3 * np.abs(np.subtract(want["k"], k64)) + 2
            d = np.where(np.abs(np.subtract(got["k"], k64)) <= floor, 0, d)
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


def _want_block(model, w, tag, rank):
    m = MESHES[tag][1]
    blocks = model.blocks(TR.RULES_TRAIN, {"data": MESHES[tag][0] // m,
                                           "model": m},
                          {"data": rank // m, "model": rank % m})
    from repro_torch.core.distributed import placement

    mesh = TM.ClientMesh(group=None, rank=rank, world_size=MESHES[tag][0],
                         device=torch.device("cpu"), model=m)
    layout = placement(model, mesh).layout
    return layout.flatten(local_params(model, model.layout.unflatten(w),
                                       blocks))


@pytest.mark.parametrize("tag,arch", CASES, ids=_ids(CASES))
def test_step_matches_world_one(spawned, one, tag, arch):
    o = one[arch]
    s = o["model"].num_params()
    for r in _ranks(tag):
        res = _load(spawned, tag, arch, r)
        _hold_step(res["w"], res["hist"], _want_block(o["model"], o["w"], tag,
                                                      r), o["hist"], s,
                   f"{tag} {arch} rank {r}", o["hist64"],
                   _want_block(o["model"], o["w64"], tag, r))


@pytest.mark.parametrize("tag", list(MESHES))
def test_step_matches_reference_step(spawned, one, tag):
    """Qwen3-32B's rounds against the reference's jitted step."""
    arch = "qwen3-32b"
    cfg, model, params, data = spawned["ref"][arch]
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
    tmodel = one[arch]["model"]
    w = torch.cat([torch.as_tensor(np.array(l, np.float32)).reshape(-1)
                   for l in jax.tree.leaves(state.w)])
    for r in _ranks(tag):
        res = _load(spawned, tag, arch, r)
        _hold_step(res["w"], res["hist"], _want_block(tmodel, w, tag, r),
                   hist, tmodel.num_params(), f"{tag} reference rank {r}")


@pytest.mark.parametrize("tag,arch", CASES, ids=_ids(CASES))
def test_dp_client_matches_default(spawned, one, tag, arch):
    """``dp_client`` (whole parameters on every rank) against the
    default variant's blocks, and so against world 1."""
    o = one[arch]
    s = o["model"].num_params()
    for r in _ranks(tag):
        res = _load(spawned, tag, arch, r)
        assert res["w_dp"].numel() == s
        _hold_step(res["w_dp"], res["hist_dp"], o["w"], o["hist"], s,
                   f"{tag} {arch} dp rank {r}")


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,family", [
    ("whisper-large-v3", "audio"), ("resnet9-cifar10", "vision"),
    ("lanegcn-argoverse", "trajectory")])
def test_every_family_has_a_model_axis(arch, family):
    """The families that had no model axis build on a (1, 2) mesh (their
    train step on the rank's blocks); a mesh still needs the family, and
    an unknown one is refused."""
    cfg = t_get_config(arch)
    assert cfg.family == family
    TM.require_model_axis(family, 2)
    built = TS.build_step(cfg, INPUT_SHAPES["train_4k"],
                          TM.ClientMesh(group=None, rank=1, world_size=2,
                                        device=torch.device("meta"),
                                        model=2))
    assert built["system"]["placement"].layout.size \
        < built["model"].num_params()
    with pytest.raises(ValueError, match="family"):
        TM.make_client_mesh(2, device="cpu", model=2)
    with pytest.raises(ValueError, match="unknown family"):
        TM.require_model_axis("speech", 2)
    TM.require_model_axis("speech", 1)  # a model axis of 1 is any family's


def test_codec_builds_and_serve_data_and_uneven_clients_refused():
    cfg = t_get_config("qwen3-32b").reduced()
    tmodel = t_build_model(cfg)
    mesh = TM.ClientMesh(group=None, rank=0, world_size=4,
                         device=torch.device("cpu"), model=2)
    dcfg = TD.DistConfig(num_clients=2)
    comp = TopKCompressor(s=tmodel.num_params())
    # a codec on the (2, 2) mesh builds: it runs on the rank's blocks
    step = TD.make_afl_train_step(tmodel, cfg, dcfg, TMadsController(
        s=tmodel.num_params()), compressor=comp, mesh=mesh)
    assert callable(step)
    # a serve step over data 2 builds on the rank's block: its 64 of the
    # 128 rows, the kv head of its q heads, every slot
    built = TS.build_step(cfg, INPUT_SHAPES["decode_32k"], mesh)
    assert built["split"] == "batch" and built["data_axis"].size == 2
    _, cache, token, _ = built["args"]
    assert tuple(token.shape) == (64,)
    assert tuple(cache["k"].shape) == (cfg.num_layers, 64, 32768, 1,
                                       cfg.resolved_head_dim)
    assert tuple(cache["pos"].shape) == (64, 32768)
    with pytest.raises(ValueError, match="do not split evenly"):
        mesh.rows(3)
    # the audio family's train step builds on the (2, 2) mesh (it was
    # refused until its model axis was ported)
    audio = t_get_config("whisper-large-v3").reduced()
    built = TS.build_step(audio, INPUT_SHAPES["train_4k"], mesh)
    assert built["model_axis"].size == 2


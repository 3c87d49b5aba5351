"""The serve cache cut on its slots over ``model`` where the kv heads do
not divide (gloo on the CPU), against one process and the JAX reference.

Where ``RULES_SERVE`` cuts a decode cache's ``head_dim`` over ``model``
(its kv heads do not divide), the port's rank holds every kv head over
its block of the slots (``sharding/rules.py::model_slots``): the same
bytes a card, and each rank's q . k a whole dot product, so the decode
attends over the block through ``decode_attn``'s partials entry and the
ranks' (m, l, acc) are merged (``collectives.merge_partials``).

* The partials entry's plain version (``ref.decode_attn_partials_plain``,
  which the CPU runs) against the TPU kernel's own (m, l, acc): the
  reference's Pallas ``_kernel`` called through ``pl.pallas_call`` in
  interpret mode as ``src/repro/kernels/decode_attn.py:81-100`` calls it,
  f32, on blocks that are full, partial, uneven (1,500 slots over 8: seven
  of 188 and one of 184) and empty (a block past ``length``: m = -inf,
  l = 0 on both sides), at ``tests/test_kernels.py``'s f32 decode
  tolerance (2e-5); the blocks' ``collectives.combine`` against the
  reference's ``decode_attn_ref`` on the whole cache.
* Bytes a card at M = 8 of the three decode_32k pairs whose kv heads do
  not divide (Qwen2-7B, Qwen3-MoE-30B-A3B, Whisper-large-v3): the fullest
  rank's ``local_cache`` and the plan's cache argument equal the bytes
  that the reference's ``logical_to_pspec`` gives under ``RULES_SERVE``,
  within one slot's.
* A (1, 4) mesh spawned once for the module (as
  ``tests/test_torch_serve_data.py`` spawns its ranks), f32 on the
  reference's weights: the reduced Qwen2-7B (4 q heads over 4, 2 kv
  heads: q gathered for the decode attention), the same with 6 q heads
  (neither divides: every rank runs every head), and the first with the
  int8 cache and with a sliding window of 16 (a ring of 16 slots, 4 a
  rank, that the decodes wrap).  A prompt of 13 in a cache of 19 slots
  (blocks of 5, 5, 5 and 4: the last rank's block empty until position
  15), then 6 greedy decodes: each rank's logits within 1e-5 of one
  process's, its cache
  block equal to one process's slot block (positions exactly), the
  collectives it counts at each step equal to ``roofline.
  step_collectives``'s; one process against the reference's prefill and
  decode steps at ``tests/test_torch_serve.py``'s f32 tolerance (int8:
  codes within one step, as ``tests/test_torch_families.py`` holds them).
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
from jax.experimental import pallas as pl  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.kernels import decode_attn as RDA  # noqa: E402
from repro.kernels.ref import decode_attn_ref  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.sharding.rules import RULES_SERVE, logical_to_pspec  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models.registry import local_cache  # noqa: E402
from repro_torch.sharding import collectives as TCOL  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.sharding.collectives import ModelAxis  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300  # seconds a spawned process may take
M = 4  # the spawned mesh's model axis
F32 = dict(dtype="float32", param_dtype="float32")
B, P, GEN = 2, 13, 6  # batch, prompt, greedy decodes: 19 slots
CONFIGS = {"q4": {}, "q6": {"num_heads": 6},
           "q4-int8": {"kv_cache_dtype": "int8"},
           "q4-ring": {"sliding_window": 16}}
TOL = 1e-5  # a rank against one process
REF_TOL = 1e-4  # one process against the reference (tests/test_torch_serve.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The partials against the TPU kernel's own
# ---------------------------------------------------------------------------


@jax.jit
def _tpu_partials(q, k, v, length):
    """The reference kernel's (m, l, acc) in head order: its ``_kernel``
    through ``pl.pallas_call`` in interpret mode, as its jit wrapper calls
    it before dividing (``src/repro/kernels/decode_attn.py:81-100``)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qr = q.reshape(b, kv, g, d)
    blocks = (s + RDA.BLOCK_S - 1) // RDA.BLOCK_S
    pad = blocks * RDA.BLOCK_S - s
    if pad:
        k = jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    lv = jnp.minimum(jnp.asarray(length, jnp.int32), s).reshape(1)
    m, l, acc = pl.pallas_call(
        RDA._kernel,
        grid=(b, kv, blocks),
        in_specs=[
            pl.BlockSpec((1, 1, g, d), lambda bi, ki, si: (bi, ki, 0, 0)),
            pl.BlockSpec((1, RDA.BLOCK_S, 1, d),
                         lambda bi, ki, si: (bi, si, ki, 0)),
            pl.BlockSpec((1, RDA.BLOCK_S, 1, d),
                         lambda bi, ki, si: (bi, si, ki, 0)),
            pl.BlockSpec((1,), lambda bi, ki, si: (0,)),
        ],
        out_specs=[
            pl.BlockSpec((1, 1, g), lambda bi, ki, si: (bi, ki, 0)),
            pl.BlockSpec((1, 1, g), lambda bi, ki, si: (bi, ki, 0)),
            pl.BlockSpec((1, 1, g, d), lambda bi, ki, si: (bi, ki, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, kv, g), jnp.float32),
            jax.ShapeDtypeStruct((b, kv, g), jnp.float32),
            jax.ShapeDtypeStruct((b, kv, g, d), jnp.float32),
        ],
        interpret=True,
    )(qr, k, v, lv)
    return m.reshape(b, h), l.reshape(b, h), acc.reshape(b, h, d)


@pytest.mark.parametrize("length", [1500, 1100, 60], ids=lambda n: f"len{n}")
def test_partials_match_the_tpu_kernel(length):
    """The cache of 1,500 slots (Whisper's cross cache) in blocks of 188
    over 8 ranks: at length 1,500 every block full and the last one 184
    slots; at 1,100 five full, one partial (160 of 188) and two empty; at
    60 one partial and seven empty."""
    rng = np.random.default_rng(29 + length)
    b, h, kv, s, d, n = 2, 4, 2, 1500, 64, 8
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    per = -(-s // n)
    parts, empty = [], 0
    for r in range(n):
        lo, hi = min(r * per, s), min((r + 1) * per, s)
        local = min(max(length - lo, 0), hi - lo)
        kb, vb = k[:, lo:hi], v[:, lo:hi]
        want = [np.asarray(t) for t in _tpu_partials(
            jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), local)]
        got = TREF.decode_attn_partials_plain(
            torch.from_numpy(q), torch.from_numpy(kb), torch.from_numpy(vb),
            local)
        for name, g, w in zip("mla", got, want):
            assert np.isfinite(g.numpy()).sum() == np.isfinite(w).sum()
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5,
                                       err_msg=f"block {r} {name}")
        if local == 0:
            empty += 1
            assert np.all(np.isneginf(want[0])) and not np.any(want[1])
            assert np.all(np.isneginf(got[0].numpy())) and not got[1].any()
            assert not got[2].any()
        parts.append(got)
    assert empty == {1500: 0, 1100: 2, 60: 7}[length]
    m, l, o = TCOL.combine(*(torch.stack(t) for t in zip(*parts)))
    whole = decode_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            length)
    np.testing.assert_allclose((o / l[..., None]).numpy(), np.asarray(whole),
                               rtol=2e-5, atol=2e-5)


def test_combine_of_nothing_is_zero_without_nan():
    """Every part empty: m = -inf, l = o = 0, and the merge's output 0."""
    m = torch.full((3, 2, 4), -torch.inf)
    z = torch.zeros(3, 2, 4)
    top, l, o = TCOL.combine(m, z, torch.zeros(3, 2, 4, 8))
    assert torch.all(torch.isneginf(top)) and not l.any() and not o.any()
    assert not torch.isnan(TCOL.merge_softmax(top, l, o, None)).any()


# ---------------------------------------------------------------------------
# Bytes a card at M = 8
# ---------------------------------------------------------------------------

PAIRS = ("qwen2-7b", "qwen3-moe-30b-a3b", "whisper-large-v3")


def _ref_mesh(m):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, m)))


@pytest.mark.parametrize("arch", PAIRS)
def test_bytes_a_card_are_the_rules_at_eight(arch):
    """A rank's cache under the rules' ``head_dim`` cut and under the
    port's slot cut: rank 0's (the fullest) equal within one slot's bytes,
    and no rank's past them (Whisper's last rank holds 184 of the 1,500
    cross slots, the others 188); the plan's cache argument is
    ``local_cache``'s."""
    shape = TC.INPUT_SHAPES["decode_32k"]
    rcfg = get_config(arch)
    rbuilt = RS.build_step(rcfg, InputShape(shape.name, shape.seq_len,
                                            shape.global_batch, shape.kind),
                           Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                ("data", "model")))
    raxes = rbuilt["model"].cache_axes(rcfg)
    rules, slot = 0.0, 0.0
    for key, leaf in rbuilt["args"][1].items():
        if key == "length":
            continue
        spec = tuple(logical_to_pspec(tuple(raxes[key]), tuple(leaf.shape),
                                      RULES_SERVE, _ref_mesh(8)))
        nbytes = np.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        assert spec.count("model") <= 1
        rules += nbytes / (8 if "model" in spec else 1)
        dims = raxes[key]
        if "head_dim" in dims:
            assert spec[dims.index("head_dim")] == "model", (arch, key)
            seq = dims.index("seq") if "seq" in dims else dims.index("pos")
            slot += nbytes / leaf.shape[seq]
    cfg = TC.get_config(arch)
    model = TS.build_step(cfg, shape, None)["model"]
    whole = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
    got = [TS.arg_bytes(local_cache(model, whole, ModelAxis(None, r, 8)))
           for r in range(8)]
    assert abs(got[0] - rules) <= slot, (arch, got[0], rules, slot)
    assert max(got) == got[0], (arch, got)
    built = TS.build_step(cfg, shape, TDR.plan_mesh(8, 8))
    assert TS.arg_bytes(built["args"][1]) == TS.arg_bytes(
        local_cache(model, whole, ModelAxis(None, 0, 8)))
    assert TS.arg_bytes(built["args"][1]) < TS.arg_bytes(whole) / 7


# ---------------------------------------------------------------------------
# The (1, 4) mesh
# ---------------------------------------------------------------------------

# what every rank runs, and this process for one process's serve
SETUP = textwrap.dedent(r"""
import torch
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model, load_params, local_params
from repro_torch.sharding import rules as R

F32 = dict(dtype="float32", param_dtype="float32")
B, P, GEN = %d, %d, %d


def setup(over, data):
    cfg = get_config("qwen2-7b").reduced().replace(**F32, **over)
    model = build_model(cfg)
    return cfg, model, load_params(model, data["params"])


def serve(model, cfg, params, tokens, ma):
    kw = {} if ma is None else {"model_axis": ma}
    counts = []
    max_seq = cfg.sliding_window or P + GEN  # a ring: the window's slots

    def count():
        if ma is not None:
            counts.append({k: n for k, (n, _) in ma.counts.items()})
            ma.counts.clear()

    logits, cache = model.prefill(params, cfg, tokens, max_seq=max_seq,
                                  **kw)
    count()
    out = [logits]
    for i in range(GEN):
        logits, cache = model.decode_step(params, cfg, cache,
                                          out[-1].argmax(-1), P + i, **kw)
        count()
        out.append(logits)
    return torch.stack(out), cache, counts
""" % (B, P, GEN))

RANK_SCRIPT = SETUP + textwrap.dedent(r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch.mesh import make_client_mesh

torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh = make_client_mesh(1, device="cpu", model=world, family="dense",
                        store=dist.FileStore(f"{tmp}/store", world),
                        rank=rank, world_size=world)
ma = mesh.model_axis()
for name, over in %r.items():
    data = torch.load(f"{tmp}/{name}.pt", weights_only=False)
    cfg, model, params = setup(over, data)
    lp = local_params(model, params, model.blocks(
        R.RULES_SERVE, mesh.axis_sizes, mesh.coords))
    ma.counts.clear()
    with torch.no_grad():
        out, cache, counts = serve(model, cfg, lp,
                                   torch.as_tensor(data["tokens"]), ma)
    torch.save(dict(out=out, cache=cache, counts=counts),
               f"{tmp}/{name}_{rank}.pt")
mesh.close()
print("RESULT " + json.dumps(mesh.coords))
""" % (CONFIGS,))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's weights for each config, then the (1, 4) mesh's
    ranks; while they run, this process's one-process serves and the
    reference's steps (``_one``)."""
    tmp = tmp_path_factory.mktemp("slot_cut")
    ref = {}
    for i, (name, over) in enumerate(CONFIGS.items()):
        cfg = get_config("qwen2-7b").reduced().replace(**F32, **over)
        model = build_model(cfg)
        params = jax.tree.map(np.asarray, jax.jit(model.init)(
            jax.random.key(i)))
        tokens = np.random.default_rng(40 + i).integers(
            0, cfg.vocab_size, (B, P)).astype(np.int32)
        torch.save({"params": params, "tokens": tokens}, tmp / f"{name}.pt")
        ref[name] = (cfg, model, params, tokens)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(M), str(tmp)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(M)]
    out = {"tmp": tmp}
    try:
        out["one"] = _one(tmp, ref)
        for r, p in enumerate(procs):
            text, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (r, p.returncode, err[-6000:])
            line = [l for l in text.splitlines() if l.startswith("RESULT ")][-1]
            out[r] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


def _one(tmp, ref) -> dict:
    """This process's one-process serve of each config on the same
    weights and prompt, and the reference's steps on its greedy tokens."""
    ns = {}
    exec(SETUP, ns)
    out = {}
    for name in CONFIGS:
        cfg, model, params, tokens = ref[name]
        data = torch.load(tmp / f"{name}.pt", weights_only=False)
        tcfg, tmodel, tp = ns["setup"](CONFIGS[name], data)
        with torch.no_grad():
            served, cache, _ = ns["serve"](tmodel, tcfg, tp,
                                           torch.as_tensor(tokens), None)
        last, rcache = jax.jit(lambda p, t: model.prefill(
            p, cfg, t, max_seq=cfg.sliding_window or P + GEN))(params,
                                                               tokens)
        want = [np.asarray(last)]
        decode = jax.jit(lambda p, c, t, pos: model.decode_step(p, cfg, c, t,
                                                                pos))
        for i in range(GEN):
            tok = served[i].argmax(-1).numpy().astype(np.int32)
            lg, rcache = decode(params, rcache, tok, jnp.asarray(P + i,
                                                                 jnp.int32))
            want.append(np.asarray(lg))
        out[name] = dict(cfg=tcfg, model=tmodel, served=served, cache=cache,
                         ref_logits=np.stack(want),
                         ref_cache=jax.tree.map(np.asarray, rcache))
    return out


@pytest.fixture(scope="module")
def one(spawned):
    return spawned["one"]


def _load(spawned, name, rank):
    return torch.load(spawned["tmp"] / f"{name}_{rank}.pt", weights_only=False)


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    atol = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=name)


def test_mesh_coordinates(spawned):
    for r in range(M):
        assert spawned[r] == {"data": 0, "model": r}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rank_matches_one_process(spawned, one, name):
    """Each rank's prefill and decode logits within 1e-5 of one
    process's, its cache the one-process cache's slot block on every kv
    head (blocks of 5, 5, 5 and 4 of the 19; 4 of a ring's 16), the
    positions whole."""
    o = one[name]
    slots = o["cache"]["pos"].shape[1]
    for r in range(M):
        blk = TR.model_slots(slots, 2, 64, M, r)
        res = _load(spawned, name, r)
        assert torch.isfinite(res["out"]).all()
        _close(res["out"], o["served"], TOL, f"{name} rank {r} logits")
        want = local_cache(o["model"], o["cache"], ModelAxis(None, r, M))
        assert sorted(res["cache"]) == sorted(want)
        for key, w in want.items():
            g = res["cache"][key]
            if not isinstance(w, torch.Tensor):
                assert g == w, key
            elif key == "pos":
                assert torch.equal(g, o["cache"]["pos"]), (name, r)
            else:
                assert g.shape[2] == blk.stop - blk.start, (key, g.shape)
                assert g.shape[3] == 2 and torch.equal(w, o["cache"][key][
                    :, :, blk])
                if g.dtype == torch.int8:
                    # a code at a rounding boundary may round the other way
                    assert (g.int() - w.int()).abs().max() <= 1, (name, key)
                else:
                    _close(g, w, TOL, f"{name} rank {r} cache {key}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_process_matches_reference(one, name):
    """One process's prefill and decode logits and its cache against the
    reference's steps (int8: codes within one step, scales at the f32
    tolerance)."""
    o = one[name]
    _close(o["served"], o["ref_logits"], REF_TOL, f"{name} logits")
    for key, w in o["ref_cache"].items():
        g = o["cache"][key]
        if key == "length":
            assert g == int(w)
        elif key == "pos":
            np.testing.assert_array_equal(g.numpy(), w)
        elif g.dtype == torch.int8:
            diff = np.abs(g.numpy().astype(int) - w.astype(int))
            assert diff.max() <= 1 and diff.mean() < 1e-3, (key, diff.max())
        else:
            _close(g, w, REF_TOL, f"{name} cache {key}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counts_equal_the_plan(spawned, one, name):
    """The collectives each rank counts at the prefill and at each decode
    step equal ``step_collectives``'s: a decode merges every layer (one
    all-gather of the (B, H, D + 2) partials), and with 4 q heads over 4
    gathers q first."""
    cfg = one[name]["cfg"]
    want = [TRL.step_collectives(kind, 0, M, model=M, cfg=cfg, tokens=tok,
                                 batch=B, seqs=B).count_by_kind
            for kind, tok in [("prefill", B * P)] + [("decode", B)] * GEN]
    ev = []
    TRL._slot_merges(ev, "decode", cfg, M, B, cfg.num_layers)
    assert sum(n for *_, n in ev) == cfg.num_layers * (
        2 if cfg.num_heads == 4 else 1)
    for r in range(M):
        assert _load(spawned, name, r)["counts"] == want, (name, r)

"""The port's LLM serving path against the JAX reference: parameter trees,
``load_params``, forward / prefill / decode of every LLM family (reduced
Llama-3.2-3B, Mamba2-2.7B, Qwen2-MoE-A2.7B, Qwen3-MoE-30B-A3B, Zamba2-7B,
Whisper-large-v3, Qwen2-VL-72B) on the reference's weights, and
``serve()``'s greedy tokens.

Tolerances: float32 runs (``dtype`` and ``param_dtype`` float32) agree to
rtol/atol 1e-4 (torch and XLA sum in other orders); bf16 runs to 3e-2,
the reference's own bf16 tolerance (``tests/test_models_smoke.py``).
Mamba2's conv tails (the pre-conv projections the decode cache keeps),
and in f32 the KV caches of the MoE, hybrid, audio and VLM families, get
an atol scaled by their largest entry (see ``_cache_atol``); their bf16
KV caches are held at the flat 3e-2, Whisper's at the measured atols of
``WHISPER_BF16_CACHE_ATOL``.  The reduced Whisper is held at twice the tolerance: its
encoder ends in a LayerNorm over a residual stream that reaches |550|,
and its f32 output sits ~2e-4 from a float64 oracle in either package
(``tests/test_torch_families.py::test_whisper_encoder_rounding_matches_reference``),
an error every decoder layer reads through its cross-attention; the
reference's and the port's f32 logits then sit 1.6e-4 apart, their bf16
logits 0.054.  The
bf16 runs hold the port to the reference compiled with XLA's
``xla_allow_excess_precision`` off, which rounds to bf16 after every
operation as the port (and the reference run op by op) does: by default
XLA keeps some fused bf16 intermediates in f32, and its logits then differ
from the same code run op by op by up to 0.047 at these sizes
(``test_jitted_reference_bf16_keeps_excess_precision``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import demo_batch as t_demo_batch  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

ARCHS = ("llama3.2-3b", "mamba2-2.7b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
         "zamba2-7b", "whisper-large-v3", "qwen2-vl-72b")
# families whose prefill runs the SSD (the reference's needs S % chunk == 0)
SSD_FAMILIES = ("ssm", "hybrid")
F32 = dict(dtype="float32", param_dtype="float32")
# The reduced Whisper's bf16 caches miss a flat atol in what reads its
# encoder: the cross K/V and the decoder's second layer, which reads them
# through its cross-attention (layer 0's self-attention k/v agree bit for
# bit after prefill).  Each key's atol, beside rtol 6e-2, is ~2.5x the
# largest gap measured at these sizes after the three decode steps: the
# atol needed was 0.40 (k), 0.36 (v), 0.11 (xk) and 0.13 (xv), on entries
# up to |57|, whose bf16 spacing is 0.25.
WHISPER_BF16_CACHE_ATOL = {"k": 1.0, "v": 1.0, "xk": 0.3, "xv": 0.3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, **kw):
    """Reduced reference and port models (configs replaced by ``kw``), the
    reference's weights and the port's copy of them."""
    cfg = get_config(name).reduced().replace(**kw)
    tcfg = t_get_config(name).reduced().replace(**kw)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    params = jax.jit(model.init)(jax.random.key(0))
    return cfg, model, params, tcfg, tmodel, load_params(tmodel, jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def pair():
    """``_pair``, made once per (name, kw) in this module (no test writes
    to the weights)."""
    made = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in made:
            made[key] = _pair(name, **kw)
        return made[key]

    return get


def _compiled(fn, *args, exact: bool):
    """``jax.jit(fn)`` compiled for ``args``; ``exact``: with XLA's excess
    bf16 precision off (every operation rounds to its own dtype)."""
    opts = {"xla_allow_excess_precision": False} if exact else None
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol, name, atol=None):
    """rtol = tol; atol = tol unless given."""
    atol = tol if atol is None else atol
    print(f"{name}: atol {atol:.3g}")
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=atol, err_msg=name)


def _cache_atol(family, dt, key, want, tol):
    """The atol of cache entry ``key``: tol * max(1, max|want|) for
    Mamba2's conv tails, and for the new families' f32 KV caches: the
    reference's init draws every stacked matrix with fan-in = the layer
    count (std 0.71 at 2 layers), so these projections reach |45|, and an
    entry whose sum cancels to near 0 keeps an absolute error on the scale
    of its terms (conv_x misses a flat atol by 1.7e-4 in f32 and 3.5e-2 in
    bf16; Qwen2-MoE's and Qwen2-VL's k caches by up to 3.5e-4 in f32).
    Whisper's bf16 caches: ``WHISPER_BF16_CACHE_ATOL``.  Else the flat
    tol."""
    if family == "audio" and dt == "bf16":
        return WHISPER_BF16_CACHE_ATOL[key]
    if key.startswith("conv_") or (
            dt == "f32" and family in ("moe", "hybrid", "audio", "vlm")):
        return tol * max(1.0, float(np.abs(_np(want)).max(initial=0.0)))
    return tol


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_num_params_match(name):
    want = {"llama3.2-3b": 3_212_749_824, "mamba2-2.7b": 2_830_951_936,
            "qwen2-moe-a2.7b": 14_315_784_192,
            "qwen3-moe-30b-a3b": 30_532_122_624, "zamba2-7b": 6_596_395_600,
            "whisper-large-v3": 1_601_976_320,
            "qwen2-vl-72b": 72_706_203_648}[name]
    assert build_model(get_config(name)).num_params() == want
    assert t_build_model(t_get_config(name)).num_params() == want


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_tree_paths_and_shapes_match(name):
    cfg = get_config(name).reduced()
    tmodel = t_build_model(t_get_config(name).reduced())
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert list(tmodel.layout.paths) == [tuple(k.key for k in p) for p, _ in flat]
    assert list(tmodel.layout.shapes) == [tuple(l.shape) for _, l in flat]


def test_load_params_carries_bf16_bit_exactly(pair):
    _, _, params, tcfg, _, tp = pair("llama3.2-3b")
    assert tcfg.param_dtype == "bfloat16"
    ref_leaves = jax.tree.leaves(params)
    port_leaves = tree_flatten(tp)[1]
    assert len(ref_leaves) == len(port_leaves)
    for r, t in zip(ref_leaves, port_leaves):
        assert r.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(r).view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))


def test_demo_batch_token_draws_match_reference():
    """The same draws in the same order: tokens and labels, and the VLM's
    vision embeddings and the audio family's frames."""
    extra = {"qwen2-vl-72b": ["vision_embeds"], "whisper-large-v3": ["frames"]}
    for name in ARCHS:
        a = demo_batch(get_config(name).reduced(), 3, 7, np.random.default_rng(5))
        b = t_demo_batch(t_get_config(name).reduced(), 3, 7, np.random.default_rng(5))
        assert sorted(a) == sorted(b) == sorted(["labels", "tokens"] + extra.get(name, []))
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


CASES = [("llama3.2-3b", "f32", 0), ("llama3.2-3b", "bf16", 0),
         ("llama3.2-3b", "f32", 8), ("mamba2-2.7b", "f32", 0),
         ("mamba2-2.7b", "bf16", 0)] + [
    (name, dt, 0) for name in ARCHS[2:] for dt in ("f32", "bf16")] + [
    ("qwen3-moe-30b-a3b", "f32", 8)]


@pytest.mark.parametrize("name,dt,window", CASES,
                         ids=[f"{n}-{d}-w{w}" for n, d, w in CASES])
def test_forward_prefill_decode_match_reference(pair, name, dt, window):
    """forward (with its aux loss), prefill (last logits and every cache
    entry) and three decode steps on the reference's weights; the dense
    and MoE ring buffers too.  The audio family runs on its demo frames,
    the VLM on text (its M-RoPE streams with images:
    ``tests/test_torch_families.py``)."""
    kw = dict(F32) if dt == "f32" else {}
    if window:
        kw["sliding_window"] = window
    cfg, model, params, tcfg, tmodel, tp = pair(name, **kw)
    tol = (1e-4 if dt == "f32" else 3e-2) * (2 if cfg.family == "audio" else 1)
    exact = dt == "bf16"
    ssd = cfg.family in SSD_FAMILIES
    ssm = cfg.family == "ssm"
    plen = 32 if ssd else 6  # an SSD prompt is a multiple of the chunk (32)
    batch = demo_batch(cfg, 2, plen + 3, np.random.default_rng(1))
    toks = batch["tokens"]
    tt = torch.from_numpy(toks)
    fk = {"frames": batch["frames"]} if "frames" in batch else {}
    tfk = {k: torch.from_numpy(v) for k, v in fk.items()}

    seq = plen if ssd else plen + 3  # the reference's SSD needs S % chunk == 0
    fwd = _compiled(lambda p, t, f: model.forward(p, cfg, t, **f), params,
                    toks[:, :seq], fk, exact=exact)
    logits, aux = fwd(params, toks[:, :seq], fk)
    tlogits, taux = tmodel.forward(tp, tcfg, tt[:, :seq], **tfk)
    _close(tlogits, logits, tol, "forward logits")
    _close(taux, aux, tol, "forward aux loss")

    prompt = toks[:, :plen]
    kw_pre = {} if ssm else {"max_seq": window or plen + 3}
    pre = _compiled(lambda p, t, f: model.prefill(p, cfg, t, **kw_pre, **f),
                    params, prompt, fk, exact=exact)
    last, cache = pre(params, prompt, fk)
    tlast, tcache = tmodel.prefill(tp, tcfg, tt[:, :plen], **kw_pre, **tfk)
    _close(tlast, last, tol, "prefill logits")

    def check_cache():
        assert sorted(tcache) == sorted(cache)
        for key in cache:
            if key == "length":
                assert tcache[key] == int(cache[key])
            elif key == "pos":
                np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(cache[key]))
            else:
                _close(tcache[key], cache[key], tol, f"cache {key}",
                       atol=_cache_atol(cfg.family, dt, key, cache[key], tol))

    check_cache()
    decode = _compiled(lambda p, c, t, pos: model.decode_step(p, cfg, c, t, pos),
                       params, cache, toks[:, plen], jnp.asarray(plen, jnp.int32),
                       exact=exact)
    for i in range(3):
        pos = plen + i
        lg, cache = decode(params, cache, toks[:, pos], jnp.asarray(pos, jnp.int32))
        tlg, tcache = tmodel.decode_step(tp, tcfg, tcache, tt[:, pos], pos)
        _close(tlg, lg, tol, f"decode {i} logits")
    check_cache()


def test_jitted_reference_bf16_keeps_excess_precision(pair):
    """Why the bf16 cases compile the reference with excess precision off:
    by default its jitted forward differs from that beyond 3e-2 in some
    logits, while the port stays within one bf16 ulp (2^-8) of it.  (With
    it off, the compiled forward equals the reference run op by op under
    ``jax.disable_jit``, bit for bit; not repeated here, as the op-by-op
    run takes seconds.)"""
    cfg, model, params, tcfg, tmodel, tp = pair("llama3.2-3b")
    toks = demo_batch(cfg, 2, 9, np.random.default_rng(1))["tokens"]
    fwd = lambda p, t: model.forward(p, cfg, t)[0]  # noqa: E731
    jitted = _np(jax.jit(fwd)(params, toks))
    exact = _np(_compiled(fwd, params, toks, exact=True)(params, toks))
    port = _np(tmodel.forward(tp, tcfg, torch.from_numpy(toks))[0])
    assert np.abs(jitted - exact).max() > 3e-2
    assert np.abs(port - exact).max() <= 2.0**-8


@pytest.mark.parametrize("name", ARCHS)
def test_serve_greedy_tokens_match_reference(pair, name):
    cfg, model, params, tcfg, tmodel, tp = pair(name, **F32)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    frames = None
    if cfg.family == "audio":
        frames = rng.normal(0, 0.02, (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want, _ = ref_serve(cfg, model, params, jnp.asarray(prompts), gen=8,
                        frames=None if frames is None else jnp.asarray(frames))
    got, stats = serve(tcfg, tmodel, tp, torch.from_numpy(prompts), gen=8,
                       frames=None if frames is None else torch.from_numpy(frames))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    assert tuple(stats["prefill_logits"].shape) == (2, tcfg.vocab_size)

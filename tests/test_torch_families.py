"""The port's VLM, int8-cache, hybrid and audio pieces against the JAX
reference, beyond the serve path's parity (``tests/test_torch_serve.py``):
M-RoPE with distinct (t, h, w) streams and spliced vision embeddings, at
Qwen2-VL's full-width sections and at the reduced config's clamp; the int8
KV cache (codes, scales, ``decode_attention_q``, a served prompt); Zamba2's
segments and cache slots; Whisper's cross-attention cache and its
encoder's f32 rounding.

Tolerances: float32 throughout; rtol 1e-4 with atol 1e-4 x max(1, the
largest entry), as the serve tests' scaled caches (the reduced init's
stacked matrices have std 0.71); the int8 codes bit-equal,
``decode_attention_q`` within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import hybrid as RH  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import vlm as RV  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import vlm as TV  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import demo_batch as t_demo_batch  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, **kw):
    cfg = get_config(name).reduced().replace(**kw)
    tcfg = t_get_config(name).reduced().replace(**kw)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    params = jax.jit(model.init)(jax.random.key(0))
    return cfg, model, params, tcfg, tmodel, load_params(
        tmodel, jax.tree.map(np.asarray, params))


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    atol = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# M-RoPE and the VLM's vision splice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [128, 64], ids=["full-sections", "reduced-clamp"])
def test_mrope_tables_match_reference(head_dim):
    """Distinct t/h/w streams through sections (16, 24, 24): at head_dim
    128 they fill the 64 frequency slots; at the reduced head_dim 64 the
    reference's slices clamp (t 0-15, h 16-31, w none) and so do the
    port's."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 500, (3, 2, 11)).astype(np.int32)
    sections = get_config("qwen2-vl-72b").mrope_sections
    cos, sin = RL.rope_cos_sin(jnp.asarray(pos), head_dim, 1e6, sections)
    tcos, tsin = TL.rope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert tuple(tcos.shape) == cos.shape == (2, 11, head_dim // 2)
    _close(tcos, cos, 1e-6, "cos")
    _close(tsin, sin, 1e-6, "sin")
    # each slot reads the stream its section names
    plain = [TL.rope_cos_sin(torch.from_numpy(pos[i]), head_dim, 1e6)[0]
             for i in range(3)]
    cut = np.cumsum((0,) + sections).clip(max=head_dim // 2)
    for i in range(3):
        assert torch.equal(tcos[..., cut[i]:cut[i + 1]], plain[i][..., cut[i]:cut[i + 1]])
    if head_dim == 64:
        assert cut[2] == cut[3] == 32  # w gets no slot


def test_mrope_positions_match_reference():
    for n_img, n_text, grid in ((16, 7, 4), (0, 5, 1), (9, 3, 3)):
        want = RV.mrope_positions(2, n_img, n_text, grid)
        got = TV.mrope_positions(2, n_img, n_text, grid)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("head_dim", [128, 64], ids=["full-sections", "reduced-clamp"])
def test_vlm_forward_and_loss_with_vision_embeds_match_reference(head_dim):
    """The demo batch's 16 vision embeddings spliced before 7 text tokens:
    image patches at (0, row, col), text continuing at 4.. on all three
    streams; logits and the text-only loss against the reference."""
    cfg, model, params, tcfg, tmodel, tp = _pair("qwen2-vl-72b", head_dim=head_dim, **F32)
    batch = demo_batch(cfg, 2, 7, np.random.default_rng(1))
    tbatch = {k: torch.from_numpy(v) for k, v in
              t_demo_batch(tcfg, 2, 7, np.random.default_rng(1)).items()}
    logits, aux = jax.jit(lambda p, t, v: RV.forward(p, cfg, t, vision_embeds=v))(
        params, batch["tokens"], batch["vision_embeds"])
    tlogits, taux = TV.forward(tp, tcfg, tbatch["tokens"],
                               vision_embeds=tbatch["vision_embeds"])
    assert tuple(tlogits.shape) == (2, 16 + 7, cfg.vocab_size)
    _close(tlogits, logits, 1e-4, "vlm logits")
    loss = jax.jit(lambda p, b: model.loss_fn(p, cfg, b))(params, batch)
    tloss = tmodel.loss_fn(tp, tcfg, tbatch)
    assert abs(float(tloss) - float(loss)) <= 1e-5
    # the vision positions change the text logits (the streams differ)
    text_only = TV.forward(tp, tcfg, tbatch["tokens"])[0]
    assert not torch.allclose(text_only, tlogits[:, 16:], atol=1e-3)


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------


def test_quantize_kv_codes_and_scales_match_reference():
    x = np.random.default_rng(2).normal(0, 3, (2, 33, 4, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the scale's 1e-8 floor
    q, scale = RL.quantize_kv(jnp.asarray(x))
    tq, tscale = TL.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))


@pytest.mark.parametrize("window", [False, True], ids=["length", "window_pos"])
def test_decode_attention_q_matches_reference(window):
    rng = np.random.default_rng(3)
    b, s, kv, h, d = 2, 40, 2, 6, 64
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    kq, ksc = RL.quantize_kv(jnp.asarray(rng.normal(0, 1, (b, s, kv, d)), jnp.float32))
    vq, vsc = RL.quantize_kv(jnp.asarray(rng.normal(0, 1, (b, s, kv, d)), jnp.float32))
    wpos = np.where(np.arange(s) < 29, np.arange(s), -1)[None].repeat(b, 0).astype(np.int32)
    kw = {"window_pos": wpos} if window else {}
    want = RL.decode_attention_q(jnp.asarray(q), kq, vq, ksc, vsc, 29, **kw)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = TL.decode_attention_q(t(q), t(kq), t(vq), t(ksc), t(vsc), 29,
                                **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_int8_cache_prefill_and_decode_match_reference():
    """Reduced Llama-3.2-3B with ``kv_cache_dtype="int8"``: the prefill's
    codes within one step of the reference's (a value at a rounding
    boundary may round the other way) and its scales, and three decode
    steps' logits."""
    cfg, model, params, tcfg, tmodel, tp = _pair("llama3.2-3b", kv_cache_dtype="int8", **F32)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    tt = torch.from_numpy(toks)
    last, cache = jax.jit(lambda p, t: model.prefill(p, cfg, t, max_seq=9))(params, toks[:, :6])
    tlast, tcache = tmodel.prefill(tp, tcfg, tt[:, :6], max_seq=9)
    _close(tlast, last, 1e-4, "prefill logits")
    assert sorted(tcache) == sorted(cache)
    for key in ("k", "v"):
        assert tcache[key].dtype == torch.int8
        diff = np.abs(tcache[key].numpy().astype(int) - np.asarray(cache[key]).astype(int))
        assert diff.max() <= 1 and diff.mean() < 1e-3, (key, diff.max(), diff.mean())
        _close(tcache[key + "_scale"], cache[key + "_scale"], 1e-4, f"{key}_scale")
    decode = jax.jit(lambda p, c, t, pos: model.decode_step(p, cfg, c, t, pos))
    for pos in range(6, 9):
        lg, cache = decode(params, cache, toks[:, pos], jnp.asarray(pos, jnp.int32))
        tlg, tcache = tmodel.decode_step(tp, tcfg, tcache, tt[:, pos], pos)
        _close(tlg, lg, 1e-4, f"decode {pos} logits")


# ---------------------------------------------------------------------------
# Zamba2's segments and cache slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_zamba2_segments_and_cache_slots_match_reference(reduced):
    """81 layers in segments of 6 (13 shared-attention invocations, so 13
    KV slots) at full width; 4 layers in segments of 2 (one slot) reduced.
    Cache shapes and dtypes as the reference's (the port's on the meta
    device, the reference's by ``eval_shape``)."""
    cfg, tcfg = get_config("zamba2-7b"), t_get_config("zamba2-7b")
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    assert TH.segments(tcfg) == RH.segments(cfg)
    slots = len(TH.segments(tcfg)) - 1
    assert slots == (1 if reduced else 13) == (cfg.num_layers - 1) // cfg.attn_every
    want = jax.eval_shape(lambda: RH.init_cache(cfg, 3, 10))
    got = TH.init_cache(tcfg, 3, 10, device="meta")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).replace("torch.", "") == str(w.dtype), key
    assert got["attn_k"].shape[0] == slots


# ---------------------------------------------------------------------------
# Whisper: the cross-attention cache and the encoder's rounding
# ---------------------------------------------------------------------------


def test_whisper_cross_kv_matches_reference_and_prefill():
    cfg, model, params, tcfg, tmodel, tp = _pair("whisper-large-v3", **F32)
    frames = demo_batch(cfg, 2, 4, np.random.default_rng(5))["frames"]
    enc = jax.jit(lambda p, f: RE.encode(p, cfg, f))(params, frames)
    xk, xv = jax.jit(lambda p, e: RE.precompute_cross_kv(p, cfg, e))(params, enc)
    tenc = torch.from_numpy(np.array(enc))
    txk, txv = TE.precompute_cross_kv(tp, tcfg, tenc)
    assert tuple(txk.shape) == xk.shape == (cfg.num_layers, 2, cfg.encoder_seq,
                                            cfg.num_kv_heads, cfg.resolved_head_dim)
    _close(txk, xk, 1e-4, "xk")
    _close(txv, xv, 1e-4, "xv")
    # the prefill's cross cache is the same computation on its own encoding
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32))
    _, cache = tmodel.prefill(tp, tcfg, toks, frames=torch.from_numpy(frames), max_seq=8)
    own = TE.precompute_cross_kv(tp, tcfg, TE.encode(tp, tcfg, torch.from_numpy(frames)))
    assert torch.equal(cache["xk"], own[0]) and torch.equal(cache["xv"], own[1])
    assert cache["xk"][1].is_contiguous()


def _np_encode(tree, cfg, frames):
    """Whisper's encoder in numpy float64 (an oracle): sinusoidal
    positions, pre-LN blocks of non-causal attention (GQA: the reduced
    config keeps 2 KV heads for 4 query heads) with qkv bias and a tanh
    GELU MLP, a final LayerNorm."""
    def ln(x, p):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + cfg.norm_eps) * p["scale"] + p["bias"]

    s, d = frames.shape[1], cfg.d_model
    ang = np.arange(s)[:, None] / 10000.0 ** (2 * np.arange(d // 2)[None] / d)
    x = frames + np.concatenate([np.sin(ang), np.cos(ang)], -1)[None]
    for i in range(cfg.encoder_layers):
        lp = jax.tree.map(lambda a: a[i], tree["enc_layers"])
        a = lp["attn"]
        h = ln(x, lp["ln_attn"])
        q, k, v = (np.einsum("bsd,dhk->bshk", h, a[w]) + a[bias]
                   for w, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        g = q.shape[2] // k.shape[2]
        k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
        sc = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        x = x + np.einsum("bshk,hkd->bsd", np.einsum("bhqk,bkhd->bqhd", p, v), a["wo"])
        m = lp["mlp"]
        g = ln(x, lp["ln_mlp"]) @ m["wi"] + m["bi"]
        g = 0.5 * g * (1 + np.tanh(np.sqrt(2 / np.pi) * (g + 0.044715 * g ** 3)))
        x = x + g @ m["wo"] + m["bo"]
    return ln(x, tree["enc_ln_f"])


def test_whisper_encoder_rounding_matches_reference():
    """Why the serve tests hold the reduced Whisper at twice the tolerance:
    its encoder's residual stream reaches |550| and its attention scores
    the hundreds, so in f32 both packages' encoder outputs sit ~2e-4 from
    a float64 oracle (against entries up to |4.4|).  The port's f32
    encoder is no further from the oracle than 1.5x the reference's."""
    cfg, model, params, tcfg, tmodel, tp = _pair("whisper-large-v3", **F32)
    frames = demo_batch(cfg, 2, 4, np.random.default_rng(1))["frames"]
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    oracle = _np_encode(tree, cfg, frames.astype(np.float64))
    ref = np.asarray(jax.jit(lambda p, f: RE.encode(p, cfg, f))(params, frames), np.float64)
    port = TE.encode(tp, tcfg, torch.from_numpy(frames)).double().numpy()
    d_ref, d_port = np.abs(ref - oracle).max(), np.abs(port - oracle).max()
    print(f"encoder f32 vs f64: reference {d_ref:.3g}, port {d_port:.3g}, "
          f"max |entry| {np.abs(oracle).max():.3g}")
    assert 1e-5 < d_ref < 1e-3
    assert d_port <= 1.5 * d_ref


def test_serve_batched_example_runs_on_the_cpu():
    """The example twin: the reference's ARCHS (Llama, Mamba2, Qwen3-MoE),
    then the ring-cache pass for the attention archs (36 slots, wrapped by
    a 32-token prompt and 8 new tokens)."""
    out = serve_batched.main(["--device", "cpu"])
    assert list(out) == serve_batched.ARCHS + [
        "llama3.2-3b window", "qwen3-moe-30b-a3b window"]
    for name, (toks, stats) in out.items():
        vocab = t_get_config(name.split()[0]).reduced().vocab_size
        assert tuple(toks.shape) == (2, 8), name
        assert 0 <= int(toks.min()) and int(toks.max()) < vocab, name

"""The port's LLM serving path against the JAX reference: parameter trees,
``load_params``, forward / prefill / decode of reduced Llama-3.2-3B and
Mamba2-2.7B on the reference's weights, ``serve()``'s greedy tokens, and
the families that are refused.

Tolerances: float32 runs (``dtype`` and ``param_dtype`` float32) agree to
rtol/atol 1e-4 (torch and XLA sum in other orders); bf16 runs to 3e-2,
the reference's own bf16 tolerance (``tests/test_models_smoke.py``).  Only
Mamba2's conv tails (the pre-conv projections the decode cache keeps) get
an atol scaled by their largest entry (see ``_close``).  The
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
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import demo_batch as t_demo_batch  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

ARCHS = ("llama3.2-3b", "mamba2-2.7b")
F32 = dict(dtype="float32", param_dtype="float32")


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


def _close(got, want, tol, name, scaled=False):
    """rtol = atol = tol; with ``scaled``, atol = tol * max(1, max|want|).
    Scaled is for Mamba2's conv tails only: the reference's init draws
    every stacked matrix with fan-in = the layer count (std 0.71 at 2
    layers), so these pre-conv projections reach |45|, and an entry whose
    sum cancels to near 0 keeps an absolute error on the scale of its terms
    (conv_x misses a flat atol by 1.7e-4 in f32 and 3.5e-2 in bf16)."""
    want = _np(want)
    peak = float(np.abs(want).max(initial=0.0))
    atol = tol * max(1.0, peak) if scaled else tol
    print(f"{name}: max|want| {peak:.4g}, atol {atol:.3g}")
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_num_params_match(name):
    want = {"llama3.2-3b": 3_212_749_824, "mamba2-2.7b": 2_830_951_936}[name]
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
    for name in ARCHS:
        a = demo_batch(get_config(name).reduced(), 3, 7, np.random.default_rng(5))
        b = t_demo_batch(t_get_config(name).reduced(), 3, 7, np.random.default_rng(5))
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


CASES = [("llama3.2-3b", "f32", 0), ("llama3.2-3b", "bf16", 0),
         ("llama3.2-3b", "f32", 8), ("mamba2-2.7b", "f32", 0),
         ("mamba2-2.7b", "bf16", 0)]


@pytest.mark.parametrize("name,dt,window", CASES,
                         ids=[f"{n}-{d}-w{w}" for n, d, w in CASES])
def test_forward_prefill_decode_match_reference(pair, name, dt, window):
    """forward, prefill (last logits and every cache entry) and three
    decode steps on the reference's weights; the dense ring buffer too."""
    kw = dict(F32) if dt == "f32" else {}
    if window:
        kw["sliding_window"] = window
    cfg, model, params, tcfg, tmodel, tp = pair(name, **kw)
    tol = 1e-4 if dt == "f32" else 3e-2
    exact = dt == "bf16"
    ssm = cfg.family == "ssm"
    plen = 32 if ssm else 6  # the ssm prompt is a multiple of the chunk (32)
    batch = demo_batch(cfg, 2, plen + 3, np.random.default_rng(1))
    toks = batch["tokens"]
    tt = torch.from_numpy(toks)

    seq = plen if ssm else plen + 3  # the reference's SSD needs S % chunk == 0
    fwd = _compiled(lambda p, t: model.forward(p, cfg, t), params, toks[:, :seq],
                    exact=exact)
    logits, _ = fwd(params, toks[:, :seq])
    _close(tmodel.forward(tp, tcfg, tt[:, :seq])[0], logits, tol, "forward logits")

    prompt = toks[:, :plen]
    kw_pre = {} if ssm else {"max_seq": window or plen + 3}
    pre = _compiled(lambda p, t: model.prefill(p, cfg, t, **kw_pre), params, prompt,
                    exact=exact)
    last, cache = pre(params, prompt)
    tlast, tcache = tmodel.prefill(tp, tcfg, tt[:, :plen], **kw_pre)
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
                       scaled=key.startswith("conv_"))

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
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _ = ref_serve(cfg, model, params, jnp.asarray(prompts), gen=8)
    got, stats = serve(tcfg, tmodel, tp, torch.from_numpy(prompts), gen=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    assert tuple(stats["prefill_logits"].shape) == (2, tcfg.vocab_size)


REFUSED = {
    "moe": ModelConfig("moe", "moe", 2, 64, 128, num_heads=4, num_kv_heads=2, d_ff=64),
    "int8-kv": t_get_config("llama3.2-3b").reduced().replace(kv_cache_dtype="int8"),
    "vlm": ModelConfig("vlm", "vlm", 2, 64, 128, num_heads=4, num_kv_heads=2, d_ff=64),
    "hybrid": ModelConfig("hybrid", "hybrid", 2, 64, 128, ssm_state=16),
    "audio": ModelConfig("audio", "audio", 2, 64, 128, num_heads=4, num_kv_heads=2, d_ff=64),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_unported_families_are_refused(kind):
    """build_model refuses each; serve refuses the unported families too
    (an int8-cache config never gets a model to serve)."""
    cfg = REFUSED[kind]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build_model(cfg)
    if kind != "int8-kv":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve(cfg, None, None, torch.zeros((1, 4), dtype=torch.int32), gen=1)

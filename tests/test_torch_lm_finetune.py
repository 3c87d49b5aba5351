"""Federated LM fine-tuning in the port against the JAX reference: the token
data, the new dense configs, ``loss_fn`` gradients of reduced InternLM2,
Qwen2 (``qkv_bias``), Qwen3 (``qk_norm``) and Mamba2, one ``afl_round``,
a short ``run_afl``, the training CLI on both engines, and the ssm
training dispatch (the chunked formula, never the ``ssd_scan`` kernel).

Tolerances: float32 runs (``dtype`` and ``param_dtype`` float32).  The
gradients are held per leaf at rtol 1e-3 and atol 1e-3 x the leaf's
largest entry, and so are the quantities a round derives from them: at
these sizes the f32 gradient itself is only good to a few 1e-4 of a
leaf's largest entry (both packages' f32 gradients of reduced InternLM2
are 3e-4 to 5e-4 from the port's f64 one, in every leaf), so the two
packages' summation orders leave them up to 5.3e-4 apart; the test holds
the port no further from f64 than the reference is.  The loss agrees to
1e-6.  A round's realised k is held within 2 and the eval loss of a run
within 0.02, as the ResNet-9 tests do (test_torch_afl.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import FLConfig, get_config  # noqa: E402
from repro.core import baselines as BL  # noqa: E402
from repro.core import runner  # noqa: E402
from repro.core.afl import afl_init, afl_round  # noqa: E402
from repro.core.runner import run_afl  # noqa: E402
from repro.data import DeviceLoader, SyntheticTokens  # noqa: E402
from repro.launch.train import build_device_data, build_federation  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import list_configs  # noqa: E402
from repro_torch.core import baselines as TBL  # noqa: E402
from repro_torch.core.afl import afl_init as t_afl_init  # noqa: E402
from repro_torch.core.afl import afl_round as t_afl_round  # noqa: E402
from repro_torch.core.runner import run_afl as t_run_afl  # noqa: E402
from repro_torch.data import DeviceLoader as TDeviceLoader  # noqa: E402
from repro_torch.data import SyntheticTokens as TSyntheticTokens  # noqa: E402
from repro_torch.examples import federated_llm_finetune  # noqa: E402
from repro_torch.experiments.scan_engine import run_afl_scanned  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402
from repro_torch.utils.tree import tree_unflatten as t_unflatten  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ("internlm2-1.8b", "qwen2-7b", "qwen3-32b", "mamba2-2.7b")
NEW_DENSE = ("internlm2-1.8b", "qwen2-7b", "qwen3-32b")
N = 4
SEQ = 64  # a multiple of the reduced Mamba2's SSD chunk (32)
JIT_INIT = jax.jit(afl_init, static_argnums=(0, 1, 2))
EVAL_ATOL = {"internlm2-1.8b": 0.02, "mamba2-2.7b": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    """Reduced f32 reference and port models, the reference's weights (as
    its ``run_afl`` makes them) and the port's copy."""
    cfg = get_config(name).reduced().replace(**F32)
    tcfg = t_get_config(name).reduced().replace(**F32)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    params = jax.jit(model.init)(jax.random.key(0))
    return cfg, model, params, tcfg, tmodel, load_params(
        tmodel, jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def pair():
    made = {}

    def get(name):
        if name not in made:
            made[name] = _pair(name)
        return made[name]

    return get


# ---------------------------------------------------------------------------
# Data and configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seed,n,seq", [(1024, 0, 40, 64), (97, 3, 7, 5)])
def test_synthetic_tokens_equal_reference(vocab, seed, n, seq):
    ref, port = SyntheticTokens(vocab, seed=seed), TSyntheticTokens(vocab, seed=seed)
    np.testing.assert_array_equal(port.probs, ref.probs)
    a, b = ref.make_split(n, seq, seed=seed + 1), port.make_split(n, seq, seed=seed + 1)
    assert sorted(a) == sorted(b) == ["labels", "tokens"]
    for k in a:
        assert b[k].dtype == a[k].dtype and b[k].shape == (n, seq)
        np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("name", ["internlm2-1.8b", "mamba2-2.7b"])
def test_language_device_data_equal_reference(name):
    """The training CLI's language branch (``train_n // 4`` sequences,
    permuted, dealt out in equal chunks) and ``build_federation``'s
    loader draws."""
    cfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
    fl, tfl = FLConfig(num_devices=5), TFLConfig(num_devices=5)
    kw = dict(train_n=400, eval_n=64, seq_len=16, seed=2)
    dev, ev = build_device_data(cfg, fl, **kw)
    tdev, tev = t_train.build_device_data(tcfg, tfl, **kw)
    assert len(tdev) == len(dev) == 5
    for a, b in zip(dev + [ev], tdev + [tev]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    fl4, tfl4 = FLConfig(num_devices=5, batch_size=4), TFLConfig(num_devices=5, batch_size=4)
    loader, _ = build_federation(cfg, fl4, **kw)
    tloader, _ = t_train.build_federation(tcfg, tfl4, **kw)
    for _ in range(3):
        a, b = loader.sample_all(), tloader.sample_all()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


def test_other_families_are_refused_with_item_3b():
    """The one family the training CLI refuses is audio: its token
    batches carry no encoder frames (the reference's CLI fails there)."""
    cfg = t_get_config("whisper-large-v3").reduced()
    with pytest.raises(NotImplementedError, match="carry no 'frames'"):
        t_train.build_device_data(cfg, TFLConfig(num_devices=2), train_n=40)


@pytest.mark.parametrize("name", NEW_DENSE)
def test_new_configs_trees_match_reference(name):
    """Registered, the same full-width parameter count, and the reduced
    tree's paths and shapes in flatten order."""
    assert name in list_configs()
    full = build_model(get_config(name)).num_params()
    assert t_build_model(t_get_config(name)).num_params() == full
    cfg = get_config(name).reduced()
    tmodel = t_build_model(t_get_config(name).reduced())
    flat = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(build_model(cfg).init, jax.random.key(0)))[0]
    assert list(tmodel.layout.paths) == [tuple(k.key for k in p) for p, _ in flat]
    assert list(tmodel.layout.shapes) == [tuple(l.shape) for _, l in flat]
    want = {"internlm2-1.8b": {}, "qwen2-7b": {"qkv_bias": True},
            "qwen3-32b": {"qk_norm": True}}[name]
    tcfg = t_get_config(name)
    assert {k: getattr(tcfg, k) for k in want} == want


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_gradients_match_reference(pair, name):
    cfg, model, params, tcfg, tmodel, tp = pair(name)
    batch = demo_batch(cfg, 2, SEQ, np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(model.loss_fn)(params, cfg, jb)
    tloss = tmodel.loss_fn(tp, tcfg, tb)
    tgrads = torch.func.grad(lambda p: tmodel.loss_fn(p, tcfg, tb))(tp)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    # the f64 gradient: how far each f32 one is from it, per leaf
    paths, leaves = tree_flatten(tp)
    tp64 = t_unflatten(paths, [l.double() for l in leaves])
    cfg64 = tcfg.replace(dtype=torch.float64)
    g64 = torch.func.grad(lambda p: tmodel.loss_fn(p, cfg64, tb))(tp64)
    off = {"ref": 0.0, "port": 0.0}
    for path, want, got, exact in zip(paths, jax.tree.leaves(grads),
                                      tree_flatten(tgrads)[1],
                                      tree_flatten(g64)[1]):
        want = np.asarray(want)
        peak = float(np.abs(want).max())
        assert peak > 0, path
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * peak, err_msg="/".join(path))
        exact = exact.numpy()
        scale = np.abs(exact).max()
        off["ref"] = max(off["ref"], np.abs(want - exact).max() / scale)
        off["port"] = max(off["port"], np.abs(got.numpy() - exact).max() / scale)
    print(f"{name}: largest f32 error / leaf max against f64: {off}")
    assert off["port"] <= 1.5 * off["ref"]


def test_mamba2_trains_through_the_chunked_formula(pair, monkeypatch):
    """``loss_fn`` (and so ``afl_round``'s vmapped gradient) never reaches
    ``ops.ssd_scan``; a forward without gradients at a multiple of the
    chunk does, once per layer, and the two agree."""
    _, _, _, tcfg, tmodel, tp = pair("mamba2-2.7b")
    tokens = torch.as_tensor(demo_batch(tcfg, 2, SEQ, np.random.default_rng(2))["tokens"])
    calls = []
    kernel = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    batch = {"tokens": tokens, "labels": tokens}
    torch.func.grad(lambda p: tmodel.loss_fn(p, tcfg, batch))(tp)
    torch.func.vmap(torch.func.grad(lambda p, b: tmodel.loss_fn(p, tcfg, b)),
                    in_dims=(None, 0))(tp, {k: v[None] for k, v in batch.items()})
    assert calls == []
    with torch.no_grad():
        logits, _ = tmodel.forward(tp, tcfg, tokens)
        trained, _ = TM.forward(tp, tcfg, tokens, train=True)
    assert len(calls) == tcfg.num_layers
    torch.testing.assert_close(logits, trained, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_lm_eval_runs_the_forward_without_gradients(pair, monkeypatch, engine,
                                                    tmp_path):
    """The language eval is ``loss_fn``'s value from the forward without
    gradients: Mamba2's then reaches ``ops.ssd_scan`` (on the card the
    CUDA kernel) once per layer at each eval of a run, on both engines,
    and equals ``loss_fn`` to 1e-5."""
    from repro_torch.core.runner import make_eval_fn

    _, _, _, tcfg, tmodel, tp = pair("mamba2-2.7b")
    batch = {k: torch.as_tensor(v) for k, v in
             demo_batch(tcfg, 2, SEQ, np.random.default_rng(3)).items()}
    calls = []
    kernel = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    with torch.no_grad():
        got = make_eval_fn(tmodel, tcfg)(tp, batch)
        want = tmodel.loss_fn(tp, tcfg, batch)
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)
    calls.clear()
    res = t_train.main([
        "--device", "cpu", "--arch", "mamba2-2.7b", "--reduced", "--devices",
        "4", "--rounds", "4", "--eval-every", "2", "--batch-size", "4",
        "--train-n", "200", "--seq-len", str(SEQ), "--intercontact", "20",
        "--engine", engine, "--workdir", str(tmp_path)])
    assert res.history["round"] == [2, 4]
    assert len(calls) == tcfg.num_layers * 2


def test_kernels_refuse_tensors_that_need_a_gradient():
    """The guard in front of the CUDA ``ssd_scan`` (called on the card in
    test_torch_cuda.py): inputs that require a gradient raise, also inside
    ``torch.func.grad``."""
    x = torch.ones(3)
    ops.refuse_grad("ssd_scan", x, x)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.refuse_grad("ssd_scan", x, torch.ones(3, requires_grad=True))

    def f(t):
        ops.refuse_grad("ssd_scan", t * 2.0)
        return t.sum()

    with pytest.raises(NotImplementedError, match="reference has no"):
        torch.func.grad(f)(x)


# ---------------------------------------------------------------------------
# AFL rounds and runs
# ---------------------------------------------------------------------------


def _flat(tree, lead=()):
    return np.concatenate([np.asarray(l, np.float32).reshape(lead + (-1,))
                           for l in jax.tree.leaves(tree)], axis=-1)


def test_one_round_matches_reference():
    """One ``mads`` round of reduced InternLM2 (f32, N = 4, exact
    thresholds) from the reference's weights on the same batch and
    schedule: the same successes, k within 2; x_norm2, the queues, the
    update of w and e_n within the gradients' tolerance (above; 2e-3 for
    the update, a sum of three uploads) but at most 2 boundary coordinates
    a device."""
    cfg = get_config("internlm2-1.8b").reduced().replace(**F32)
    tcfg = t_get_config("internlm2-1.8b").reduced().replace(**F32)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    kw = dict(num_devices=N, rounds=5, batch_size=2, mean_intercontact=20.0)
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    state = JIT_INIT(model, cfg, fl, jax.random.key(0))
    rng = np.random.default_rng(7)
    batch = {k: np.stack([demo_batch(cfg, 2, 32, rng)[k] for _ in range(N)])
             for k in ("tokens", "labels")}
    zeta = np.array([1, 1, 0, 1], np.int32)
    tau = 8.0 * zeta.astype(np.float32)
    h2 = np.full(N, 1e-9, np.float32)
    budgets = np.full(N, 100.0, np.float32)
    new, m = afl_round(state, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(zeta), jnp.asarray(tau), jnp.asarray(h2),
                       jnp.asarray(budgets), model=model, cfg=cfg, fl=fl,
                       policy=BL.ALL["mads"](model.num_params(), fl))
    tstate = t_afl_init(tmodel, tfl, 0, "cpu", params=load_params(
        tmodel, jax.tree.map(np.asarray, state.w)))
    tnew, tm = t_afl_round(
        tstate, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.as_tensor(zeta), torch.as_tensor(tau), torch.as_tensor(h2),
        torch.as_tensor(budgets), model=tmodel, fl=tfl,
        policy=TBL.ALL["mads"](tmodel.num_params(), tfl))
    np.testing.assert_array_equal(tm["success"].numpy(), np.asarray(m["success"]))
    assert float(tm["success"].sum()) == 3.0
    np.testing.assert_allclose(tm["k"].numpy(), np.asarray(m["k"]), atol=2)
    np.testing.assert_array_equal(tnew.kappa.numpy(), np.asarray(new.kappa))
    np.testing.assert_allclose(tm["x_norm2"].numpy(), np.asarray(m["x_norm2"]),
                               rtol=1e-3)
    np.testing.assert_allclose(tnew.q.numpy(), np.asarray(new.q), rtol=1e-3,
                               atol=1e-6)
    w0 = _flat(state.w)
    dw, tdw = _flat(new.w) - w0, tnew.w.numpy() - w0
    e, te = _flat(new.e_n, (N,)), tnew.e_n.numpy()
    assert np.abs(dw).max() > 0
    # the update sums three devices' uploads, each off by up to the
    # gradients' 5.4e-4 of their largest entry: 2e-3 of the largest update
    bad_w = np.abs(tdw - dw) > 2e-3 * np.abs(dw).max()
    bad_e = np.abs(te - e) > 1e-3 * np.abs(e).max()
    print(f"update off by {np.abs(tdw - dw).max() / np.abs(dw).max():.3g} of "
          f"its largest entry; e_n by {np.abs(te - e).max():.3g}, largest "
          f"{np.abs(e).max():.3g}")
    assert np.sum(bad_w) <= 2 * N and np.sum(bad_e) <= 2 * N


def _port_state(tmodel, tfl, ref_state):
    """The reference's ``AflState`` as the port's (flat, on the CPU)."""
    st = t_afl_init(tmodel, tfl, 0, "cpu", params=load_params(
        tmodel, jax.tree.map(np.asarray, ref_state.w)))
    return dataclasses.replace(
        st, **{f: torch.as_tensor(_flat(getattr(ref_state, f), (N,)))
               for f in ("w_n", "g_n", "e_n")},
        **{f: torch.as_tensor(np.array(getattr(ref_state, f)))
           for f in ("kappa", "q", "energy")},
        rnd=torch.as_tensor(np.array(ref_state.rnd)))


def _f64(state):
    return dataclasses.replace(state, **{f: getattr(state, f).double() for f in
                                         ("w", "w_n", "g_n", "e_n")})


@pytest.mark.parametrize("name", ["internlm2-1.8b", "mamba2-2.7b"])
def test_each_round_of_a_run_matches_reference(name):
    """Three ``mads`` rounds (f32, N = 4) of the reference on a run's data,
    with stale devices carrying g_n and e_n into later rounds; each round
    also through the port from the reference's state, in f32 and in f64.
    The same successes, k within 2; the update of w and each device's x =
    e_n + g_n + upload after the round (the sparsifier's input, whichever
    side of the threshold a coordinate fell) no further from the port's
    f64 round, relative to its largest entry, than twice the reference's
    f32 round is.  (Whole runs of reduced InternLM2 cannot be held so:
    local steps on its small-init embedding amplify the f32 gradients'
    ~1e-3 differences until two f32 runs are a whole update apart.)"""
    cfg = get_config(name).reduced().replace(**F32)
    tcfg = t_get_config(name).reduced().replace(**F32)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    tmodel64 = t_build_model(tcfg.replace(dtype=torch.float64,
                                          param_dtype=torch.float64))
    kw = dict(num_devices=N, rounds=3, batch_size=2, mean_intercontact=20.0)
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    policy = dataclasses.replace(BL.ALL["mads"](model.num_params(), fl),
                                 expose_uploads=True)
    tpolicy = dataclasses.replace(TBL.ALL["mads"](tmodel.num_params(), tfl),
                                  expose_uploads=True)
    state = JIT_INIT(model, cfg, fl, jax.random.key(0))
    dev, _ = build_device_data(cfg, fl, train_n=64, eval_n=8, seq_len=SEQ,
                               seed=0)
    loader = DeviceLoader(dev, 2, 0)
    zetas = np.array([[1, 0, 1, 0], [0, 1, 1, 0], [1, 1, 0, 1]], np.int32)
    h2 = np.full(N, 1e-9, np.float32)
    budgets = np.full(N, 100.0, np.float32)
    uploads = 0.0
    for r, zeta in enumerate(zetas):
        batch = loader.sample_all()
        tau = 8.0 * zeta.astype(np.float32)
        new, m = afl_round(state, {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(zeta), jnp.asarray(tau), jnp.asarray(h2),
                           jnp.asarray(budgets), model=model, cfg=cfg, fl=fl,
                           policy=policy)
        tstate = _port_state(tmodel, tfl, state)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        ins = [torch.as_tensor(v) for v in (zeta, tau, h2, budgets)]
        port = t_afl_round(tstate, tb, *ins, model=tmodel, fl=tfl,
                           policy=tpolicy)
        exact = t_afl_round(_f64(tstate), tb, *ins, model=tmodel64, fl=tfl,
                            policy=tpolicy)
        np.testing.assert_array_equal(port[1]["success"].numpy(),
                                      np.asarray(m["success"]))
        np.testing.assert_allclose(port[1]["k"].numpy(), np.asarray(m["k"]),
                                   atol=2)
        uploads += float(np.asarray(m["success"]).sum())
        w0 = _flat(state.w).astype(np.float64)
        ref_q = {"update": _flat(new.w).astype(np.float64) - w0,
                 "x": (_flat(new.e_n, (N,)) + _flat(new.g_n, (N,))
                       + _flat(m["upload"], (N,))).astype(np.float64)}
        for q, want in ref_q.items():
            got, f64 = ({"update": st.w.double().numpy() - w0,
                         "x": (st.e_n + st.g_n + mm["upload"]).double().numpy()}[q]
                        for st, mm in (port, exact))
            peak = max(np.abs(f64).max(), 1e-30)
            d_port = np.abs(got - f64).max() / peak
            d_ref = np.abs(want - f64).max() / peak
            print(f"{name} round {r} {q}: port {d_port:.3g}, reference "
                  f"{d_ref:.3g} of its largest entry from f64")
            assert d_port <= 2 * d_ref + 1e-6, (r, q)
        state = new
    assert uploads >= 5


@pytest.mark.parametrize("name", ["internlm2-1.8b", "mamba2-2.7b"])
def test_run_afl_tracks_reference_eval_loss(name, monkeypatch):
    """Four loop-engine rounds of ``mads`` (f32) from the reference's
    weights, data and schedule, read every round: uploads equal, k within
    2 and the eval loss within ``EVAL_ATOL``: 1e-4 for Mamba2 (the runs
    agree to ~2e-6); 0.02 for InternLM2, whose f32 runs drift apart by
    ~4e-3 in four rounds (the local steps amplify gradient rounding:
    ``test_each_round_of_a_run_matches_reference``), so its run is held
    round by round there."""
    cfg = get_config(name).reduced().replace(**F32)
    tcfg = t_get_config(name).reduced().replace(**F32)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    kw = dict(num_devices=N, rounds=4, batch_size=2, mean_intercontact=20.0)
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    state = JIT_INIT(model, cfg, fl, jax.random.key(0))
    monkeypatch.setattr(runner, "afl_init", JIT_INIT)
    dev, ev = build_device_data(cfg, fl, train_n=64, eval_n=32, seq_len=SEQ,
                                seed=0)
    ref = run_afl(model, cfg, fl, "mads", DeviceLoader(dev, 2, 0), ev,
                  rounds=4, eval_every=1, engine="loop")
    port = t_run_afl(tmodel, tcfg, tfl, "mads", TDeviceLoader(dev, 2, 0), ev,
                     rounds=4, eval_every=1, device="cpu",
                     params=load_params(tmodel, jax.tree.map(np.asarray, state.w)))
    assert port.history["round"] == ref.history["round"] == [1, 2, 3, 4]
    assert port.history["uploads"][-1] > 0
    np.testing.assert_allclose(port.history["uploads"], ref.history["uploads"])
    np.testing.assert_allclose(port.history["k_mean"], ref.history["k_mean"],
                               atol=2)
    gap = np.abs(np.subtract(port.history["eval"], ref.history["eval"]))
    print(f"{name}: eval loss apart by {gap.tolist()} (rounds 1-4)")
    np.testing.assert_allclose(port.history["eval"], ref.history["eval"],
                               atol=EVAL_ATOL[name])


@pytest.mark.parametrize("name", ["internlm2-1.8b", "mamba2-2.7b"])
def test_scan_engine_equals_loop_on_lm_rounds(name):
    """The whole-run engine on the loop's prestacked draws (bf16, the
    default dtype): the same state bit for bit on the CPU, the same
    history within the engines' rtol 2e-4 (test_torch_experiments.py)."""
    tcfg = t_get_config(name).reduced()
    tmodel = t_build_model(tcfg)
    fl = TFLConfig(num_devices=N, rounds=3, batch_size=2,
                   mean_intercontact=20.0, learning_rate=0.5)
    dev, ev = t_train.build_device_data(tcfg, fl, train_n=64, eval_n=32,
                                        seq_len=SEQ, seed=0)
    loop = t_run_afl(tmodel, tcfg, fl, "mads", TDeviceLoader(dev, 2, 0), ev,
                     rounds=3, eval_every=1, device="cpu")
    scan = run_afl_scanned(tmodel, tcfg, fl, "mads", TDeviceLoader(dev, 2, 0),
                           ev, rounds=3, eval_every=1, device="cpu")
    assert loop.history["uploads"][-1] > 0
    # the whole-run engine sums its history on the device in f32
    assert scan.history["round"] == loop.history["round"]
    for k in loop.history:
        np.testing.assert_allclose(scan.history[k], loop.history[k],
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    for f in ("w", "w_n", "g_n", "e_n"):
        assert torch.equal(getattr(scan.state, f), getattr(loop.state, f)), f


# ---------------------------------------------------------------------------
# The training CLI and the example twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["loop", "scan"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b"])
def test_train_cli_reduced_lm(arch, engine, tmp_path):
    K.reset_launches()
    res = t_train.main([
        "--device", "cpu", "--arch", arch, "--reduced", "--devices", "4",
        "--rounds", "2", "--eval-every", "1", "--batch-size", "4",
        "--train-n", "200", "--seq-len", str(SEQ), "--intercontact", "20",
        "--engine", engine, "--workdir", str(tmp_path)])
    assert res.history["round"] == [1, 2]
    assert res.history["uploads"][-1] > 0
    assert all(np.isfinite(res.history["eval"]))
    assert torch.isfinite(res.state.w).all()
    assert res.state.w.dtype == torch.bfloat16  # the reduced config's dtype
    assert (tmp_path / "history.json").exists()
    assert sum(K.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_example_twin_runs_on_the_cpu(capsys):
    res = federated_llm_finetune.main(["--device", "cpu", "--rounds", "4"])
    assert res.history["round"] == [4]
    assert np.isfinite(res.final_eval)
    assert "loss improvement over federation" in capsys.readouterr().out

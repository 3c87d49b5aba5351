"""Federated fine-tuning of the MoE, hybrid and VLM families in the port
against the JAX reference: the training CLI's token data (and its
refusal of the audio family), the eval metric (the reference's
``model.loss_fn``, the MoE's aux loss included), each round of a short
``mads`` run, the whole-run engine on MoE rounds and the CLIs.  The
clients' vmapped gradient and the distributed step of these families:
``test_torch_family_dist.py``.

Tolerances are those of ``test_torch_lm_finetune.py``, float32 runs: a
round's update and sparsifier input no further from the port's f64 round,
relative to its largest entry, than twice the reference's f32 round is
(the f32 gradient is only good to ~1e-3 of a leaf's largest entry, and
the two packages sum in other orders); k within 2; the eval within 1e-5.
Each model pair is made once a module (a fixture).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import FLConfig, get_config  # noqa: E402
from repro.core import baselines as BL  # noqa: E402
from repro.core.afl import afl_init, afl_round  # noqa: E402
from repro.data import DeviceLoader  # noqa: E402
from repro.launch.train import build_device_data  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import baselines as TBL  # noqa: E402
from repro_torch.core.afl import afl_init as t_afl_init  # noqa: E402
from repro_torch.core.afl import afl_round as t_afl_round  # noqa: E402
from repro_torch.core.runner import make_eval_fn  # noqa: E402
from repro_torch.core.runner import run_afl as t_run_afl  # noqa: E402
from repro_torch.data import DeviceLoader as TDeviceLoader  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.experiments.scan_engine import run_afl_scanned  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.launch import sweep as t_sweep  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
N = 4
SEQ = 64  # a multiple of the reduced Zamba2's SSD chunk (32)
# one config of each family the training CLI now takes
FAMILIES = {"moe": "qwen3-moe-30b-a3b", "hybrid": "zamba2-7b",
            "vlm": "qwen2-vl-72b"}
JIT_INIT = jax.jit(afl_init, static_argnums=(0, 1, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """Reduced f32 reference and port models, the reference's weights and
    the port's copy of them, made once per arch."""
    made = {}

    def get(name):
        if name not in made:
            cfg = get_config(name).reduced().replace(**F32)
            tcfg = t_get_config(name).reduced().replace(**F32)
            model, tmodel = build_model(cfg), t_build_model(tcfg)
            params = jax.jit(model.init)(jax.random.key(0))
            made[name] = (cfg, model, params, tcfg, tmodel, load_params(
                tmodel, jax.tree.map(np.asarray, params)))
        return made[name]

    return get


def _flat(tree, lead=()):
    return np.concatenate([np.asarray(l, np.float32).reshape(lead + (-1,))
                           for l in jax.tree.leaves(tree)], axis=-1)


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The training CLI's data, and the refusal of the audio family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_device_data_equal_reference(family):
    """The reference's order-1 Markov streams for the moe, hybrid and vlm
    families (the VLM's text only: no ``vision_embeds``), array for
    array."""
    name = FAMILIES[family]
    cfg, tcfg = get_config(name).reduced(), t_get_config(name).reduced()
    assert tcfg.family == family
    kw = dict(train_n=400, eval_n=64, seq_len=16, seed=3)
    dev, ev = build_device_data(cfg, FLConfig(num_devices=5), **kw)
    tdev, tev = t_train.build_device_data(tcfg, TFLConfig(num_devices=5), **kw)
    assert len(tdev) == len(dev) == 5
    for a, b in zip(dev + [ev], tdev + [tev]):
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


def test_audio_is_refused_with_the_frames_reason(tmp_path):
    """The reference's CLI batches carry tokens only, and its enc-dec
    ``loss_fn`` reads ``frames``: its Whisper run fails there, and the
    port's CLI refuses the family, saying so."""
    cfg = get_config("whisper-large-v3").reduced()
    dev, _ = build_device_data(cfg, FLConfig(num_devices=2), train_n=40,
                               seq_len=8)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    with pytest.raises(KeyError, match="frames"):
        model.loss_fn(params, cfg, {k: jnp.asarray(v[:2])
                                    for k, v in dev[0].items()})
    with pytest.raises(NotImplementedError, match="carry no 'frames'"):
        t_train.main(["--device", "cpu", "--arch", "whisper-large-v3",
                      "--reduced", "--devices", "2", "--rounds", "1",
                      "--workdir", str(tmp_path)])


# ---------------------------------------------------------------------------
# The eval metric: the reference's ``model.loss_fn``
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "qwen2-vl-72b"])
def test_eval_fn_equals_reference_loss_fn(pair, name):
    """``make_eval_fn`` of a language family is the reference's
    ``model.loss_fn`` to 1e-5: the MoE's includes ``router_aux_loss`` x
    its load-balance loss, the VLM's is the cross-entropy of the text
    positions behind ``vision_embeds``."""
    cfg, model, params, tcfg, tmodel, tp = pair(name)
    batch = demo_batch(cfg, 2, SEQ, np.random.default_rng(6))
    want = float(model.loss_fn(params, cfg, {k: jnp.asarray(v)
                                             for k, v in batch.items()}))
    with torch.no_grad():
        got = float(make_eval_fn(tmodel, tcfg)(tp, _tb(batch)))
        ce_only = float(tmodel.loss_fn(tp, tcfg.replace(router_aux_loss=0.0),
                                       _tb(batch)))
    if tcfg.family == "moe":  # the aux term is there, and far above 1e-5
        assert abs(want - ce_only) > 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# AFL rounds and runs
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_each_round_of_a_run_matches_reference(family):
    """Three ``mads`` rounds (f32, N = 4) of the reference on the training
    CLI's data, stale devices carrying g_n and e_n; each round also
    through the port from the reference's state, in f32 and f64.  The
    same successes, k within 2; the update of w and each device's x = e_n
    + g_n + upload after the round no further from the port's f64 round,
    relative to its largest entry, than twice the reference's f32 round
    (``test_torch_lm_finetune.py``'s standard)."""
    name = FAMILIES[family]
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
        ins = [torch.as_tensor(v) for v in (zeta, tau, h2, budgets)]
        port = t_afl_round(tstate, _tb(batch), *ins, model=tmodel, fl=tfl,
                           policy=tpolicy)
        exact = t_afl_round(_f64(tstate), _tb(batch), *ins, model=tmodel64,
                            fl=tfl, policy=tpolicy)
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


def test_scan_engine_equals_loop_on_moe_rounds():
    """The whole-run engine on the loop's prestacked draws, reduced
    Qwen3-MoE in bf16 (the CLI's dtype): the same state bit for bit on
    the CPU, the same history within the engines' rtol 2e-4."""
    tcfg = t_get_config("qwen3-moe-30b-a3b").reduced()
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
    assert scan.history["round"] == loop.history["round"]
    for k in loop.history:
        np.testing.assert_allclose(scan.history[k], loop.history[k],
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    for f in ("w", "w_n", "g_n", "e_n"):
        assert torch.equal(getattr(scan.state, f), getattr(loop.state, f)), f


# ---------------------------------------------------------------------------
# The CLIs and the example
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["loop", "scan"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_cli_reduced_family(family, engine, tmp_path):
    K.reset_launches()
    res = t_train.main([
        "--device", "cpu", "--arch", FAMILIES[family], "--reduced",
        "--devices", "4", "--rounds", "2", "--eval-every", "1",
        "--batch-size", "4", "--train-n", "200", "--seq-len", str(SEQ),
        "--intercontact", "20", "--engine", engine,
        "--workdir", str(tmp_path)])
    assert res.history["round"] == [1, 2]
    assert res.history["uploads"][-1] > 0
    assert all(np.isfinite(res.history["eval"]))
    assert torch.isfinite(res.state.w).all()
    assert res.state.w.dtype == torch.bfloat16  # the reduced config's dtype
    assert (tmp_path / "history.json").exists()
    assert sum(K.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_sweep_seq_len_reaches_the_data(monkeypatch, tmp_path):
    """``launch/sweep.py --seq-len`` (the reference's flag) is what
    ``build_device_data`` is given."""
    seen = {}

    class Stop(Exception):
        pass

    def fake(cfg, fl, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(t_sweep, "build_device_data", fake)
    with pytest.raises(Stop):
        t_sweep.main(["--device", "cpu", "--arch", "qwen3-moe-30b-a3b",
                      "--reduced", "--policies", "mads", "--speeds", "10",
                      "--seeds", "1", "--rounds", "2", "--devices", "4",
                      "--seq-len", "48", "--out", str(tmp_path)])
    assert seen["seq_len"] == 48


def test_serve_batched_runs_on_the_card_by_default(monkeypatch):
    """``run_arch`` asks for CUDA unless told otherwise, like every other
    entry point: without a card it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_batched.run_arch("llama3.2-3b", batch=1, prompt_len=8, gen=1)

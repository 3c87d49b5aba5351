"""The port's AFL round, runner and training CLI against the JAX reference.

Both packages get the same inputs: the reference's initial weights (carried
over with ``load_params``), the same numpy batches, schedules and budgets.
Gradients agree only to fp32 rounding (another reduction order), so the
MADS power and a realised k may move by a coordinate or two where a
magnitude sits at the threshold; selections given the same x are held
bit-equal in test_torch_sparsify.py.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore  # noqa: E402
from repro.configs import FLConfig, get_config  # noqa: E402
from repro.core import baselines as BL  # noqa: E402
from repro.core.afl import afl_init, afl_round  # noqa: E402
from repro.core import runner  # noqa: E402
from repro.core.runner import run_afl  # noqa: E402
from repro.data import DeviceLoader  # noqa: E402
from repro.launch.train import build_device_data  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.checkpoint import latest_step as t_latest_step  # noqa: E402
from repro_torch.checkpoint import restore as t_restore  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import baselines as TBL  # noqa: E402
from repro_torch.core.afl import afl_init as t_afl_init  # noqa: E402
from repro_torch.core.afl import afl_round as t_afl_round  # noqa: E402
from repro_torch.core.runner import run_afl as t_run_afl  # noqa: E402
from repro_torch.data import DeviceLoader as TDeviceLoader  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402

N = 4
JIT_INIT = jax.jit(afl_init, static_argnums=(0, 1, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes: torch's intra-op threads only contend with the
    other test workers (measured 3x slower with 8 threads than with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    """A reference (N, ...)-stacked tree as (N, s) numpy, flatten order."""
    return np.concatenate([np.asarray(l, np.float32).reshape(N, -1)
                           for l in jax.tree.leaves(tree)], axis=1)


def _flat1(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(-1)
                           for l in jax.tree.leaves(tree)])


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("resnet9-cifar10").replace(d_model=4)
    model = build_model(cfg)
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    # one config for every test here, so the reference compiles its
    # init and its mads round once
    kw = dict(num_devices=N, rounds=5, batch_size=4, mean_intercontact=20.0)
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    # one compile instead of a few dozen eager ones (the weights differ
    # from an eager init's, but both packages get the same ones)
    state = JIT_INIT(model, cfg, fl, jax.random.key(0))
    w_np = jax.tree.map(np.asarray, state.w)
    rng = np.random.default_rng(7)
    batch = {k: np.stack([demo_batch(cfg, 4, 0, rng)[k] for _ in range(N)])
             for k in ("images", "labels")}
    return cfg, model, tmodel, fl, tfl, state, w_np, batch


def _mismatches(a, b, rtol, atol):
    return int(np.sum(~np.isclose(a, b, rtol=rtol, atol=atol)))


@pytest.mark.parametrize("policy", ["mads", "afl"])
def test_one_round_matches_reference(setup, policy):
    """``mads`` (MADS power, top-k through sparsify_ef) and ``afl``
    (fixed power, all-or-nothing full upload, energy cap)."""
    cfg, model, tmodel, fl, tfl, state, w_np, batch = setup
    zeta = np.array([1, 1, 0, 1], np.int32)
    tau = 8.0 * zeta.astype(np.float32)
    h2 = np.full(N, 1e-9, np.float32)
    budgets = np.full(N, 100.0, np.float32)
    pol = BL.ALL[policy](model.num_params(), fl)
    new, m = afl_round(state, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(zeta), jnp.asarray(tau), jnp.asarray(h2),
                       jnp.asarray(budgets), model=model, cfg=cfg, fl=fl,
                       policy=pol)

    tstate = t_afl_init(tmodel, tfl, 0, "cpu",
                        params=load_params(tmodel, w_np))
    K.reset_launches()
    tnew, tm = t_afl_round(
        tstate, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.as_tensor(zeta), torch.as_tensor(tau), torch.as_tensor(h2),
        torch.as_tensor(budgets), model=tmodel, fl=tfl,
        policy=TBL.ALL[policy](tmodel.num_params(), tfl))
    assert K.LAUNCHES == {"sparsify_ef": 0, "sparsify_quantize_ef": 0,
                          "sparsify_quantize_ef_segmented": 0}

    np.testing.assert_array_equal(tm["success"].numpy(), np.asarray(m["success"]))
    np.testing.assert_array_equal(tnew.kappa.numpy(), np.asarray(new.kappa))
    assert float(tm["success"].sum()) == 3.0
    np.testing.assert_allclose(tm["k"].numpy(), np.asarray(m["k"]), atol=2)
    np.testing.assert_allclose(tm["x_norm2"].numpy(), np.asarray(m["x_norm2"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tnew.q.numpy(), np.asarray(new.q), rtol=1e-4,
                               atol=1e-6)
    # w and e_n: fp32 tolerance everywhere but at most 2 boundary
    # coordinates per device that the threshold may put on the other side
    assert _mismatches(tnew.w.numpy(), _flat1(new.w), 1e-4, 1e-6) <= 2 * N
    assert _mismatches(tnew.e_n.numpy(), _flat(new.e_n), 1e-4, 1e-6) <= 2 * N
    np.testing.assert_allclose(tnew.w_n.numpy(), _flat(new.w_n), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("policy", ["mads", "afl-spar"])
def test_run_afl_tracks_reference_eval(setup, policy, monkeypatch):
    """Five rounds of the loop engine from the same weights, data and
    schedule: the eval trajectories agree within 0.02 absolute (accuracy
    moves in steps of 1/eval_n, and a boundary coordinate may flip)."""
    cfg, model, tmodel, fl5, tfl5, state, w_np, _ = setup
    monkeypatch.setattr(runner, "afl_init", JIT_INIT)  # the fixture's weights
    dev, ev = build_device_data(cfg, fl5, train_n=64, eval_n=128, seed=0)
    ref = run_afl(model, cfg, fl5, policy, DeviceLoader(dev, 4, 0), ev,
                  rounds=5, eval_every=1, engine="loop")
    port = t_run_afl(tmodel, tmodel.cfg, tfl5, policy, TDeviceLoader(dev, 4, 0),
                     ev, rounds=5, eval_every=1, device="cpu",
                     params=load_params(tmodel, w_np))
    assert ref.history["round"] == port.history["round"]
    assert port.history["uploads"][-1] > 0
    np.testing.assert_allclose(port.history["eval"], ref.history["eval"],
                               atol=0.02)
    np.testing.assert_allclose(port.history["uploads"], ref.history["uploads"])


TRACE_SCENARIOS = {
    "manhattan": dict(mobility_model="manhattan", speed=15.0, area=300.0),
    "manhattan-het": dict(mobility_model="manhattan", speed=15.0, area=300.0,
                          het_dropout=0.2, het_availability=0.8,
                          het_avail_persist=0.3, het_compute_mean=1.0),
}


@pytest.mark.parametrize("scenario", sorted(TRACE_SCENARIOS))
def test_run_afl_tracks_reference_under_trace_mobility(setup, scenario,
                                                       monkeypatch):
    """Five loop-engine rounds of ``mads`` on a Manhattan-grid schedule
    (numpy backend; gated by the heterogeneity layer in the second case)
    from the same weights and data: the same uploads, k within 2, the
    eval within 0.02 of the reference's."""
    cfg, model, tmodel, fl5, tfl5, state, w_np, _ = setup
    kw = TRACE_SCENARIOS[scenario]
    fl = dataclasses.replace(fl5, **kw)
    tfl = dataclasses.replace(tfl5, **kw)
    monkeypatch.setattr(runner, "afl_init", JIT_INIT)  # the fixture's weights
    dev, ev = build_device_data(cfg, fl, train_n=64, eval_n=128, seed=0)
    ref = run_afl(model, cfg, fl, "mads", DeviceLoader(dev, 4, 0), ev,
                  rounds=5, eval_every=1, engine="loop")
    port = t_run_afl(tmodel, tmodel.cfg, tfl, "mads", TDeviceLoader(dev, 4, 0),
                     ev, rounds=5, eval_every=1, device="cpu",
                     params=load_params(tmodel, w_np))
    assert port.history["uploads"][-1] > 0
    np.testing.assert_allclose(port.history["uploads"], ref.history["uploads"])
    np.testing.assert_allclose(port.history["k_mean"], ref.history["k_mean"],
                               atol=2)
    np.testing.assert_allclose(port.history["eval"], ref.history["eval"],
                               atol=0.02)


def test_fedmobile_runs_on_a_device_backend_schedule(setup):
    """FedMobile's relay rewrite is host code; a schedule built by the
    device-resident backend reaches it (here on the CPU; on the card in
    test_torch_cuda.py)."""
    _, _, tmodel, _, tfl, _, w_np, batch = setup
    fl = dataclasses.replace(tfl, mobility_model="gauss_markov", area=300.0,
                             scenario_backend="jax")
    loader = TDeviceLoader([{k: v[i] for k, v in batch.items()}
                            for i in range(N)], 4, 0)
    res = t_run_afl(tmodel, tmodel.cfg, fl, "fedmobile", loader,
                    {k: v[0] for k, v in batch.items()}, rounds=1,
                    device="cpu", params=load_params(tmodel, w_np))
    assert res.history["round"] == [1]
    assert np.isfinite(res.final_eval) and torch.isfinite(res.state.w).all()


@pytest.mark.parametrize("policy", sorted(TBL.ALL))
def test_every_policy_runs_a_round(setup, policy):
    """Every ported policy takes a round on the CPU: finite models, 0/1
    successes, and a codec's realised bits within its tau*A budget."""
    _, _, tmodel, _, tfl, _, w_np, batch = setup
    state = t_afl_init(tmodel, tfl, 0, "cpu", params=load_params(tmodel, w_np))
    zeta = torch.tensor([1, 1, 0, 1])
    tau = torch.tensor([8.0, 0.01, 0.0, 3.0])
    pol = TBL.ALL[policy](tmodel.num_params(), tfl)
    new, m = t_afl_round(
        state, {k: torch.as_tensor(v) for k, v in batch.items()}, zeta, tau,
        torch.full((N,), 1e-9), torch.full((N,), 100.0), model=tmodel,
        fl=tfl, policy=pol)
    assert torch.isfinite(new.w).all() and torch.isfinite(new.w_n).all()
    assert set(m["success"].tolist()) <= {0.0, 1.0}
    assert float(m["success"][2]) == 0.0
    if pol.compressor is not None:
        from repro_torch.core.mads import rate_bps

        ctl = pol.controller
        budget = tau * rate_bps(m["power"], torch.full((N,), 1e-9),
                                ctl.bandwidth, ctl.noise_w_hz)
        assert (m["bits"] <= budget).all()


@pytest.mark.parametrize("knob", ["telemetry", "telemetry_perdevice",
                                  "telemetry_probes"])
def test_unported_telemetry_knobs_raise(setup, knob):
    """The reference's telemetry is not ported: setting one of its knobs
    is refused, naming the ROADMAP item, instead of running without it."""
    _, _, tmodel, _, tfl, _, _, _ = setup
    with pytest.raises(NotImplementedError, match=f"{knob}.*ROADMAP"):
        t_run_afl(tmodel, tmodel.cfg, dataclasses.replace(tfl, **{knob: True}),
                  "mads", None, {}, rounds=1, device="cpu")


def test_train_cli_writes_history_and_reference_checkpoint(tmp_path):
    wd = tmp_path / "w"
    res = t_train.main(["--device", "cpu", "--width", "4", "--devices", "4",
                        "--rounds", "2", "--eval-every", "1", "--batch-size",
                        "8", "--train-n", "64", "--intercontact", "20",
                        "--workdir", str(wd)])
    hist = json.loads((wd / "history.json").read_text())
    assert hist["args"]["device"] == "cpu"
    assert hist["history"]["round"] == [1, 2]
    assert np.isfinite(hist["history"]["eval"]).all()
    tree, step = restore(str(wd))
    assert step == 2
    port_tree, port_step = t_restore(str(wd))
    assert port_step == 2 and t_latest_step(str(wd)) == 2
    flat = np.concatenate([np.asarray(l).reshape(-1)
                           for l in jax.tree.leaves(tree)])
    np.testing.assert_array_equal(flat, res.state.w.numpy())
    ref_tree = jax.eval_shape(build_model(
        get_config("resnet9-cifar10").replace(d_model=4)).init,
        jax.random.key(0))
    assert jax.tree.structure(tree) == jax.tree.structure(ref_tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(port_tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags", [
    ["--mobility", "manhattan", "--speed", "15"],
    ["--mobility", "gauss_markov", "--scenario-backend", "jax", "--dropout",
     "0.2", "--availability", "0.8", "--compute-mean", "1"],
], ids=["manhattan", "gauss-markov-device-het"])
def test_train_cli_trace_mobility(tmp_path, flags):
    """The trace-mobility flags reach FLConfig as the reference's CLI sets
    them; contacts occur in a short run at --area 400."""
    res = t_train.main(flags + [
        "--device", "cpu", "--width", "4", "--devices", "12", "--rounds", "6",
        "--eval-every", "3", "--batch-size", "8", "--train-n", "160",
        "--area", "400", "--comm-range", "100", "--workdir", str(tmp_path)])
    hist = json.loads((tmp_path / "history.json").read_text())
    assert hist["args"]["mobility"] == flags[1] and hist["args"]["area"] == 400
    assert hist["history"]["round"] == [3, 6]
    assert res.history["uploads"][-1] > 0
    assert np.isfinite(res.history["eval"]).all()


def test_train_cli_defaults_to_cuda(tmp_path, monkeypatch):
    """Without --device the CLI runs on the card and refuses to start
    where CUDA is absent (no silent CPU path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--width", "4", "--devices", "4", "--rounds", "1",
                      "--workdir", str(tmp_path)])

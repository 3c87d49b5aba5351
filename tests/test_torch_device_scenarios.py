"""The device-resident scenario engine (torch twins) on the CPU.

Layered like the pipeline, as the reference holds its JAX twins
(tests/test_jax_scenarios.py):

* kinematics — statistical parity only (torch generators cannot replay
  numpy's streams): bounds, speed, grid and dwell properties, and contact
  statistics within the reference's 2x band of the numpy oracle;
* extraction — exact parity: on a SHARED in-range matrix,
  ``torch_contacts`` equals the numpy oracle (``contact_intervals`` +
  ``intervals_to_rounds``) and the reference's ``jax_contacts`` cell by
  cell;
* gains, heterogeneity (exact on shared draws, stationary in
  distribution) and the provider's device backend.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.scenarios import jax_contacts as JC  # noqa: E402
from repro_torch.configs import FLConfig  # noqa: E402
from repro_torch.mobility import intervals_to_rounds, measure_contact_stats  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    GaussMarkovModel,
    HeterogeneityModel,
    HotspotClusterModel,
    ManhattanGridModel,
    RandomWaypointModel,
    ScenarioProvider,
    TorchGaussMarkovModel,
    TorchHotspotClusterModel,
    TorchManhattanGridModel,
    TorchRandomWaypointModel,
    contact_intervals,
    contact_intervals_torch,
    gate_windows,
    rounds_from_in_range,
    torch_gains_along_trace,
    torch_model_from_config,
    torch_schedule_from_model,
)
from repro_torch.scenarios import torch_contacts as TC  # noqa: E402
from repro_torch.scenarios.heterogeneity import (  # noqa: E402
    reference_apply,
    torch_apply,
    torch_draws,
)
from repro_torch.scenarios.torch_kinematics import _reflect  # noqa: E402

CPU = "cpu"
MODEL_CASES = [
    (TorchRandomWaypointModel, dict(pause_max=2.0)),
    (TorchGaussMarkovModel, {}),
    (TorchManhattanGridModel, {}),
    (TorchHotspotClusterModel, dict(hotspot_radius=250.0)),
]
ORACLE_OF = {
    TorchRandomWaypointModel: RandomWaypointModel,
    TorchGaussMarkovModel: GaussMarkovModel,
    TorchManhattanGridModel: ManhattanGridModel,
    TorchHotspotClusterModel: HotspotClusterModel,
}
_ids = lambda x: getattr(x, "__name__", "")  # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_masks(seed: int, steps: int, n: int, densities=(0.05, 0.3, 0.7)):
    """Correlated random in-range matrices (runs, not salt-and-pepper)."""
    rng = np.random.default_rng(seed)
    for p in densities:
        walk = np.cumsum(rng.normal(0, 1, (steps, n)), axis=0)
        walk -= walk.mean(0)
        yield walk < np.quantile(walk, p, axis=0)


def _oracle_rounds(mask, dt, rounds, delta, drop_truncated=False):
    dev, start, dur = contact_intervals(mask, dt=dt)
    if drop_truncated:
        keep = start + dur < mask.shape[0] * dt - 1e-9  # ends before horizon
        dev, start, dur = dev[keep], start[keep], dur[keep]
    return intervals_to_rounds(dev, start, dur, mask.shape[1], rounds, delta)


def _np(*xs):
    return [np.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# kinematics: shapes, bounds, structure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls,extra", MODEL_CASES, ids=_ids)
def test_torch_trace_shapes_and_bounds(cls, extra):
    m = cls(num_devices=6, area=500.0, mean_speed=8.0, seed=3, device=CPU,
            **extra)
    tr = m.trace(200.0, 1.0)
    assert tr.pos.shape == (200, 6, 2) and tr.mes.shape == (200, 2)
    assert tr.pos.dtype == torch.float32 and tr.pos.device.type == "cpu"
    pos = tr.pos.numpy()
    assert np.isfinite(pos).all()
    assert pos.min() >= -1e-3 and pos.max() <= 500.0 + 1e-3
    assert tr.in_range(100.0).dtype == torch.bool
    # the same seed gives the same trace; another seed another one
    assert torch.equal(m.trace(200.0, 1.0).pos, tr.pos)
    other = dataclasses.replace(m, seed=4).trace(200.0, 1.0).pos
    assert not torch.equal(other, tr.pos)
    np.testing.assert_array_equal(tr.to_numpy().pos, pos)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_rwp_speed_bounds(seed):
    """Per-leg speeds are U(0.5v, 1.5v): no step may exceed 1.5 v dt."""
    v = 12.0
    m = TorchRandomWaypointModel(num_devices=16, area=400.0, mean_speed=v,
                                 pause_max=3.0, seed=seed, device=CPU)
    pos = m.trace(300.0, 1.0).pos.numpy()
    step = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
    assert step.max() <= 1.5 * v + 1e-3
    assert step.max() > 0.5 * v  # devices do move


def test_torch_manhattan_grid_snap_and_speed():
    m = TorchManhattanGridModel(num_devices=8, area=600.0, mean_speed=10.0,
                                block=100.0, seed=5, device=CPU)
    pos = m.trace(500.0, 1.0).pos.numpy()
    # at any instant one coordinate sits on a grid line (multiple of block)
    frac = np.abs(pos / 100.0 - np.round(pos / 100.0))
    assert (frac.min(axis=-1) < 1e-3).all()
    step = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
    assert step.max() <= 1.5 * 10.0 + 1e-3


def test_torch_hotspot_static_at_zero_speed():
    m = TorchHotspotClusterModel(num_devices=5, mean_speed=0.0, seed=2,
                                 device=CPU)
    pos = m.trace(50.0, 1.0).pos.numpy()
    assert np.all(pos == pos[0])


def test_torch_hotspot_dwell():
    """Devices orbit their anchor: excursions stay O(radius)."""
    radius = 100.0
    m = TorchHotspotClusterModel(num_devices=24, area=2000.0, mean_speed=5.0,
                                 num_hotspots=3, hotspot_radius=radius,
                                 seed=7, device=CPU)
    pos = m.trace(600.0, 1.0).pos.numpy()
    excur = np.linalg.norm(pos - pos.mean(axis=0)[None], axis=-1)
    assert np.quantile(excur, 0.95) < 5 * radius
    assert excur.max() < 0.5 * 2000.0


def test_torch_reflect_bounds():
    x = torch.linspace(-3000.0, 3000.0, 4001)
    y = _reflect(x, 500.0)
    assert (y >= 0).all() and (y <= 500.0).all()
    inside = (x >= 0) & (x <= 500.0)
    torch.testing.assert_close(y[inside], x[inside], atol=1e-3, rtol=0)


@pytest.mark.parametrize("cls,extra", MODEL_CASES, ids=_ids)
def test_torch_contact_stats_match_oracle(cls, extra):
    """Independent streams: mean contact / intercontact times agree with
    the numpy oracle's within the reference's 2x band per model (N = 512
    over 600 s in place of N = 40 over 3000 s)."""
    kw = dict(num_devices=512, area=600.0, mean_speed=9.0, **extra)
    tm = cls(seed=11, device=CPU, **kw)
    om = ORACLE_OF[cls](seed=12, **kw)
    c_t, g_t = measure_contact_stats(tm.trace(600.0, 1.0).in_range(100.0)
                                     .numpy())
    c_o, g_o = measure_contact_stats(om.trace(600.0, 1.0).in_range(100.0))
    assert c_t > 0 and np.isfinite(g_t)
    assert 0.5 < c_t / c_o < 2.0, (c_t, c_o)
    assert 0.5 < g_t / g_o < 2.0, (g_t, g_o)


# ---------------------------------------------------------------------------
# extraction: exact parity on shared in-range matrices
# ---------------------------------------------------------------------------


def test_run_bounds_match_jax():
    for mask in random_masks(5, steps=150, n=11):
        got = TC.run_bounds(torch.from_numpy(mask))
        want = JC.run_bounds(jax.numpy.asarray(mask))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_intervals_exact_on_shared_masks():
    for mask in random_masks(0, steps=400, n=17):
        want = contact_intervals(mask, dt=2.0)
        got = _np(*contact_intervals_torch(torch.from_numpy(mask), dt=2.0))
        jx = _np(*JC.contact_intervals_jax(mask, dt=2.0))
        for g, w, j in zip(got, want, jx):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("extra", [7, 0, -3])
def test_intervals_static_size(extra):
    """A static ``size``: padded with -1 devices beyond the intervals, cut
    at ``size`` below them, as ``jnp.nonzero(size=...)`` does."""
    mask = next(iter(random_masks(1, steps=200, n=5, densities=(0.3,))))
    k = len(contact_intervals(mask, dt=1.0)[0])
    got = _np(*contact_intervals_torch(torch.from_numpy(mask), 1.0,
                                       size=k + extra))
    want = _np(*JC.contact_intervals_jax(mask, 1.0, size=k + extra))
    for g, w in zip(got, want):
        assert g.shape == (k + extra,)
        np.testing.assert_array_equal(g, w)
    if extra > 0:
        assert (got[0][k:] == -1).all() and (got[2][k:] == 0).all()


@pytest.mark.parametrize("drop", [False, True])
def test_rounds_exact_on_integer_grid(drop):
    """dt = 1, delta = 10: bit-equal to the interval oracle and to the
    reference's JAX extractor, cell by cell."""
    for mask in random_masks(2, steps=400, n=13):
        z_o, t_o = _oracle_rounds(mask, 1.0, 40, 10.0, drop)
        z, t = rounds_from_in_range(torch.from_numpy(mask), 1.0, 40, 10.0,
                                    drop_truncated=drop)
        z_j, t_j = JC.rounds_from_in_range(mask, 1.0, 40, 10.0,
                                           drop_truncated=drop)
        assert z.dtype == torch.int32 and t.dtype == torch.float32
        for got, want in ((z, z_o), (t, t_o), (z, z_j), (t, t_j)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rounds_on_noninteger_grid():
    """Fractional delta/dt (and rounds past the horizon): zeta exact
    against the oracle, tau to f32 tolerance; both exact against the JAX
    extractor, which does the same f32 arithmetic."""
    dt, delta, rounds = 0.5, 3.3, 70
    for mask in random_masks(3, steps=380, n=9):
        z_o, t_o = _oracle_rounds(mask, dt, rounds, delta)
        z, t = rounds_from_in_range(torch.from_numpy(mask), dt, rounds, delta)
        z_j, t_j = JC.rounds_from_in_range(mask, dt, rounds, delta)
        np.testing.assert_array_equal(z.numpy(), z_o)
        np.testing.assert_allclose(t.numpy(), t_o, atol=1e-3)
        np.testing.assert_array_equal(z.numpy(), np.asarray(z_j))
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))


@pytest.mark.parametrize("steps,dt,rounds,delta", [
    (400, 1.0, 40, 10.0), (380, 0.5, 70, 3.3), (123, 0.7, 30, 2.9),
    (600, 0.1, 13, 4.7)])
def test_round_windows_equal_the_oracle_tables(steps, dt, rounds, delta):
    """The step windows built on the device in float64 equal the numpy
    tables the reference builds on the host."""
    r = np.arange(rounds)
    t_lo = np.floor(r * delta / dt).astype(np.int64)
    t_hi = np.minimum(np.ceil((r + 1) * delta / dt).astype(np.int64) - 1,
                      steps - 1)
    got = _np(*TC.round_windows(steps, dt, rounds, delta, CPU))
    for g, w in zip(got, (np.minimum(t_lo, steps - 1), t_hi, t_lo < steps)):
        np.testing.assert_array_equal(g, w)


def test_drop_truncated_regression():
    """Contacts still open at the trace end are dropped, nothing else."""
    mask = np.zeros((100, 2), bool)
    mask[12:30, 0] = True   # interior: 18 s
    mask[85:, 0] = True     # truncated: 15 s observed
    mask[40:58, 1] = True
    z_keep, t_keep = _np(*rounds_from_in_range(torch.from_numpy(mask), 1.0,
                                               10, 10.0))
    z_drop, t_drop = _np(*rounds_from_in_range(torch.from_numpy(mask), 1.0,
                                               10, 10.0, drop_truncated=True))
    z_o, t_o = _oracle_rounds(mask, 1.0, 10, 10.0, drop_truncated=True)
    np.testing.assert_array_equal(z_drop, z_o)
    np.testing.assert_array_equal(t_drop, t_o)
    assert z_keep[8, 0] == 1 and z_drop[8, 0] == 0
    assert z_keep.sum() - z_drop.sum() == 2
    np.testing.assert_array_equal(z_drop[:, 1], z_keep[:, 1])
    assert t_keep[(z_keep == 1) & (z_drop == 0)].max() <= 15.0


@pytest.mark.parametrize("cls,extra", MODEL_CASES, ids=_ids)
def test_rounds_exact_on_real_torch_traces(cls, extra):
    """A real torch trace's in-range matrix through both extractors gives
    identical (zeta, tau) schedules."""
    m = cls(num_devices=24, area=500.0, mean_speed=10.0, seed=9, device=CPU,
            **extra)
    mask = m.trace(600.0, 1.0).in_range(100.0)
    z_o, t_o = _oracle_rounds(mask.numpy(), 1.0, 60, 10.0)
    z, t = rounds_from_in_range(mask, 1.0, 60, 10.0)
    np.testing.assert_array_equal(z.numpy(), z_o)
    np.testing.assert_array_equal(t.numpy(), t_o)
    assert z_o.sum() > 0, "degenerate scenario: no contacts to compare"


# ---------------------------------------------------------------------------
# channel gains and the end-to-end schedule
# ---------------------------------------------------------------------------


def test_torch_gains_static_devices_see_constant_channel():
    pos = torch.tensor([[30.0, 0.0], [80.0, 0.0]]).expand(50, 2, 2)
    h2 = torch_gains_along_trace(3, pos, torch.zeros(50, 2)).numpy()
    # zero displacement: shadowing and LOS state frozen, a constant gain
    np.testing.assert_allclose(h2, np.broadcast_to(h2[0], h2.shape),
                               rtol=1e-5)


def test_torch_gains_decrease_with_distance():
    pos = torch.tensor([[15.0, 0.0], [90.0, 0.0]]).expand(5, 2, 2)
    h2 = torch_gains_along_trace(0, pos, torch.zeros(5, 2), shadow_los_db=0.0,
                                 shadow_nlos_db=0.0).numpy()
    assert h2.dtype == np.float32 and (h2[:, 0] > h2[:, 1]).all()


@pytest.mark.parametrize("cls,extra", MODEL_CASES, ids=_ids)
def test_torch_schedule_from_model(cls, extra):
    m = cls(num_devices=16, area=500.0, mean_speed=10.0, seed=2, device=CPU,
            **extra)
    zeta, tau, h2 = torch_schedule_from_model(m, 40, 10.0)
    assert zeta.shape == tau.shape == h2.shape == (40, 16)
    assert (zeta.dtype, tau.dtype, h2.dtype) == (torch.int32, torch.float32,
                                                 torch.float32)
    assert torch.equal(tau > 0, zeta == 1) and zeta.sum() > 0
    assert torch.isfinite(h2).all() and (h2 > 0).all()
    # its (zeta, tau) are the extraction of the model's own trace
    z, t = rounds_from_in_range(m.trace(400.0, 1.0).in_range(100.0), 1.0, 40,
                                10.0)
    assert torch.equal(z, zeta) and torch.equal(t, tau)
    again = torch_schedule_from_model(m, 40, 10.0)
    assert all(torch.equal(a, b) for a, b in zip(again, (zeta, tau, h2)))
    other = torch_schedule_from_model(m, 40, 10.0, seed=3)
    assert not torch.equal(other[2], h2)


# ---------------------------------------------------------------------------
# heterogeneity
# ---------------------------------------------------------------------------


def _schedule(seed, rounds, n, p=0.5, mean=8.0):
    rng = np.random.default_rng(seed)
    zeta = (rng.random((rounds, n)) < p).astype(np.int32)
    tau = np.where(zeta, rng.exponential(mean, (rounds, n)), 0.0)
    return zeta, tau.astype(np.float32)


def test_torch_apply_equals_gate_windows_on_shared_draws():
    zeta, tau = _schedule(0, 60, 12)
    m = HeterogeneityModel(num_devices=12, availability=0.7, avail_persist=0.2,
                           compute_mean=2.0, dropout=0.25, seed=1)
    avail, latency, drop = torch_draws(m, 60, CPU)
    assert (avail.dtype, latency.dtype, drop.dtype) == (
        torch.bool, torch.float32, torch.bool)
    z, t, aux = torch_apply(m, torch.from_numpy(zeta), torch.from_numpy(tau))
    z_g, t_g, aux_g = gate_windows(torch.from_numpy(zeta),
                                   torch.from_numpy(tau), avail, latency, drop)
    z_r, t_r, aux_r = reference_apply(zeta, tau, avail.numpy(),
                                      latency.numpy(), drop.numpy())
    assert z.dtype == torch.int32 and t.dtype == torch.float32
    for got, want in ((z, z_g), (t, t_g), (z, z_r), (t, t_r)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in ("unavail", "dropout"):
        np.testing.assert_array_equal(aux[k].numpy(), aux_g[k].numpy())
        np.testing.assert_array_equal(aux[k].numpy(), aux_r[k])
        assert aux[k].sum() > 0
    z2 = torch_apply(m, torch.from_numpy(zeta), torch.from_numpy(tau),
                     seed=2)[0]
    assert not torch.equal(z2, z)


@pytest.mark.parametrize("pi,rho", [(0.3, 0.0), (0.7, 0.5), (0.9, 0.8)])
def test_torch_availability_stationary_distribution(pi, rho):
    m = HeterogeneityModel(num_devices=400, availability=pi,
                           avail_persist=rho, seed=3)
    avail = torch_draws(m, 500, CPU)[0]
    assert abs(float(avail.float().mean()) - pi) < 0.02
    assert abs(m.sample_states(500).mean() - pi) < 0.02


def test_torch_apply_matches_numpy_in_distribution():
    zeta, tau = _schedule(5, 400, 64, mean=10.0)
    m = HeterogeneityModel(num_devices=64, availability=0.8, avail_persist=0.3,
                           compute_mean=2.0, dropout=0.2, seed=9)
    z_np, t_np, a_np = m.apply(zeta, tau)
    z_t, t_t, a_t = torch_apply(m, torch.from_numpy(zeta),
                                torch.from_numpy(tau))
    assert abs(z_np.mean() - float(z_t.float().mean())) < 0.03
    for k in ("unavail", "dropout"):
        assert abs(a_np[k].mean() - float(a_t[k].mean())) < 0.02
    surv_np = t_np[z_np == 1].mean()
    surv_t = float(t_t.sum() / z_t.sum().clamp(min=1))
    assert abs(surv_np - surv_t) / surv_np < 0.15


# ---------------------------------------------------------------------------
# provider: the device backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rwp", "gauss_markov", "manhattan",
                                  "hotspot", "static"])
def test_provider_device_backend_produces_rounds(name):
    fl = FLConfig(num_devices=16, rounds=100, mobility_model=name,
                  speed=10.0, area=600.0, seed=1, scenario_backend="jax")
    zeta, tau, h2 = ScenarioProvider.from_config(fl, device=CPU).schedule()
    assert zeta.shape == tau.shape == h2.shape == (100, 16)
    assert isinstance(zeta, torch.Tensor) and zeta.device.type == "cpu"
    if name != "static":
        assert zeta.sum() > 0, name
    assert torch.equal(tau > 0, zeta == 1)
    assert (h2 > 0).all() and torch.isfinite(h2).all()


def test_provider_device_backend_gates_on_the_device():
    fl = FLConfig(num_devices=16, rounds=100, mobility_model="hotspot",
                  speed=5.0, area=500.0, seed=1, scenario_backend="jax",
                  het_dropout=0.3, het_availability=0.6,
                  het_compute_mean=1.0)
    p = ScenarioProvider.from_config(fl, device=CPU)
    zeta, tau, _ = p.schedule()
    aux = p.aux
    assert isinstance(aux["dropout"], torch.Tensor)
    assert aux["dropout"].sum() > 0 and aux["unavail"].sum() > 0
    assert not (zeta * aux["dropout"]).any()
    assert not (zeta * aux["unavail"]).any()
    assert torch.equal(tau > 0, zeta == 1)
    assert torch.equal(p.aux_round(3)["unavail"], aux["unavail"][3])
    # the ungated schedule of the same scenario keeps every one of them
    ungated = ScenarioProvider.from_config(
        dataclasses.replace(fl, het_dropout=0.0, het_availability=1.0,
                            het_compute_mean=0.0), device=CPU)
    z0 = ungated.schedule()[0]
    assert ungated.aux is None
    assert torch.equal((z0 == 1) & (aux["dropout"] == 1), aux["dropout"] == 1)
    assert int(zeta.sum()) < int(z0.sum())


def test_provider_unknown_backend_raises():
    fl = FLConfig(num_devices=4, rounds=10, scenario_backend="tpu9000")
    with pytest.raises(KeyError):
        ScenarioProvider.from_config(fl, device=CPU)


def test_torch_model_from_config_unknown_model_raises():
    with pytest.raises(KeyError, match="unknown mobility model"):
        torch_model_from_config(FLConfig(mobility_model="levy"), device=CPU)
    m = torch_model_from_config(FLConfig(mobility_model="static", speed=7.0),
                                device=CPU)
    assert isinstance(m, TorchHotspotClusterModel) and m.mean_speed == 0.0
    m = torch_model_from_config(FLConfig(mobility_model="rwp"), 4, CPU)
    assert m.mean_speed == 10.0 and m.seed == 4 and m.device == "cpu"


def test_provider_device_backend_exponential_stays_host_side():
    fl = FLConfig(num_devices=8, rounds=30, mobility_model="exponential",
                  scenario_backend="jax")
    zeta, tau, h2 = ScenarioProvider.from_config(fl, device=CPU).schedule()
    assert isinstance(zeta, np.ndarray) and zeta.shape == (30, 8)
    ref = ScenarioProvider.from_config(
        dataclasses.replace(fl, scenario_backend="numpy")).schedule()
    for a, b in zip((zeta, tau, h2), ref):
        np.testing.assert_array_equal(a, b)


def test_differential_smoke_n512():
    """N = 512: both backends build the same scenario point and agree on
    contact statistics within 20 %; the extraction agrees exactly on the
    shared in-range matrix."""
    n, rounds = 512, 60
    base = dict(num_devices=n, rounds=rounds, mobility_model="gauss_markov",
                speed=10.0, area=800.0, seed=4)
    z_np, t_np, _ = ScenarioProvider.from_config(FLConfig(**base)).schedule()
    z_t, t_t, _ = _np(*ScenarioProvider.from_config(
        FLConfig(scenario_backend="jax", **base), device=CPU).schedule())
    assert z_t.shape == z_np.shape == (rounds, n)
    assert abs(z_t.mean() - z_np.mean()) / z_np.mean() < 0.2
    assert abs(t_t[z_t == 1].mean() - t_np[z_np == 1].mean()) \
        / t_np[z_np == 1].mean() < 0.2
    m = TorchGaussMarkovModel(num_devices=n, area=800.0, mean_speed=10.0,
                              seed=4, device=CPU)
    mask = m.trace(rounds * 10.0, 1.0).in_range(100.0)
    z_o, t_o = _oracle_rounds(mask.numpy(), 1.0, rounds, 10.0)
    z_x, t_x = rounds_from_in_range(mask, 1.0, rounds, 10.0)
    np.testing.assert_array_equal(z_x.numpy(), z_o)
    np.testing.assert_array_equal(t_x.numpy(), t_o)


def test_device_backend_refuses_a_missing_card(monkeypatch):
    """The device backend's default is the card; without one it raises
    instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fl = FLConfig(num_devices=4, rounds=5, mobility_model="rwp",
                  scenario_backend="jax")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScenarioProvider.from_config(fl).schedule()

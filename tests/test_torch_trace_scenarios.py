"""The port's numpy scenario modules against the reference: equal arrays.

The trace mobility models, the contact extraction, the position-coupled
gains, the waypoint helpers and the heterogeneity layer's numpy half are
numpy code carried over with imports rewritten; the same seeds must give
the same arrays (``assert_array_equal``), down to the gated provider
schedule and its aux masks.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import scenarios as RS  # noqa: E402
from repro.channel import WirelessChannel  # noqa: E402
from repro.configs import FLConfig  # noqa: E402
from repro.mobility import waypoint as RW  # noqa: E402
from repro.scenarios import heterogeneity as RH  # noqa: E402
from repro_torch import scenarios as TS  # noqa: E402
from repro_torch.channel import WirelessChannel as TWirelessChannel  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.mobility import waypoint as TW  # noqa: E402
from repro_torch.scenarios import heterogeneity as TH  # noqa: E402

TRACE_MODELS = ["rwp", "gauss_markov", "manhattan", "hotspot", "static"]
HET = dict(het_dropout=0.2, het_availability=0.7, het_avail_persist=0.3,
           het_compute_mean=1.5)


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _both(**kw):
    return FLConfig(**kw), TFLConfig(**kw)


@pytest.mark.parametrize("speed", [0.0, 12.0], ids=["speed-unset", "speed-12"])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", TRACE_MODELS)
def test_from_config_schedule_equal(name, seed, speed):
    fl, tfl = _both(num_devices=12, rounds=40, mobility_model=name,
                    speed=speed, area=400.0, seed=seed)
    ref = RS.ScenarioProvider.from_config(fl).schedule()
    port = TS.ScenarioProvider.from_config(tfl).schedule()
    _eq(ref, port)
    if name != "static":
        assert port[0].sum() > 0, "degenerate scenario: no contacts"


def _pairs():
    yield "rwp", RS.RandomWaypointModel, TS.RandomWaypointModel, {}
    yield "rwp-mobile-mes", RS.RandomWaypointModel, TS.RandomWaypointModel, \
        dict(mobile_mes=True, pause_max=2.0)
    yield "gauss_markov", RS.GaussMarkovModel, TS.GaussMarkovModel, \
        dict(corr_dist=80.0)
    yield "manhattan", RS.ManhattanGridModel, TS.ManhattanGridModel, \
        dict(block=50.0, p_turn=0.3)
    yield "hotspot", RS.HotspotClusterModel, TS.HotspotClusterModel, \
        dict(num_hotspots=3)
    yield "static", RS.HotspotClusterModel, TS.HotspotClusterModel, \
        dict(mean_speed=0.0)


PAIRS = list(_pairs())


@pytest.mark.parametrize("label,ref_cls,port_cls,extra", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_trace_positions_and_extraction_equal(label, ref_cls, port_cls, extra):
    kw = dict(num_devices=9, area=450.0, seed=5, **extra)
    ref = ref_cls(**kw).trace(300.0, 0.5)
    port = port_cls(**kw).trace(300.0, 0.5)
    _eq((ref.pos, ref.mes), (port.pos, port.mes))
    assert ref.dt == port.dt and port.steps == 600 and port.num_devices == 9
    _eq((ref.distances(), ref.in_range(100.0)),
        (port.distances(), port.in_range(100.0)))
    mask = port.in_range(100.0)
    _eq(RS.contact_intervals(mask, 0.5), TS.contact_intervals(mask, 0.5))
    _eq(RS.rounds_from_trace(ref, 100.0, 25, 12.0)[:2],
        TS.rounds_from_trace(port, 100.0, 25, 12.0)[:2])
    # with a channel: h2 from the trace's positions and the same rng
    ref_s = RS.rounds_from_trace(ref, 100.0, 25, 12.0,
                                 channel=WirelessChannel(seed=2),
                                 rng=np.random.default_rng(7))
    port_s = TS.rounds_from_trace(port, 100.0, 25, 12.0,
                                  channel=TWirelessChannel(seed=2),
                                  rng=np.random.default_rng(7))
    _eq(ref_s, port_s)


@pytest.mark.parametrize("corr", [5.0, 25.0, 1e4])
def test_gains_along_trace_equal(corr):
    rng = np.random.default_rng(4)
    pos = np.cumsum(rng.normal(0, 8.0, (30, 7, 2)), axis=0) + 50.0
    mes = np.full((30, 2), 40.0)
    kw = dict(shadow_corr_dist=corr)
    ref = RS.gains_along_trace(WirelessChannel(carrier_ghz=28.0), pos, mes,
                               seed=3, **kw)
    port = TS.gains_along_trace(TWirelessChannel(carrier_ghz=28.0), pos, mes,
                                seed=3, **kw)
    _eq((ref,), (port,))
    assert np.isfinite(port).all() and (port > 0).all()


@pytest.mark.parametrize("seed", [0, 7])
def test_random_waypoint_and_contact_stats_equal(seed):
    kw = dict(num_devices=10, area=400.0, comm_range=90.0, mean_speed=6.0,
              pause_max=4.0, dt=1.0, seed=seed)
    ref = RW.RandomWaypoint(**kw).simulate(500.0)
    port = TW.RandomWaypoint(**kw).simulate(500.0)
    _eq((ref,), (port,))
    assert port.any()
    for drop in (True, False):
        assert RW.measure_contact_stats(ref, 1.0, drop) \
            == TW.measure_contact_stats(port, 1.0, drop)
    assert TW.measure_contact_stats(port, 1.0, True) \
        != TW.measure_contact_stats(port, 1.0, False)


@pytest.mark.parametrize("kw", [
    dict(availability=0.6, avail_persist=0.5, compute_mean=2.0, dropout=0.3),
    dict(availability=0.9),
    dict(compute_mean=4.0),
    dict(dropout=0.5),
], ids=["all", "availability", "latency", "dropout"])
def test_heterogeneity_draws_and_apply_equal(kw):
    ref = RH.HeterogeneityModel(num_devices=11, seed=4, **kw)
    port = TH.HeterogeneityModel(num_devices=11, seed=4, **kw)
    assert port.enabled() and (port.p_stay_on, port.p_recover) \
        == (ref.p_stay_on, ref.p_recover)
    _eq(ref.draws(50), port.draws(50))
    rng = np.random.default_rng(1)
    zeta = (rng.random((50, 11)) < 0.5).astype(np.int32)
    tau = np.where(zeta, rng.exponential(6.0, (50, 11)), 0.0)
    z_r, t_r, a_r = ref.apply(zeta, tau)
    z_p, t_p, a_p = port.apply(zeta, tau)
    _eq((z_r, t_r), (z_p, t_p))
    assert set(a_p) == set(TH.HET_COUNTER_KEYS) == set(RH.HET_COUNTER_KEYS)
    _eq([a_r[k] for k in RH.HET_COUNTER_KEYS],
        [a_p[k] for k in TH.HET_COUNTER_KEYS])


def test_gate_windows_equals_python_reference():
    rng = np.random.default_rng(0)
    rounds, n = 60, 12
    zeta = (rng.random((rounds, n)) < 0.5).astype(np.int32)
    tau = np.where(zeta, rng.exponential(8.0, (rounds, n)), 0.0) \
        .astype(np.float32)
    avail = rng.random((rounds, n)) < 0.7
    latency = rng.exponential(2.0, (rounds, n)).astype(np.float32)
    drop = rng.random((rounds, n)) < 0.25
    draws = (zeta, tau, avail, latency, drop)
    z_v, t_v, a_v = TH.gate_windows(*draws)
    for z_r, t_r, a_r in (TH.reference_apply(*draws),
                          RH.reference_apply(*draws),
                          RH.gate_windows(*draws)):
        _eq((z_v, t_v, a_v["unavail"], a_v["dropout"]),
            (z_r, t_r, a_r["unavail"], a_r["dropout"]))
    assert a_v["unavail"].sum() > 0 and a_v["dropout"].sum() > 0


@pytest.mark.parametrize("name", ["exponential", "manhattan", "hotspot"])
def test_gated_provider_schedule_and_aux_equal(name):
    fl, tfl = _both(num_devices=10, rounds=60, mobility_model=name,
                    speed=8.0, area=350.0, mean_contact=30.0,
                    mean_intercontact=60.0, seed=2, **HET)
    ref = RS.ScenarioProvider.from_config(fl)
    port = TS.ScenarioProvider.from_config(tfl)
    _eq(ref.schedule(), port.schedule())
    assert set(port.aux) == set(ref.aux)
    for k in ref.aux:
        _eq((ref.aux[k], ref.aux_round(7)[k]),
            (port.aux[k], port.aux_round(7)[k]))
    assert port.aux["unavail"].sum() > 0
    assert port.prefetch() is port and len(port) == 60
    for r, (z, t, h) in enumerate(port):
        _eq((z, t, h), ref.round(r))


def test_from_model_equal():
    ref_m = RS.GaussMarkovModel(num_devices=8, area=300.0, seed=6)
    port_m = TS.GaussMarkovModel(num_devices=8, area=300.0, seed=6)
    _eq(RS.ScenarioProvider.from_model(ref_m, 30, 10.0, seed=4).schedule(),
        TS.ScenarioProvider.from_model(port_m, 30, 10.0, seed=4).schedule())


def test_model_from_config_equal():
    for name in TRACE_MODELS:
        fl, tfl = _both(mobility_model=name, num_devices=5, pause_max=3.0,
                        gm_corr_dist=90.0, street_block=40.0, num_hotspots=2,
                        hotspot_radius=70.0)
        ref, port = RS.model_from_config(fl, 9), TS.model_from_config(tfl, 9)
        assert type(ref).__name__ == type(port).__name__
        assert vars(ref) == vars(port)
    with pytest.raises(KeyError, match="unknown mobility model"):
        TS.model_from_config(TFLConfig(mobility_model="levy"))

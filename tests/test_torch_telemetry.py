"""The port's telemetry against the reference's ``repro.telemetry``.

Shared inputs (metric dicts drawn from a numpy seed, fetched snapshots,
JSONL events) go through both packages.  Histogram bins and integer-valued
fields (counters, the table's count fields, the heterogeneity counters)
are sums of 0/1 weights, so they must be bit-equal; float sums
(``bits_total``, ``energy_total``, the probes' sums) reduce in another
order than XLA's and are held within 1e-6 relative.  Host-side code
(summaries, rows, merges of fetched snapshots, probe reports, reports,
exporters) gets the same snapshot on both sides and must give the same
result.  Whole runs compare the reference's loop engine with the port's
from the reference's initial weights.
"""
import dataclasses
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.telemetry as RT  # noqa: E402
from repro.configs import FLConfig, get_config  # noqa: E402
from repro.core import afl as ref_afl  # noqa: E402
from repro.core import runner  # noqa: E402
from repro.core.runner import run_afl  # noqa: E402
from repro.data import DeviceLoader  # noqa: E402
from repro.launch.train import build_device_data  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
import repro_torch.telemetry as TT  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.runner import run_afl as t_run_afl  # noqa: E402
from repro_torch.data import DeviceLoader as TDeviceLoader  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.telemetry import metrics as TM  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 6
INT_COUNTERS = ("rounds", "contacts", "successes")
FLOAT_COUNTERS = ("bits_total", "energy_total")
TABLE_EXACT = ("contacts", "successes", "failures", "last_contact",
               "staleness_sum", "staleness_max", "unavail", "dropouts")
TABLE_FLOAT = ("tau_sum", "bits_sum", "energy_sum", "e_norm2")
PROBES_EXACT = ("rounds", "contacts", "successes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(rng, n=N, s=26_350):
    """One round's metric dict (numpy f32), shaped as ``afl_round``'s:
    0/1 uploads and successes, integer staleness, k <= s, bits from k."""
    okf = (rng.random(n) < 0.6).astype(np.float32)
    succ = okf * (rng.random(n) < 0.8)
    k = np.floor(rng.uniform(0, s, n) * succ).astype(np.float32)
    u = rng.choice([8.0, 16.0, 32.0])
    return {
        "uploads": okf, "success": succ.astype(np.float32),
        "theta": rng.integers(1, 140, n).astype(np.float32),
        "k": k, "bits": (k * (u + np.log2(s))).astype(np.float32),
        "b": (succ * u).astype(np.float32),
        "energy": (rng.uniform(0, 2, n) * okf).astype(np.float32),
        "x_norm2": rng.exponential(3.0, n).astype(np.float32),
        "e_norm2": rng.exponential(1e-3, n).astype(np.float32),
    }


def _tau(rng, n=N):
    # include the edges themselves (0.5, 1, 2, ...) so right-closed bins
    # are exercised
    return np.where(rng.random(n) < 0.3, rng.choice([0.5, 1.0, 2.0, 8.0], n),
                    rng.exponential(6.0, n)).astype(np.float32)


def _het(rng, n=N):
    return {"unavail": (rng.random(n) < 0.2).astype(np.float32),
            "dropout": (rng.random(n) < 0.1)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def _ref_suite(s=26_350, u=32, n=N):
    return RT.TelemetrySuite(metrics=RT.AFL_REGISTRY, device=RT.DeviceTable(n),
                             probes=RT.TheoryProbes(s=s, u=u))


def _port_suite(s=26_350, u=32, n=N):
    return TT.TelemetrySuite(metrics=TT.AFL_REGISTRY, device=TT.DeviceTable(n),
                             probes=TT.TheoryProbes(s=s, u=u))


def _run_both(seed, rounds=12, het=True):
    """The same ``rounds`` metric dicts through both suites (record_round
    dispatching to the suite, then record_het): fetched snapshots."""
    rng = np.random.default_rng(seed)
    ref, port = _ref_suite(), _port_suite()
    rs, ps = ref.init_state(), port.init_state("cpu")
    for _ in range(rounds):
        m, tau = _metrics(rng), _tau(rng)
        h = _het(rng) if het else None
        rs = RT.record_round(ref, rs, _j(m), jnp.asarray(tau))
        rs = RT.record_het(ref, rs, None if h is None else _j(h))
        ps = TT.record_round(port, ps, _t(m), torch.as_tensor(tau))
        ps = TT.record_het(port, ps, None if h is None else _t(h))
    return ref, port, ref.fetch(rs), port.fetch(ps)


def assert_registry_equal(a, b, float_rtol=1e-6, err=""):
    assert set(a["hist"]) == set(b["hist"])
    for k in a["hist"]:
        np.testing.assert_array_equal(a["hist"][k], b["hist"][k],
                                      err_msg=f"{err} hist {k}")
    for k in INT_COUNTERS:
        assert a["counters"][k] == b["counters"][k], (err, k)
    for k in FLOAT_COUNTERS:
        np.testing.assert_allclose(a["counters"][k], b["counters"][k],
                                   rtol=float_rtol, err_msg=f"{err} {k}")
    assert a["gauges"] == b["gauges"], err


def assert_table_equal(a, b, float_rtol=1e-6, e_norm2_rtol=1e-6, err=""):
    assert set(a) == set(b)
    assert a["rounds"] == b["rounds"]
    for k in TABLE_EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{err} table {k}")
    for k in TABLE_FLOAT:
        np.testing.assert_allclose(
            a[k], b[k], rtol=e_norm2_rtol if k == "e_norm2" else float_rtol,
            atol=1e-9 if k == "e_norm2" else 0, err_msg=f"{err} table {k}")


def assert_probes_equal(a, b, float_rtol=1e-6, atol=None, err=""):
    """``atol``: per-field absolute tolerances that replace ``float_rtol``."""
    assert set(a) == set(b)
    for k in PROBES_EXACT:
        assert a[k] == b[k], (err, k)
    for k in a:
        tol = dict(rtol=0, atol=atol[k]) if k in (atol or {}) \
            else dict(rtol=float_rtol)
        np.testing.assert_allclose(a[k], b[k], err_msg=f"{err} probe {k}",
                                   **tol)


# ---------------------------------------------------------------------------
# registry, table, probes: updates on shared inputs
# ---------------------------------------------------------------------------


def test_histogram_bins_underflow_interior_overflow():
    """The reference's bin edge cases, on both registries: equal bins."""
    specs = dict(counters=("n",), gauges=("r",),
                 histograms=(("h", (1.0, 2.0, 4.0)),))
    regs = {}
    for name, P in (("ref", RT), ("port", TT)):
        regs[name] = P.MetricRegistry(
            counters=tuple(P.Counter(c) for c in specs["counters"]),
            gauges=tuple(P.Gauge(g) for g in specs["gauges"]),
            histograms=tuple(P.Histogram(h, edges=e)
                             for h, e in specs["histograms"]))
    vals = np.asarray([0.5, 1.0, 1.5, 3.0, 4.0, 9.0], np.float32)
    mask = np.asarray([0., 1., 0., 1., 0., 1.], np.float32)
    out = {}
    for name, reg in regs.items():
        arr = jnp.asarray if name == "ref" else torch.as_tensor
        s = reg.init_state()
        s = reg.update(s, counters={"n": 6.0}, gauges={"r": 1.0},
                       hists={"h": (arr(vals), arr(np.ones_like(vals)))})
        first = np.asarray(reg.fetch(s)["hist"]["h"])
        s = reg.update(s, hists={"h": (arr(vals), arr(mask))})
        out[name] = (first, reg.fetch(s))
        with pytest.raises(KeyError):
            reg.update(s, hists={"nope": (arr(vals), arr(vals))})
    for name in ("ref", "port"):
        first, snap = out[name]
        np.testing.assert_array_equal(first, [1.0, 2.0, 1.0, 2.0])
        np.testing.assert_array_equal(snap["hist"]["h"], [1.0, 3.0, 2.0, 3.0])
        assert snap["counters"]["n"] == 6.0 and snap["gauges"]["r"] == 1.0
    assert out["port"][1]["hist"]["h"].dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_round_matches_reference(seed):
    """The AFL registry, the per-device table (with update_het) and the
    probes, fed the same 12 rounds: bins and integer fields bit-equal,
    float fields within 1e-6 relative; the host types are the reference's."""
    ref, port, a, b = _run_both(seed)
    assert_registry_equal(a["metrics"], b["metrics"])
    assert_table_equal(a["device"], b["device"])
    assert_probes_equal(a["probes"], b["probes"])
    assert b["metrics"]["counters"]["contacts"] > 0
    assert b["device"]["unavail"].sum() > 0 and b["device"]["dropouts"].sum() > 0
    for k, v in a["metrics"]["hist"].items():
        assert type(b["metrics"]["hist"][k]) is type(v)
        assert b["metrics"]["hist"][k].dtype == v.dtype
    assert all(type(b["metrics"]["counters"][k]) is float
               for k in b["metrics"]["counters"])
    assert type(b["device"]["rounds"]) is float
    assert all(type(v) is float for v in b["probes"].values())


def test_plain_registry_and_partial_suites_match_reference():
    """The registry alone (no suite), a suite without probes and a
    suite without a table: record_het is an identity where nothing holds
    per-client counters, as in the reference."""
    rng = np.random.default_rng(4)
    pairs = [(RT.AFL_REGISTRY, TT.AFL_REGISTRY),
             (RT.TelemetrySuite(metrics=RT.AFL_REGISTRY,
                                device=RT.DeviceTable(N)),
              TT.TelemetrySuite(metrics=TT.AFL_REGISTRY,
                                device=TT.DeviceTable(N))),
             (RT.TelemetrySuite(metrics=RT.AFL_REGISTRY,
                                probes=RT.TheoryProbes(s=26_350)),
              TT.TelemetrySuite(metrics=TT.AFL_REGISTRY,
                                probes=TT.TheoryProbes(s=26_350)))]
    states = [(r.init_state(), p.init_state()) for r, p in pairs]
    for _ in range(5):
        m, tau, h = _metrics(rng), _tau(rng), _het(rng)
        for i, (r, p) in enumerate(pairs):
            rs, ps = states[i]
            rs = RT.record_het(r, RT.record_round(r, rs, _j(m),
                                                  jnp.asarray(tau)), _j(h))
            ps = TT.record_het(p, TT.record_round(p, ps, _t(m),
                                                  torch.as_tensor(tau)), _t(h))
            states[i] = (rs, ps)
    a, b = pairs[0][0].fetch(states[0][0]), pairs[0][1].fetch(states[0][1])
    assert_registry_equal(a, b)
    a, b = pairs[1][0].fetch(states[1][0]), pairs[1][1].fetch(states[1][1])
    assert set(a) == set(b) == {"metrics", "device"}
    assert_table_equal(a["device"], b["device"])
    a, b = pairs[2][0].fetch(states[2][0]), pairs[2][1].fetch(states[2][1])
    assert set(a) == set(b) == {"metrics", "probes"}
    assert_probes_equal(a["probes"], b["probes"])


def test_record_ingest_matches_reference():
    """The serve registry's ingest record (pure code; no serve path calls
    it yet): bins and integer counters bit-equal."""
    rng = np.random.default_rng(9)
    rs, ps = RT.SERVE_REGISTRY.init_state(), TT.SERVE_REGISTRY.init_state()
    for _ in range(9):
        b = 8
        mask = (rng.random(b) < 0.7).astype(np.float32)
        dtau = rng.integers(0, 100, b).astype(np.float32)
        bits = (rng.uniform(1e3, 1e8, b) * mask).astype(np.float32)
        w = (mask * rng.uniform(0.1, 1.0, b)).astype(np.float32)
        rs = RT.record_ingest(RT.SERVE_REGISTRY, rs, mask=jnp.asarray(mask),
                              dtau=jnp.asarray(dtau), bits=jnp.asarray(bits),
                              weights=jnp.asarray(w))
        ps = TT.record_ingest(TT.SERVE_REGISTRY, ps, mask=torch.as_tensor(mask),
                              dtau=torch.as_tensor(dtau),
                              bits=torch.as_tensor(bits),
                              weights=torch.as_tensor(w))
    a, b = RT.SERVE_REGISTRY.fetch(rs), TT.SERVE_REGISTRY.fetch(ps)
    for k in a["hist"]:
        np.testing.assert_array_equal(a["hist"][k], b["hist"][k], err_msg=k)
    for k in ("batches", "ingested", "received", "accepted"):
        assert a["counters"][k] == b["counters"][k], k
    for k in ("bits_ingested", "weight_sum"):
        np.testing.assert_allclose(a["counters"][k], b["counters"][k],
                                   rtol=1e-6)
    assert a["gauges"] == b["gauges"]
    assert RT.SERVE_REGISTRY.summary(a) == TT.SERVE_REGISTRY.summary(a)


def test_registry_specs_equal_reference():
    """The built-in registries: the same counters, gauges and edges."""
    for r, p in ((RT.AFL_REGISTRY, TT.AFL_REGISTRY),
                 (RT.SERVE_REGISTRY, TT.SERVE_REGISTRY),
                 (RT.afl_registry(), TT.afl_registry()),
                 (RT.serve_registry(), TT.serve_registry())):
        assert [dataclasses.astuple(c) for c in r.counters] == \
            [dataclasses.astuple(c) for c in p.counters]
        assert [dataclasses.astuple(g) for g in r.gauges] == \
            [dataclasses.astuple(g) for g in p.gauges]
        assert [dataclasses.astuple(h) for h in r.histograms] == \
            [dataclasses.astuple(h) for h in p.histograms]
    assert TT.HIST_KEYS == RT.HIST_KEYS
    from repro_torch.core import runner as t_runner

    assert t_runner.HIST_KEYS is TM.HIST_KEYS
    from repro_torch.telemetry import perdevice, probes

    assert perdevice.FIELD_KIND == RT.perdevice.FIELD_KIND
    assert perdevice.DEVICE_FIELDS == RT.perdevice.DEVICE_FIELDS
    assert probes.PROBE_FIELDS == RT.probes.PROBE_FIELDS
    assert sorted(TT.__all__) == sorted(set(RT.__all__) - {"jit_record"})


# ---------------------------------------------------------------------------
# host side: summaries, rows, merges, reports
# ---------------------------------------------------------------------------


def test_summaries_and_hist_stats_match_reference():
    ref, port, a, b = _run_both(5)
    for name in ("staleness", "contact_tau", "bits", "k", "b"):
        assert (TT.AFL_REGISTRY.hist_stats(name, b["metrics"]["hist"][name])
                == RT.AFL_REGISTRY.hist_stats(name, b["metrics"]["hist"][name]))
    empty = np.zeros(TT.AFL_REGISTRY._hist("k").num_bins)
    assert TT.AFL_REGISTRY.hist_stats("k", empty)["count"] == 0.0
    assert port.summary(b) == ref.summary(b)
    assert TT.AFL_REGISTRY.summary(b["metrics"]) == \
        RT.AFL_REGISTRY.summary(b["metrics"])
    assert port.device.summary(b["device"], k=3) == \
        ref.device.summary(b["device"], k=3)


def test_rows_stragglers_and_gini_match_reference():
    from repro.telemetry import perdevice as RP
    from repro_torch.telemetry import perdevice as TP

    _, _, _, b = _run_both(6)
    snap = b["device"]
    assert TP.rows(snap) == RP.rows(snap)
    for field in ("contacts", "staleness_mean", "bits_sum", "unavail"):
        for largest in (True, False):
            assert TT.top_by(snap, field, k=3, largest=largest) == \
                RT.top_by(snap, field, k=3, largest=largest)
    assert TT.top_stragglers(snap, k=4) == RT.top_stragglers(snap, k=4)
    assert TT.participation_gini(snap) == RT.participation_gini(snap)
    assert TT.participation_gini(dict(snap, contacts=np.zeros(N))) == 0.0
    # the reference test's hand-made table, archived without het counters
    old = {k: v for k, v in snap.items() if k not in ("unavail", "dropouts")}
    assert TP.rows(old) == RP.rows(old)
    assert TT.table_to_jsonable(snap) == RT.table_to_jsonable(snap)
    assert TT.table_to_jsonable(None) is None


def _stack(states):
    """Stack a list of equal-keyed (nested) states on a new leading axis."""
    if isinstance(states[0], dict):
        return {k: _stack([x[k] for x in states]) for k in states[0]}
    return torch.stack(states)


def test_merges_match_reference():
    """merge / merge_stacked on device states (port) against the
    reference's, and merge_fetched on fetched snapshots: registry, table,
    probes and the suite, associative and order-free."""
    rng = np.random.default_rng(11)
    ref, port = _ref_suite(), _port_suite()
    rstates, pstates = [], []
    for _ in range(3):
        rs, ps = ref.init_state(), port.init_state()
        for _ in range(4):
            m, tau, h = _metrics(rng), _tau(rng), _het(rng)
            rs = RT.record_het(ref, RT.record_round(ref, rs, _j(m),
                                                    jnp.asarray(tau)), _j(h))
            ps = TT.record_het(port, TT.record_round(port, ps, _t(m),
                                                     torch.as_tensor(tau)),
                               _t(h))
        rstates.append(rs)
        pstates.append(ps)
    a, b, c = pstates
    left = port.fetch(port.merge(port.merge(a, b), c))
    right = port.fetch(port.merge(a, port.merge(b, c)))
    stacked = port.fetch(port.merge_stacked(_stack(pstates)))
    ra, rb, rc = rstates
    rleft = ref.fetch(ref.merge(ref.merge(ra, rb), rc))
    for snap in (right, stacked, rleft):
        assert_registry_equal(left["metrics"], snap["metrics"])
        assert_table_equal(left["device"], snap["device"])
        assert_probes_equal(left["probes"], snap["probes"])
    fetched = [port.fetch(s) for s in pstates]
    assert_registry_equal(TT.merge_fetched(fetched)["metrics"],
                          RT.merge_fetched(fetched)["metrics"], float_rtol=0)
    for x, y in ((TT.merge_fetched(fetched), RT.merge_fetched(fetched)),
                 (TT.merge_fetched([f["metrics"] for f in fetched]),
                  {"metrics": RT.merge_fetched([f["metrics"]
                                                for f in fetched])})):
        if "device" in y:
            assert x["device"].keys() == y["device"].keys()
            for k in y["device"]:
                np.testing.assert_array_equal(x["device"][k], y["device"][k])
            assert x["probes"] == y["probes"]
        np.testing.assert_equal(x.get("metrics", x), y["metrics"])
    with pytest.raises(ValueError):
        TT.merge_fetched([])
    # the JSONL mirror: to_jsonable of a merged suite snapshot
    merged = TT.merge_fetched(fetched)
    assert TT.to_jsonable(merged) == RT.to_jsonable(merged)
    assert TT.to_jsonable(fetched[0]) == RT.to_jsonable(fetched[0])


def test_probe_report_matches_reference():
    """report / report_from_config / summary / measured on one fetched
    snapshot: equal dicts and text (host numpy on both sides)."""
    _, port, _, b = _run_both(7)
    snap = b["probes"]
    rp = RT.TheoryProbes(s=26_350, u=32)
    kw = dict(c=6.0, lam=30.0, delta=10.0, n=N)
    assert port.probes.report(snap, **kw) == rp.report(snap, **kw)
    assert port.probes.report(snap, rate=5e4, **kw) == \
        rp.report(snap, rate=5e4, **kw)
    assert port.probes.measured(snap) == rp.measured(snap)
    rep = port.probes.report(snap, **kw)
    assert port.probes.summary(rep) == rp.summary(rep)
    for fl_kw in (dict(mean_contact=6.0, mean_intercontact=30.0),
                  dict(speed=12.0, contact_const=40.0,
                       intercontact_const=300.0)):
        fl, tfl = FLConfig(num_devices=N, **fl_kw), TFLConfig(num_devices=N,
                                                             **fl_kw)
        assert TT.contact_params(tfl) == RT.contact_params(fl)
        assert TT.report_from_config(port.probes, snap, tfl) == \
            RT.report_from_config(rp, snap, fl)
    assert TT.probes_to_jsonable(snap) == RT.probes_to_jsonable(snap)
    assert TT.probes_to_jsonable(None) is None


def test_probes_calibrated_synthetic():
    """The reference's calibration run on the port's probes: a synthetic
    run drawn from the theory's generative model (tau ~ Exp(c),
    Proposition-1 spend) lands on the closed forms."""
    from repro_torch.core import theory

    s, u, c, lam, delta, rate = 4096, 16, 6.0, 30.0, 10.0, 50.0
    n_dev, n_rounds = 64, 400
    probes = TT.TheoryProbes(s=s, u=u)
    state = probes.init_state()
    rng = np.random.default_rng(7)
    since = np.zeros(n_dev)
    bitcost = u + np.log2(s)
    p_contact = 1.0 - np.exp(-delta / lam)
    for _ in range(n_rounds):
        okf = (rng.random(n_dev) < p_contact).astype(np.float32)
        tau = rng.exponential(c, n_dev).astype(np.float32) * okf
        k = np.minimum(tau * rate / bitcost, s)
        succ = okf * (k >= 1.0)
        m = {"uploads": okf, "success": succ, "theta": since,
             "k": k, "bits": tau * rate * (k >= 1.0),
             "energy": np.zeros(n_dev), "x_norm2": np.ones(n_dev)}
        state = probes.update(state, _t(m), torch.as_tensor(tau))
        since = np.where(succ > 0, 0.0, since + 1.0)
    rep = probes.report(probes.fetch(state), c=c, lam=lam, delta=delta,
                        rate=rate, n=n_dev)
    t = rep["terms"]
    assert abs(t["success_rate"]["delta"]) < 0.03
    assert t["success_rate"]["expected"] == pytest.approx(
        theory.gamma(rate, c, s, u))
    assert abs(t["error_fraction"]["delta"]) < 0.05
    th = t["staleness_second_moment"]
    assert 0.3 < (th["measured"] + 1.0) / th["expected"] < 3.0
    assert rep["measured"]["mean_rate"] == pytest.approx(rate, rel=1e-4)
    assert np.isfinite(rep["theorem1"]["total"])


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def _schema(events):
    return [(e["name"], sorted(e)) for e in events]


def test_tracer_spans_fence_and_events_match_reference():
    """The same span program on both tracers: the same events (names,
    keys, parent/depth/error) and totals; fence passes host data and CPU
    tensors through."""
    out = {}
    for name, P, arr in (("ref", RT, jnp.ones), ("port", TT, torch.ones)):
        tracer = P.PhaseTracer()
        with tracer.span("compile"):
            pass
        for _ in range(3):
            with tracer.span("execute", r=1):
                y = tracer.fence(arr(4) * 2)
                assert tracer.fence({"host": [1, 2]}) == {"host": [1, 2]}
        with tracer.span("outer"):
            with tracer.span("inner"):
                pass
            with pytest.raises(ValueError):
                with tracer.span("broken"):
                    raise ValueError("boom")
        with tracer.span("after"):
            pass
        tracer.start()  # no profile_dir: no-ops
        tracer.stop()
        out[name] = tracer
    assert float(y.sum()) == 8.0
    ev_r, ev_p = out["ref"].events(), out["port"].events()
    assert _schema(ev_p) == _schema(ev_r)
    ev = {e["name"]: e for e in ev_p}
    assert ev["inner"]["parent"] == "outer" and ev["inner"]["depth"] == 1
    assert ev["broken"]["error"] == "ValueError" and "error" not in ev["inner"]
    assert "parent" not in ev["after"] and ev["execute"]["r"] == 1
    tot_r, tot_p = out["ref"].totals(), out["port"].totals()
    assert {k: v["count"] for k, v in tot_p.items()} == \
        {k: v["count"] for k, v in tot_r.items()}
    assert out["port"].summary().splitlines()[0] == \
        out["ref"].summary().splitlines()[0]
    assert out["port"]._stack == [] and out["port"].trace_path is None
    json.dumps(ev_p)


def test_tracer_profile_dir_writes_a_chrome_trace(tmp_path):
    """With profile_dir the spans are profiler ranges: stop() exports a
    Chrome trace holding them (CPU activity here; the card's kernels join
    on CUDA, tests/test_torch_cuda.py)."""
    tracer = TT.PhaseTracer(profile_dir=str(tmp_path / "prof"))
    tracer.start()
    with tracer.span("compile"):
        torch.ones(8).sum()
    with tracer.span("execute"):
        torch.ones(8).mul(2)
    tracer.stop()
    assert tracer.trace_path == str(tmp_path / "prof" / "trace.json")
    trace = json.loads(open(tracer.trace_path).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"compile", "execute"} <= names
    tracer.stop()  # a second stop is a no-op
    assert [s.name for s in tracer.spans] == ["compile", "execute"]


# ---------------------------------------------------------------------------
# exporters and reports
# ---------------------------------------------------------------------------


def test_jsonl_sink_roundtrip_and_sanitize(tmp_path, caplog):
    """write -> read -> merge, NaN/inf to null with a warning, eager
    validation: the same file as the reference's sink writes."""
    _, _, _, b = _run_both(8)
    rec = {"kind": "metrics", **TT.to_jsonable(b)}
    bad = {"kind": "x", "ok": 1.5, "bad": float("nan"),
           "worse": [float("inf"), 2.0], "nested": {"neg": float("-inf")}}
    paths = {}
    for name, P in (("ref", RT), ("port", TT)):
        path = tmp_path / f"{name}.jsonl"
        logger = ("repro_torch" if name == "port" else "repro") \
            + ".telemetry.export"
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            with P.JsonlSink(str(path)) as sink:
                sink.emit(rec)
                sink.extend([rec, bad])
                with pytest.raises(TypeError):
                    sink.emit({"bad": object()})
        assert "sanitized 3 non-finite" in caplog.text
        paths[name] = path
    assert paths["ref"].read_text() == paths["port"].read_text()
    loaded = TT.read_jsonl(str(paths["port"]))
    assert loaded == RT.read_jsonl(str(paths["port"]))
    assert loaded[2]["bad"] is None and loaded[2]["worse"] == [None, 2.0]
    assert TT.sanitize(bad) == RT.sanitize(bad)
    merged = TT.merge_fetched([loaded[0], loaded[1]])
    assert merged["metrics"]["counters"]["rounds"] == \
        2 * b["metrics"]["counters"]["rounds"]
    np.testing.assert_array_equal(merged["device"]["contacts"],
                                  2.0 * b["device"]["contacts"])


def test_bench_export_passes_bench_compare(tmp_path):
    """A port-written BENCH_<suite>.json has the reference's schema and
    trajectory, and tools/bench_compare.py gates it unchanged."""
    rows = ["afl_loop_n20,112000.0,rounds_per_s=8.757",
            "afl_loop_lanegcn_n20,9500.0,rounds_per_s=104.67;busy=0.2x"]
    assert [TT.parse_csv_row(r) for r in rows] == \
        [RT.parse_csv_row(r) for r in rows]
    base, out = tmp_path / "base", tmp_path / "out"
    p_base = TT.export_bench("afl", rows, out_dir=str(base), meta={"a": 1})
    r_path = RT.export_bench("afl", rows, out_dir=str(tmp_path / "ref"),
                             meta={"a": 1})
    assert TT.load_bench(p_base) == RT.load_bench(r_path)
    p = TT.export_bench("afl", rows, out_dir=str(out))
    TT.export_bench("afl", rows, out_dir=str(out))
    assert len(TT.load_bench(p)["history"]) == 1
    script = os.path.join(ROOT, "tools", "bench_compare.py")
    ok = subprocess.run([sys.executable, script, p_base, p, "--check"],
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    TT.export_bench("afl", ["afl_loop_n20,112000.0,rounds_per_s=4.0",
                            rows[1]], out_dir=str(out))
    bad = subprocess.run([sys.executable, script, p_base, p, "--check"],
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1 and "REGRESSED" in bad.stdout


def test_train_cli_telemetry_records_and_report(tmp_path):
    """``--telemetry --perdevice --probes`` on the CPU writes
    telemetry.jsonl with the reference's record kinds and keys; the port's
    render_report and the reference's give the same text, and the report
    CLI writes it."""
    wd = tmp_path / "w"
    res = t_train.main(["--device", "cpu", "--width", "4", "--devices", "4",
                        "--rounds", "3", "--eval-every", "1", "--batch-size",
                        "8", "--train-n", "64", "--intercontact", "20",
                        "--telemetry", "--perdevice", "--probes",
                        "--workdir", str(wd)])
    events = TT.read_jsonl(str(wd / "telemetry.jsonl"))
    kinds = [e["kind"] for e in events]
    assert kinds == ["span"] * 6 + ["metrics", "probe_report"]
    assert [e["name"] for e in events[:6]] == \
        ["compile", "eval", "execute", "eval", "execute", "eval"]
    # the reference's keys: its suite's zero snapshot and probe report
    ref_suite = _ref_suite(s=res.state.w.numel(), n=4)
    ref_snap = RT.to_jsonable(ref_suite.fetch(ref_suite.init_state()))
    metrics = events[-2]
    assert set(metrics) - {"kind"} == set(ref_snap)
    for sec in ref_snap:
        assert set(metrics[sec]) == set(ref_snap[sec]), sec
    assert set(metrics["metrics"]["counters"]) == \
        set(ref_snap["metrics"]["counters"])
    assert metrics["metrics"]["counters"]["rounds"] == 3.0
    ref_rep = RT.report_from_config(ref_suite.probes,
                                    ref_suite.fetch(
                                        ref_suite.init_state())["probes"],
                                    FLConfig(num_devices=4))
    assert set(events[-1]) - {"kind"} == set(ref_rep)
    assert set(events[-1]["terms"]) == set(ref_rep["terms"])
    assert set(events[-1]["theorem1"]) == set(ref_rep["theorem1"])
    assert res.telemetry["metrics"]["counters"]["successes"] == \
        res.history["uploads"][-1]
    text = TT.render_report(events, title="T")
    assert text == RT.render_report(events, title="T")
    for section in ("## Phase breakdown", "## Federation counters",
                    "## Distributions", "## Stragglers",
                    "## Theory vs measured"):
        assert section in text
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.report",
         str(wd / "telemetry.jsonl"), "--title", "T"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "RuntimeWarning" not in out.stderr
    assert (wd / "report.md").read_text() == text


def test_train_cli_without_telemetry_writes_spans_only(tmp_path):
    wd = tmp_path / "w"
    res = t_train.main(["--device", "cpu", "--width", "4", "--devices", "4",
                        "--rounds", "2", "--eval-every", "2", "--batch-size",
                        "8", "--train-n", "64", "--workdir", str(wd)])
    assert res.telemetry is None
    events = TT.read_jsonl(str(wd / "telemetry.jsonl"))
    assert [e["name"] for e in events] == ["compile", "execute", "eval"]
    assert "## Federation counters" not in TT.render_report(events)


# ---------------------------------------------------------------------------
# whole runs: the reference's loop engine against the port's
# ---------------------------------------------------------------------------

RUN_N, RUN_ROUNDS = 4, 6
JIT_INIT = jax.jit(ref_afl.afl_init, static_argnums=(0, 1, 2))
SCENARIOS = {
    "exponential": dict(mean_intercontact=20.0),
    "manhattan-het": dict(mobility_model="manhattan", speed=15.0, area=300.0,
                          het_dropout=0.2, het_availability=0.8,
                          het_avail_persist=0.3, het_compute_mean=1.0),
}
# float fields of whole runs: x_norm2 and the MADS power agree to 1e-4
# (test_torch_afl.py::test_one_round_matches_reference), and a realised k
# may move by up to 2 of ~26k coordinates (7.6e-5 of the bits); the
# error-fraction sum, a sum of (s - k)/s near 0, then moves by up to 2/s
# per upload, an absolute bound
RUN_RTOL = 1e-4
K_MOVE = 2


@pytest.fixture(scope="module")
def run_setup():
    cfg = get_config("resnet9-cifar10").replace(d_model=4)
    model = build_model(cfg)
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    kw = dict(num_devices=RUN_N, rounds=RUN_ROUNDS, batch_size=4)
    state = JIT_INIT(model, cfg, FLConfig(**kw), jax.random.key(0))
    w_np = jax.tree.map(np.asarray, state.w)
    return cfg, model, tmodel, kw, w_np


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_whole_run_telemetry_matches_reference(run_setup, scenario,
                                               monkeypatch):
    """Six loop-engine rounds of ``mads`` with the full suite (registry,
    per-device table, probes) from the same weights, data and schedule.

    Contacts, successes, the staleness and contact_tau bins and the
    table's contact fields are equal (the schedule and the upload
    decisions are shared); under Manhattan + heterogeneity so are the
    table's ``unavail`` and ``dropouts``.  The ``k``, ``bits`` and ``b``
    bins are equal wherever the run's realised k are: gradients round
    differently in the two packages, so a k may move by a coordinate
    (ROADMAP queue 3) and cross a bin edge; the bins then still hold the
    same number of uploads.  Float fields within RUN_RTOL; e_norm2 within
    the reference's own cross-engine tolerance (rtol 0.5), the probes'
    error-fraction sum within K_MOVE / s per upload.
    """
    cfg, model, tmodel, kw, w_np = run_setup
    fl = FLConfig(**kw, **SCENARIOS[scenario])
    tfl = TFLConfig(**kw, **SCENARIOS[scenario])
    monkeypatch.setattr(runner, "afl_init", JIT_INIT)
    s = model.num_params()
    dev, ev = build_device_data(cfg, fl, train_n=64, eval_n=64, seed=0)
    ref = run_afl(model, cfg, fl, "mads", DeviceLoader(dev, 4, 0), ev,
                  rounds=RUN_ROUNDS, eval_every=1, engine="loop",
                  telemetry=_ref_suite(s=s, u=fl.value_bits, n=RUN_N))
    port = t_run_afl(tmodel, tmodel.cfg, tfl, "mads", TDeviceLoader(dev, 4, 0),
                     ev, rounds=RUN_ROUNDS, eval_every=1, device="cpu",
                     params=load_params(tmodel, w_np),
                     telemetry=_port_suite(s=s, u=tfl.value_bits, n=RUN_N))
    a, b = ref.telemetry, port.telemetry
    am, bm = a["metrics"], b["metrics"]
    for k in INT_COUNTERS:
        assert am["counters"][k] == bm["counters"][k], k
    assert bm["counters"]["contacts"] > 0
    assert am["gauges"] == bm["gauges"]
    for k in ("staleness", "contact_tau"):
        np.testing.assert_array_equal(am["hist"][k], bm["hist"][k], err_msg=k)
    same_k = ref.history["k_mean"] == port.history["k_mean"]
    for k in ("k", "bits", "b"):
        assert am["hist"][k].sum() == bm["hist"][k].sum() == \
            bm["counters"]["successes"]
        if same_k:
            np.testing.assert_array_equal(am["hist"][k], bm["hist"][k],
                                          err_msg=k)
    for k in FLOAT_COUNTERS:
        np.testing.assert_allclose(am["counters"][k], bm["counters"][k],
                                   rtol=RUN_RTOL, err_msg=k)
    ad, bd = a["device"], b["device"]
    for k in TABLE_EXACT:
        np.testing.assert_array_equal(ad[k], bd[k], err_msg=k)
    if scenario == "manhattan-het":
        assert bd["unavail"].sum() + bd["dropouts"].sum() > 0
    assert_table_equal(ad, bd, float_rtol=RUN_RTOL, e_norm2_rtol=0.5)
    assert_probes_equal(
        a["probes"], b["probes"], float_rtol=RUN_RTOL,
        atol={"err_frac_sum": K_MOVE * bm["counters"]["successes"] / s})
    assert bd["successes"].sum() == bm["counters"]["successes"] == \
        port.history["uploads"][-1]

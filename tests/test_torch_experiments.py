"""The port's whole-run engine, seed batching, grids, results store and
sweep CLI against the loop engine and the JAX reference's ``experiments``.

On the CPU the whole-run engine runs the same round as on the card,
eagerly, on the same device-side inputs; its final state must equal the
loop engine's bit for bit on the same batches (a DataShard's draws, or
prestacked DeviceLoader draws), and its history, whose totals it carries
in f32 where the loop sums in Python floats, within the reference's own
cross-engine tolerance (rtol 2e-4, atol 1e-5, tests/test_experiments.py).
Against the reference, runs start from the reference's weights with the
same prestacked DeviceLoader draws and are held as the loop engine is
(tests/test_torch_afl.py: eval within 0.02, uploads equal).  The
DataShard's own sampler is a counter hash, not ``jax.random``, so it is
held to its definition here, not to the reference's draws.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.experiments.scan_engine as ref_scan  # noqa: E402
from repro.configs import FLConfig  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import baselines as BL  # noqa: E402
from repro.core.afl import afl_init  # noqa: E402
from repro.data import DeviceLoader  # noqa: E402
from repro.experiments import ExperimentGrid, ResultsStore, mean_ci  # noqa: E402
from repro.experiments.grid import engine_fl, engine_policy  # noqa: E402
from repro.launch.train import build_device_data  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro_torch.compression import quant as TQ  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import baselines as TBL  # noqa: E402
from repro_torch.core.runner import run_afl as t_run_afl  # noqa: E402
from repro_torch.data import DeviceLoader as TDeviceLoader  # noqa: E402
from repro_torch.experiments import DataShard  # noqa: E402
from repro_torch.experiments import ExperimentGrid as TExperimentGrid  # noqa: E402
from repro_torch.experiments import ResultsStore as TResultsStore  # noqa: E402
from repro_torch.experiments import mean_ci as t_mean_ci  # noqa: E402
from repro_torch.experiments import prestack_batches  # noqa: E402
from repro_torch.experiments import run_afl_scanned  # noqa: E402
from repro_torch.experiments import run_seed_batch  # noqa: E402
from repro_torch.experiments.grid import engine_fl as t_engine_fl  # noqa: E402
from repro_torch.experiments.grid import engine_policy as t_engine_policy  # noqa: E402
from repro_torch.experiments.scan_engine import eval_points as t_eval_points  # noqa: E402
from repro_torch.launch import sweep as t_sweep  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.telemetry import (AFL_REGISTRY, DeviceTable,  # noqa: E402
                                   TelemetrySuite, TheoryProbes, read_jsonl,
                                   to_jsonable)

ROUNDS, EVERY, N = 8, 4, 4
FL_KW = dict(num_devices=N, rounds=ROUNDS, batch_size=8, learning_rate=0.02,
             mean_contact=6.0, mean_intercontact=30.0,
             energy_budget=(40.0, 80.0))
STATE_FIELDS = ("w", "w_n", "g_n", "e_n", "kappa", "q", "energy")
JIT_INIT = jax.jit(afl_init, static_argnums=(0, 1, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes: torch's intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fed():
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    fl = TFLConfig(**FL_KW)
    dev, ev = build_device_data(get_config("resnet9-cifar10").replace(
        d_model=4), FLConfig(**FL_KW), train_n=160, eval_n=64, seed=0)
    return tmodel, fl, dev, ev


def _assert_hist_close(a: dict, b: dict):
    assert a["round"] == b["round"]
    for k in a:
        np.testing.assert_allclose(
            np.asarray(a[k]), np.asarray(b[k]), rtol=2e-4, atol=1e-5,
            err_msg=f"history key {k!r} diverged")


def _assert_state_equal(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.rnd == b.rnd == ROUNDS


# ---------------------------------------------------------------------------
# grid, results store, eval points: pure code equal to the reference's
# ---------------------------------------------------------------------------


def _grids(**kw):
    return ExperimentGrid(**kw), TExperimentGrid(**kw)


@pytest.mark.parametrize("kw", [
    dict(policies=("mads", "afl", "fedmobile"), speeds=(5.0, 20.0),
         seeds=(0, 1, 2), rounds=10),
    dict(policies=("mads-joint", "qsgd"), mobility_models=("rwp", "hotspot"),
         dropouts=(0.0, 0.8), seeds=(3,), rounds=7, eval_every=3),
], ids=["speeds", "dropouts"])
def test_grid_matches_reference(kw):
    ref, port = _grids(**kw)
    assert port.size() == ref.size() == len(port.cells())
    assert [c.key for c in port.cells()] == [c.key for c in ref.cells()]
    assert [dataclasses.asdict(c) for c in port.cells()] == \
        [dataclasses.asdict(c) for c in ref.cells()]
    rg, pg = ref.groups(), port.groups()
    assert [g[:4] for g in pg] == [g[:4] for g in rg]
    assert [[c.group_key for c in g[4]] for g in pg] == \
        [[c.group_key for c in g[4]] for g in rg]
    for m in port.mobility_models:
        for d in port.dropouts:
            a, b = ref.fl_for(m, 20.0, d), port.fl_for(m, 20.0, d)
            assert (a.mobility_model, a.speed, a.het_dropout, a.rounds) == \
                (b.mobility_model, b.speed, b.het_dropout, b.rounds)


def test_engine_projections_match_reference():
    """engine_fl keeps the reference's fields; engine_policy strips only
    the name, so afl and fedmobile share a round and mads does not."""
    fl = FLConfig(speed=7.0, mobility_model="rwp", het_dropout=0.3, seed=4)
    tfl = TFLConfig(speed=7.0, mobility_model="rwp", het_dropout=0.3, seed=4)
    assert dataclasses.asdict(t_engine_fl(tfl)) == {
        k: v for k, v in dataclasses.asdict(engine_fl(fl)).items()
        if k in dataclasses.asdict(t_engine_fl(tfl))}
    assert t_engine_fl(tfl) == t_engine_fl(dataclasses.replace(
        tfl, speed=20.0, mobility_model="manhattan", het_dropout=0.0))
    s = 1000
    for ref_eq, (p, q) in ((True, ("afl", "fedmobile")),
                           (False, ("afl", "mads"))):
        port = t_engine_policy(TBL.ALL[p](s, tfl)) == \
            t_engine_policy(TBL.ALL[q](s, tfl))
        ref = engine_policy(BL.ALL[p](s, fl)) == engine_policy(BL.ALL[q](s, fl))
        assert port == ref == ref_eq
        assert t_engine_policy(TBL.ALL[p](s, tfl)).name == ""
    with pytest.raises(KeyError):
        TExperimentGrid(policies=("nope",))


@pytest.mark.parametrize("values", [[1.0, 1.0, 1.0], [0.0, 1.0], [2.0], [],
                                    [0.3, 0.5, 0.9, 0.1]])
def test_mean_ci_matches_reference(values):
    a, b = t_mean_ci(values), mean_ci(values)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t_mean_ci(values, 0.99) == pytest.approx(mean_ci(values, 0.99),
                                                    nan_ok=True)


@pytest.mark.parametrize("rounds,every", [(8, 4), (10, 4), (3, 20), (1, 1)])
def test_eval_points_match_reference(rounds, every):
    assert t_eval_points(rounds, every) == ref_scan.eval_points(rounds, every)


def test_results_store_resumes_and_reference_reads_it(tmp_path):
    kw = dict(policies=("mads", "afl"), speeds=(5.0,), seeds=(0, 1),
              rounds=4, eval_every=2)
    ref_grid, grid = _grids(**kw)
    store = TResultsStore(str(tmp_path))
    cells = grid.cells()
    hist = {"round": [2, 4], "eval": [0.5, 0.7], "uploads": [1.0, 3.0],
            "k_mean": [10.0, 12.0], "energy": [1.0, 2.0],
            "theta_mean": [1.0, 1.5], "power_mean": [0.1, 0.1],
            "bits_mean": [64.0, 96.0]}
    store.save(cells[0], hist, meta={"arch": "tiny"})
    store.save(cells[2], dict(hist, eval=[0.2, 0.4]))
    assert store.done(cells[0]) and not store.done(cells[1])
    assert store.pending(cells) == [cells[1], cells[3]]
    assert store.load(cells[0])["eval"] == [0.5, 0.7]
    # the reference's store reads the port's directory: same cells, same
    # aggregate, same table text
    ref = ResultsStore(str(tmp_path))
    ref_cells = ref_grid.cells()
    assert [ref.done(c) for c in ref_cells] == [store.done(c) for c in cells]
    assert ref.load(ref_cells[0]) == store.load(cells[0])
    assert ref.aggregate(ref_grid) == store.aggregate(grid)
    assert ref.table(ref_grid) == store.table(grid)
    lines = [json.loads(x) for x in
             (tmp_path / "results.jsonl").read_text().splitlines()]
    assert [x["cell"] for x in lines] == [cells[0].key, cells[2].key]
    assert lines[0]["arch"] == "tiny" and lines[0]["final_eval"] == 0.7


# ---------------------------------------------------------------------------
# the DataShard sampler
# ---------------------------------------------------------------------------


def test_data_shard_draws_each_devices_own_rows():
    """Rows of device n only, uniform with replacement over its true
    count (never the wrap padding), a pure function of (key, r); a stack
    of keys draws each key's batch, seed by seed."""
    counts = [5, 17, 9]
    arrays = [{"id": np.arange(c) + 100 * n,
               "x": np.full((c, 2), n, np.float32)}
              for n, c in enumerate(counts)]
    shard = DataShard(arrays, batch_size=6, seed=3, device="cpu")
    k0, k1 = shard.seed_key(0), shard.seed_key(1)
    assert k0.dim() == 0 and k0.dtype == torch.int64 and k0 != k1
    seen = [set() for _ in counts]
    for r in range(40):
        b = shard.traced_batch(k0, r)
        assert b["id"].shape == (3, 6) and b["x"].shape == (3, 6, 2)
        for n, c in enumerate(counts):
            ids = b["id"][n] - 100 * n
            assert ((ids >= 0) & (ids < c)).all()
            assert (b["x"][n] == n).all()
            seen[n] |= set(ids.tolist())
    assert [len(s) for s in seen] == counts  # every row drawn in 40 rounds
    a = shard.traced_batch(k0, torch.tensor(7, dtype=torch.int32))
    assert torch.equal(a["id"], shard.traced_batch(k0, 7)["id"])
    assert not torch.equal(a["id"], shard.traced_batch(k0, 8)["id"])
    both = shard.traced_batch(torch.stack([k0, k1]), 7)["id"]
    assert torch.equal(both, torch.cat([a["id"],
                                        shard.traced_batch(k1, 7)["id"]]))
    # the hash is the kernels' dither stream, bit for bit
    h = TQ.lowbias32(torch.tensor([5, 9]), torch.tensor([1, 2**31 + 3]))
    assert torch.equal(TQ.dither_u01(torch.tensor([5, 9]),
                                     torch.tensor([1, 2**31 + 3])),
                       h.to(torch.float32) / 2**32)


# ---------------------------------------------------------------------------
# the whole-run engine against the port's loop engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_mode", ["shard", "prestack"])
@pytest.mark.parametrize("policy", ["mads", "afl", "mads-joint"])
def test_scan_matches_loop(fed, policy, batch_mode):
    """Same seeds, same batches: the final state bit-equal, the history
    within the cross-engine tolerance (the engine carries its totals in
    f32), one eval per segment boundary."""
    tmodel, fl, dev, ev = fed
    if batch_mode == "shard":
        loader = DataShard(dev, fl.batch_size, seed=0, device="cpu")
        src = loader
    else:
        loader = TDeviceLoader(dev, fl.batch_size, 0)
        src = prestack_batches(TDeviceLoader(dev, fl.batch_size, 0), ROUNDS,
                               "cpu")
    loop = t_run_afl(tmodel, tmodel.cfg, fl, policy, loader, ev,
                     rounds=ROUNDS, eval_every=EVERY, device="cpu")
    scan = run_afl_scanned(tmodel, tmodel.cfg, fl, policy, src, ev,
                           rounds=ROUNDS, eval_every=EVERY, device="cpu")
    assert loop.history["uploads"][-1] > 0
    _assert_state_equal(scan.state, loop.state)
    _assert_hist_close(scan.history, loop.history)
    assert scan.history["uploads"] == loop.history["uploads"]
    assert len(scan.round_seconds) == ROUNDS
    assert len(scan.eval_seconds) == len(t_eval_points(ROUNDS, EVERY))


def test_runner_delegates_scan_and_refuses_other_engines(fed):
    tmodel, fl, dev, ev = fed
    shard = DataShard(dev, fl.batch_size, seed=0, device="cpu")
    a = t_run_afl(tmodel, tmodel.cfg, fl, "mads", shard, ev, rounds=ROUNDS,
                  eval_every=EVERY, engine="scan", device="cpu")
    b = run_afl_scanned(tmodel, tmodel.cfg, fl, "mads", shard, ev,
                        rounds=ROUNDS, eval_every=EVERY, device="cpu")
    assert a.history == b.history
    _assert_state_equal(a.state, b.state)
    with pytest.raises(ValueError, match="unknown engine"):
        t_run_afl(tmodel, tmodel.cfg, fl, "mads", shard, ev, engine="warp",
                  device="cpu")
    with pytest.raises(ValueError, match="DataShard is on"):
        run_afl_scanned(tmodel, tmodel.cfg, fl, "mads", shard, ev,
                        rounds=2, device="meta")


def test_seed_batch_matches_independent_runs(fed):
    """S seeds folded into the rows give each seed's own run, bit for bit,
    and different seeds different uploads."""
    tmodel, fl, dev, ev = fed
    shard = DataShard(dev, fl.batch_size, seed=0, device="cpu")
    batch = run_seed_batch(tmodel, tmodel.cfg, fl, "mads-joint", shard, ev,
                           seeds=[0, 1, 2], rounds=ROUNDS, eval_every=EVERY,
                           device="cpu")
    assert len(batch) == 3
    for seed, res in enumerate(batch):
        ind = run_afl_scanned(tmodel, tmodel.cfg, fl, "mads-joint", shard, ev,
                              rounds=ROUNDS, eval_every=EVERY, seed=seed,
                              device="cpu")
        assert res.history == ind.history
        _assert_state_equal(res.state, ind.state)
    assert len({tuple(r.history["uploads"]) for r in batch}) == 3
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        run_seed_batch(tmodel, tmodel.cfg, fl, "mads", shard, ev, seeds=[0],
                       mesh=object(), device="cpu")


def test_scan_telemetry_matches_loop(fed):
    """The full suite (registry, per-device table, probes) through the
    whole-run engine equals the loop's, under Manhattan mobility gated by
    heterogeneity: every counter, bin and table field."""
    tmodel, fl, dev, ev = fed
    fl = dataclasses.replace(fl, mobility_model="manhattan", speed=15.0,
                             area=300.0, het_dropout=0.2,
                             het_availability=0.8, het_avail_persist=0.3,
                             het_compute_mean=1.0)
    suite = TelemetrySuite(metrics=AFL_REGISTRY, device=DeviceTable(N),
                           probes=TheoryProbes(s=tmodel.num_params()))
    shard = DataShard(dev, fl.batch_size, seed=0, device="cpu")
    runs = [fn(tmodel, tmodel.cfg, fl, "mads", shard, ev, rounds=ROUNDS,
               eval_every=EVERY, device="cpu", telemetry=suite)
            for fn in (t_run_afl, run_afl_scanned)]
    a, b = (to_jsonable(r.telemetry) for r in runs)
    assert a == b
    assert a["metrics"]["counters"]["contacts"] > 0
    assert sum(a["device"]["unavail"]) + sum(a["device"]["dropouts"]) > 0
    seeds = run_seed_batch(tmodel, tmodel.cfg, fl, "mads", shard, ev,
                           seeds=[0], rounds=ROUNDS, eval_every=EVERY,
                           device="cpu", telemetry=suite)
    assert to_jsonable(seeds[0].telemetry) == a


# ---------------------------------------------------------------------------
# the whole-run engine against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["mads", "afl-spar"])
def test_scan_tracks_reference_scan(policy, monkeypatch):
    """The port's run_afl_scanned against the reference's, from the
    reference's weights with the same prestacked DeviceLoader draws: the
    standard the loop engine is held to (eval within 0.02, uploads
    equal)."""
    cfg = get_config("resnet9-cifar10").replace(d_model=4)
    model = build_model(cfg)
    fl = FLConfig(**FL_KW)
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    tfl = TFLConfig(**FL_KW)
    w_np = jax.tree.map(np.asarray,
                        JIT_INIT(model, cfg, fl, jax.random.key(0)).w)
    monkeypatch.setattr(ref_scan, "afl_init", JIT_INIT)
    dev, ev = build_device_data(cfg, fl, train_n=160, eval_n=64, seed=0)
    ref = ref_scan.run_afl_scanned(model, cfg, fl, policy,
                                   DeviceLoader(dev, 8, 0), ev, rounds=ROUNDS,
                                   eval_every=EVERY)
    port = run_afl_scanned(tmodel, tmodel.cfg, tfl, policy,
                           TDeviceLoader(dev, 8, 0), ev, rounds=ROUNDS,
                           eval_every=EVERY, device="cpu",
                           params=load_params(tmodel, w_np))
    assert ref.history["round"] == port.history["round"]
    assert port.history["uploads"][-1] > 0
    np.testing.assert_allclose(port.history["uploads"],
                               ref.history["uploads"])
    np.testing.assert_allclose(port.history["eval"], ref.history["eval"],
                               atol=0.02)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_scan_engine(tmp_path):
    """The training CLI's default engine is the whole-run engine: its
    spans (run, fetch on the CPU; capture first on the card) and a
    history like the loop's."""
    wd = tmp_path / "w"
    res = t_train.main(["--device", "cpu", "--width", "4", "--devices", "4",
                        "--rounds", "4", "--eval-every", "2", "--batch-size",
                        "8", "--train-n", "64", "--intercontact", "20",
                        "--telemetry", "--workdir", str(wd)])
    hist = json.loads((wd / "history.json").read_text())
    assert hist["args"]["engine"] == "scan"
    assert hist["history"]["round"] == [2, 4]
    assert res.telemetry["counters"]["rounds"] == 4.0
    assert res.telemetry["counters"]["successes"] == res.history["uploads"][-1]
    events = read_jsonl(str(wd / "telemetry.jsonl"))
    assert [e["name"] for e in events if e["kind"] == "span"] == \
        ["run", "fetch"]


def test_sweep_cli_writes_cells_and_resumes(tmp_path, capsys):
    out = tmp_path / "sw"
    argv = ["--device", "cpu", "--width", "4", "--policies", "mads,afl",
            "--speeds", "10,20", "--seeds", "2", "--rounds", "4",
            "--eval-every", "2", "--devices", "4", "--train-n", "160",
            "--perdevice", "--probes", "--report", "--out", str(out)]
    table = t_sweep.main(argv)
    lines = (out / "results.jsonl").read_text().splitlines()
    assert len(lines) == 8 and len(list((out / "cells").glob("*.npz"))) == 8
    kinds = [e["kind"] for e in read_jsonl(str(out / "telemetry.jsonl"))]
    assert kinds.count("group_metrics") == kinds.count("probe_report") == 4
    assert "metrics" in kinds
    assert "## Per-group results" in (out / "report.md").read_text()
    assert "mads" in table and table in capsys.readouterr().out
    # a rerun skips every done cell and leaves the artifacts as they were
    before = (out / "telemetry.jsonl").read_text()
    assert t_sweep.main(argv) == table
    assert (out / "results.jsonl").read_text().splitlines() == lines
    assert (out / "telemetry.jsonl").read_text() == before
    # the reference's store reads the port's sweep
    ref_grid = ExperimentGrid(policies=("mads", "afl"), speeds=(10.0, 20.0),
                              seeds=(0, 1), rounds=4, eval_every=2)
    assert ResultsStore(str(out)).table(ref_grid) == table


def test_sweep_cli_refuses_a_mesh(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        t_sweep.main(["--device", "cpu", "--mesh", "2", "--out",
                      str(tmp_path)])

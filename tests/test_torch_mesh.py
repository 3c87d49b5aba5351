"""The seed and ingest meshes over ``torch.distributed`` (gloo on the CPU)
against one process.

Two gloo ranks are spawned once for the module on a file store, and the
sweep and soak CLIs run once each under ``torchrun --nproc-per-node 2``;
each process has its own timeout.  Held:

* ``make_seed_mesh``: two ranks for S = 2, none (None) for S = 3, as the
  reference takes the largest device count that divides S;
* ``run_seed_batch(mesh=)``: every rank returns both seeds' histories in
  seed order, bit-equal to one process's run of both, and the seed's
  final state, on the rank that ran it only, bit-equal too (ResNet-9 at
  width 4, ``mads-joint``);
* ``IngestServer(mesh=)``, parity and scatter modes, hinge staleness: the
  bits, counts and staleness bins of world 2 equal world 1's, ``w`` is
  bit-equal on both ranks, and within 1e-6 of its largest entry of world
  1's (the all-reduce adds the two ranks' partial sums in another order
  than one rank's product: the standard tests/test_torch_distributed.py
  holds the distributed round to); the batch must split evenly;
* ``sweep --mesh 2``: every cell written once, by rank 0, each history
  equal to one process's sweep; ``soak --mesh 2``: every upload ingested
  once, ``BENCH_serve.json`` from rank 0 with the world size.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import sweep  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 150  # seconds a spawned process may take
MODES = ("parity", "scatter")
SWEEP = ["--width", "4", "--policies", "mads", "--speeds", "10", "--seeds",
         "2", "--rounds", "4", "--eval-every", "2", "--devices", "4",
         "--train-n", "160", "--batch-size", "8", "--no-telemetry"]

# shared by the ranks and the one-process runs
SETUP = textwrap.dedent(r"""
import numpy as np
import torch
from repro_torch.configs import FLConfig, get_config
from repro_torch.core.afl import StalenessWeight
from repro_torch.experiments import DataShard, run_seed_batch
from repro_torch.launch.soak import drain_all, make_payloads, rank_share
from repro_torch.launch.train import build_device_data
from repro_torch.models.registry import build_model
from repro_torch.serve import IngestServer

torch.set_num_threads(1)
CFG = get_config("resnet9-cifar10").replace(d_model=4)
FL = FLConfig(num_devices=4, rounds=3, batch_size=8, learning_rate=0.02,
              mean_contact=6.0, mean_intercontact=30.0,
              energy_budget=(40.0, 80.0))
S, UPLOADS, BATCH, MAX_K = 3000, 40, 8, 64


def seeds(mesh):
    model = build_model(CFG)
    dev, ev = build_device_data(CFG, FL, train_n=160, eval_n=32, seed=0)
    shard = DataShard(dev, FL.batch_size, seed=0, device="cpu")
    return run_seed_batch(model, CFG, FL, "mads-joint", shard, ev,
                          seeds=[0, 1], rounds=3, eval_every=1, mesh=mesh,
                          device="cpu")


def ingest(mesh, mode):
    payloads = make_payloads(UPLOADS, S, MAX_K, codec="topk", seed=3,
                             chunk=16, device="cpu")
    srv = IngestServer(torch.zeros(S), num_devices=UPLOADS, batch=BATCH,
                       max_k=MAX_K, staleness=StalenessWeight(family="hinge"),
                       mesh=mesh, mode=mode, queue_policy="defer")
    drain_all(srv, rank_share(payloads, BATCH, mesh))
    snap = srv.snapshot()
    # the ingest's own record; the queue's (offers deferred) is each
    # rank's buffer's
    return srv.w, {"counters": {k: snap["counters"][k] for k in (
                       "batches", "ingested", "bits_ingested", "weight_sum",
                       "accepted")},
                   "server_round": snap["gauges"]["server_round"],
                   "hist": {k: v.tolist() for k, v in snap["hist"].items()}}
""")

RANK_SCRIPT = SETUP + textwrap.dedent(r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch.mesh import make_seed_mesh

rank, tmp = int(sys.argv[1]), sys.argv[2]
store = dist.FileStore(tmp + "/store", 2)
dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
out = {"rank": rank}
out["s3_mesh"] = make_seed_mesh(3, device="cpu") is None
mesh = make_seed_mesh(2, device="cpu")
out["world"] = mesh.world_size
res = seeds(mesh)
out["hist"] = [r.history for r in res]
out["states_here"] = [r.state is not None for r in res]
torch.save([None if r.state is None else r.state.w for r in res],
           f"{tmp}/seed_w{rank}.pt")
out["ingest"] = {}
for mode in ("parity", "scatter"):
    w, snap = ingest(mesh, mode)
    torch.save(w, f"{tmp}/ingest_{mode}{rank}.pt")
    out["ingest"][mode] = snap
try:
    IngestServer(torch.zeros(8), num_devices=4, batch=3, max_k=4, mesh=mesh)
    out["odd_batch"] = "accepted"
except ValueError as e:
    out["odd_batch"] = str(e)
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(module: str, argv: list) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", module, *argv],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both gloo ranks' results, and the two CLIs' outputs under torchrun,
    each spawned once (all at the same time, each with its own
    timeout)."""
    tmp = tmp_path_factory.mktemp("mesh")
    procs = {f"rank{r}": subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(tmp)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)}
    procs["sweep"] = _torchrun("repro_torch.launch.sweep", [
        "--device", "cpu", "--mesh", "2", "--out", str(tmp / "sweep"),
        *SWEEP])
    procs["soak"] = _torchrun("repro_torch.launch.soak", [
        "--device", "cpu", "--mesh", "2", "--smoke", "--no-baseline",
        "--batch", "64", "--staleness", "hinge", "--out-dir",
        str(tmp / "soak")])
    out = {"tmp": tmp}
    try:
        for name, p in procs.items():
            text, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (name, err[-3000:])
            out[name] = text
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for r in range(2):
        line = [l for l in out[f"rank{r}"].splitlines()
                if l.startswith("RESULT ")][-1]
        out[r] = json.loads(line[len("RESULT "):])
    return out


@pytest.fixture(scope="module")
def world1():
    """One process's runs of the same work."""
    torch.set_num_threads(1)
    ns = {}
    exec(SETUP, ns)
    return ns


def test_seed_mesh_takes_the_ranks_that_divide_the_seeds(world2):
    for r in range(2):
        assert world2[r]["world"] == 2 and world2[r]["s3_mesh"] is True


def test_seed_mesh_bit_equal_to_one_process(world2, world1):
    want = world1["seeds"](None)
    tmp = world2["tmp"]
    for r in range(2):
        assert world2[r]["hist"] == [res.history for res in want]
        assert world2[r]["states_here"] == [i == r for i in range(2)]
        w = torch.load(tmp / f"seed_w{r}.pt")
        assert torch.equal(w[r], want[r].state.w)


@pytest.mark.parametrize("mode", MODES)
def test_ingest_over_two_ranks_against_one(world2, world1, mode):
    w1, snap1 = world1["ingest"](None, mode)
    tmp = world2["tmp"]
    w = [torch.load(tmp / f"ingest_{mode}{r}.pt") for r in range(2)]
    assert torch.equal(w[0], w[1])
    for r in range(2):
        assert world2[r]["ingest"][mode] == snap1  # bits, counts, bins
    c = snap1["counters"]
    assert c["ingested"] == c["accepted"] == world1["UPLOADS"]
    assert c["batches"] == world1["UPLOADS"] / world1["BATCH"]
    off = (w[0] - w1).abs() / w1.abs().max()
    assert float(off.max()) <= 1e-6, float(off.max())


def test_ingest_batch_must_split_over_the_mesh(world2):
    assert world2[0]["odd_batch"] == "batch=3 not divisible by mesh size 2"


def test_sweep_cli_over_two_ranks(world2, tmp_path):
    """Rank 0 wrote each cell once; each history equals one process's
    sweep's; rank 0 alone printed the table."""
    one, two = tmp_path / "one", world2["tmp"] / "sweep"
    table = sweep.main(["--device", "cpu", "--out", str(one), *SWEEP])
    recs = [json.loads(l) for l in
            (two / "results.jsonl").read_text().splitlines()]
    assert sorted(r["cell"] for r in recs) == sorted(
        json.loads(l)["cell"] for l in
        (one / "results.jsonl").read_text().splitlines())
    assert len(recs) == 2
    for r in recs:
        path = f"cells/{r['cell']}.npz"
        with np.load(two / path) as x, np.load(one / path) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k])
    assert world2["sweep"].count(table.splitlines()[0]) == 1


def test_soak_cli_over_two_ranks(world2):
    bench = json.loads(
        (world2["tmp"] / "soak" / "BENCH_serve.json").read_text())
    assert bench["meta"] == {"world_size": 2}
    assert len(bench["rows"]) == 1
    assert "ingested" in world2["soak"] and "soak_topk_hinge" in world2["soak"]

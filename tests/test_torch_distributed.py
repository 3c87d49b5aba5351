"""The port's distributed AFL round (``core/distributed.py``) and client
mesh (``launch/mesh.py``) against the JAX reference's pjit step, the
port's ``afl_round`` and its scan engine, on the CPU.

Both packages get the same inputs: the reference's initial weights
(``load_params``), the same numpy batches, schedules and budgets, and for
the quantising codecs the dither seeds the reference draws from its
``ckey``.  Tolerances:

* reduced InternLM2 (1 layer, f32 weights, activations and states) against
  the reference's step: states at the reference's own test tolerances,
  rtol 1e-4 and atol 1e-5, except at most 2 coordinates a client that
  the threshold may put on the other side (gradients differ by fp32
  rounding, as in test_torch_afl.py); k within 2, uploads equal;
* the bf16 default ``DistConfig`` against the reference compiled with
  ``xla_allow_excess_precision`` off (test_torch_serve.py): successes and
  k equal; w, w_n and e_n more than one bf16 ulp apart at under 1e-4 of
  the coordinates, and every state (g_n too: the bf16 gradients round
  apart) no further from that compile than the reference's own default
  compile is;
* ResNet-9 at width 4, f32, codecs: the port's step equals its own
  ``afl_round`` bit for bit (bits, k, b and w), and the reference's step
  in bits, k and b given the same seeds, w within 1e-6 of its largest
  entry but at the dither flips of the quantising codecs (under 3 % of
  the coordinates, within 1e-4);
* histories against the port's scan engine at rtol 1e-6, telemetry
  counters and bins against the reference's (energy at rtol 1e-5);
* two gloo ranks spawned on the CPU: bits histories of world 1 and world
  2 equal, and the group contract of ``strict_threshold`` / ``tree_amax``
  (one threshold on both ranks, amax exact, count within 4 standard
  errors), the reference's ``MESH_SCRIPT``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.compression.quant import seed_from_key  # noqa: E402
from repro.configs import FLConfig, get_config  # noqa: E402
from repro.core import baselines as BL  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.core.mads import MadsController  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro.telemetry import AFL_REGISTRY as R_AFL_REGISTRY  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import baselines as TBL  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core.afl import afl_init as t_afl_init  # noqa: E402
from repro_torch.core.afl import afl_round as t_afl_round  # noqa: E402
from repro_torch.core.mads import MadsController as TMadsController  # noqa: E402
from repro_torch.core.runner import build_provider, run_afl, sample_budgets  # noqa: E402
from repro_torch.experiments import DataShard  # noqa: E402
from repro_torch.experiments.scan_engine import eval_points  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch.train import build_device_data  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.telemetry import afl_registry  # noqa: E402

N = 4
ROUNDS = 4
CODECS = ("mads-topk", "mads-joint", "qsgd", "fixed-kb")
F32 = dict(dtype="float32", param_dtype="float32")
ROOT = os.path.join(os.path.dirname(__file__), "..")
STATES = ("w", "w_n", "g_n", "e_n")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(tree, n=N):
    """A reference (N, ...)-stacked tree as (N, s) f32 numpy."""
    return np.concatenate([np.asarray(l, np.float32).reshape(n, -1)
                           for l in jax.tree.leaves(tree)], axis=1)


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(-1)
                           for l in jax.tree.leaves(tree)])


def _ref_state_np(state):
    return {"w": _flat(state.w), "w_n": _rows(state.w_n),
            "g_n": _rows(state.g_n), "e_n": _rows(state.e_n)}


def _port_state_np(state):
    return {k: getattr(state, k).to(torch.float32).numpy() for k in STATES}


def _off(a, b, rtol, atol):
    """Coordinates of a and b (N, s) or (s,) outside the tolerance, per
    row (the largest count over rows)."""
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    return int(bad.reshape(-1 if bad.ndim == 1 else bad.shape[0], 1 if
                           bad.ndim == 1 else -1).sum(axis=-1).max())


def _ref_seeds(ckey):
    """The (N,) dither seeds the reference's ``compress_uploads`` draws
    from ``ckey``, and the advanced carry."""
    ckey, sub = jax.random.split(ckey)
    seeds = np.array([int(seed_from_key(k)) for k in jax.random.split(sub, N)],
                     np.int32)
    return torch.as_tensor(seeds), ckey


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Reduced InternLM2: the reference's tests/test_distributed.py, mirrored
# ---------------------------------------------------------------------------


def _lm_pair(state_dtype, **replace):
    cfg = get_config("internlm2-1.8b").reduced().replace(num_layers=1, **replace)
    tcfg = t_get_config("internlm2-1.8b").reduced().replace(num_layers=1,
                                                           **replace)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    kw = dict(num_clients=N, learning_rate=0.01, rounds=50,
              state_dtype=state_dtype, upload_dtype="float32")
    rd, td = RD.DistConfig(**kw), TD.DistConfig(**kw)
    s = model.num_params()
    rstate = RD.init_state(model, rd, jax.random.key(0))
    tstate = TD.init_state(tmodel, td, 0, device="cpu", params=load_params(
        tmodel, jax.tree.map(np.asarray, rstate.w)))
    rstep = RD.make_afl_train_step(model, cfg, rd, MadsController(s=s))
    tstep = TD.make_afl_train_step(tmodel, tcfg, td, TMadsController(s=s))
    return cfg, rstate, rstep, tstate, tstep


@pytest.fixture(scope="module")
def lm():
    cfg, rstate, rstep, tstate, tstep = _lm_pair("float32", **F32)
    return cfg, rstate, jax.jit(rstep), tstate, tstep


def _lm_round(lm, seed, zeta, tau):
    """One round of both steps from the fixture's state: (reference new
    state, metrics), (port's)."""
    cfg, rstate, rstep, tstate, tstep = lm
    batch = demo_batch(cfg, 8, 16, np.random.default_rng(seed))
    o = np.ones(N, np.float32)
    args = (np.asarray(zeta, np.float32), np.asarray(tau, np.float32),
            o * 1e-9, o * 100.0)
    rnew, rm = rstep(rstate, _j(batch), *map(jnp.asarray, args))
    tnew, tm = tstep(tstate, _t(batch), *map(torch.as_tensor, args))
    return (rnew, rm), (tnew, tm)


def _hold_lm(ref, port):
    (rnew, rm), (tnew, tm) = ref, port
    want, got = _ref_state_np(rnew), _port_state_np(tnew)
    for name in STATES:
        assert _off(got[name], want[name], 1e-4, 1e-5) <= 2, name
    np.testing.assert_array_equal(tm["uploads"].numpy(), np.asarray(rm["uploads"]))
    np.testing.assert_allclose(tm["k"].numpy(), np.asarray(rm["k"]), atol=2)


def test_no_contact_local_training_only(lm):
    ref, port = _lm_round(lm, 3, np.zeros(N), np.zeros(N))
    tstate, (tnew, tm) = lm[3], port
    torch.testing.assert_close(tnew.w, tstate.w, rtol=0, atol=0)
    assert float((tnew.w_n - tstate.w_n).abs().sum()) > 0
    assert float(tm["uploads"].sum()) == 0
    _hold_lm(ref, port)


def test_contact_updates_global_and_resets(lm):
    ref, port = _lm_round(lm, 4, np.ones(N), np.full(N, 8.0))
    tstate, (tnew, tm) = lm[3], port
    assert float((tnew.w.float() - tstate.w.float()).abs().sum()) > 0
    assert float(tm["uploads"].sum()) == N
    assert int(tnew.kappa.min()) == 1
    for i in range(N):  # contacted clients hold the new global model
        torch.testing.assert_close(tnew.w_n[i], tnew.w, rtol=0, atol=0)
    _hold_lm(ref, port)


def test_matches_afl_round_without_contact(lm):
    """The same local SGD as the port's ``afl_round`` (bit for bit)."""
    cfg, rstate, rstep, tstate, tstep = lm
    tcfg = t_get_config("internlm2-1.8b").reduced().replace(num_layers=1, **F32)
    tmodel = t_build_model(tcfg)
    fl = TFLConfig(num_devices=N, rounds=50, learning_rate=0.01)
    sim = t_afl_init(tmodel, fl, 0, "cpu",
                     params=tmodel.layout.unflatten(tstate.w))
    ref, port = _lm_round(lm, 5, np.zeros(N), np.zeros(N))
    batch = demo_batch(cfg, 8, 16, np.random.default_rng(5))
    stacked = {k: torch.as_tensor(v.reshape(N, 2, *v.shape[1:]))
               for k, v in batch.items()}
    z, o = torch.zeros(N), torch.ones(N)
    new_s, _ = t_afl_round(sim, stacked, z, z, o * 1e-9, o * 100.0,
                           model=tmodel, fl=fl,
                           policy=TBL.mads(tmodel.num_params(), fl))
    assert torch.equal(port[0].w_n, new_s.w_n)
    _hold_lm(ref, port)


def test_upload_bits_accounted(lm):
    ref, port = _lm_round(lm, 6, np.ones(N), np.full(N, 4.0))
    tm = port[1]
    assert float(tm["upload_bits"].sum()) > 0
    assert torch.equal(tm["upload_bits"], tm["bits"])
    assert float(tm["k"].max()) <= lm[3].w.numel()
    _hold_lm(ref, port)


def _bf16_far(got, want):
    """Share of coordinates more than one bf16 ulp apart."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    return float(np.mean(np.abs(got - want) > ulp))


@pytest.mark.parametrize("contact", [False, True], ids=["local", "contact"])
def test_bf16_states_match_reference_without_excess_precision(contact):
    """The default ``DistConfig`` (bf16 client states, f32 accumulation) on
    reduced InternLM2 in bf16, one round against the reference's step
    compiled with every operation rounding to its own dtype.

    The bf16 gradients of the two packages round apart (another order of
    bf16 operations), and ``g_n = eta * grad`` shows it directly: held to
    the yardstick of the reference's own default compile (excess precision
    on), the port is no further from the exact compile in any state, and
    w, w_n and e_n are more than one bf16 ulp apart at under 1e-4 of the
    coordinates (measured: 0 to 2.5e-5; g_n 1.4 % against the default
    compile's 20.5 %)."""
    cfg, rstate, rstep, tstate, tstep = _lm_pair("bfloat16")
    batch = demo_batch(cfg, 8, 16, np.random.default_rng(7))
    o = np.ones(N, np.float32)
    z = o if contact else 0 * o
    args = (z, 8.0 * z, o * 1e-9, o * 100.0)
    jargs = (rstate, _j(batch)) + tuple(map(jnp.asarray, args))
    exact = jax.jit(rstep).lower(*jargs).compile(
        compiler_options={"xla_allow_excess_precision": False})
    rnew, rm = exact(*jargs)
    rdef, _ = jax.jit(rstep)(*jargs)
    tnew, tm = tstep(tstate, _t(batch), *map(torch.as_tensor, args))
    assert tnew.w_n.dtype == tnew.g_n.dtype == tnew.e_n.dtype == torch.bfloat16
    np.testing.assert_array_equal(tm["success"].numpy(),
                                  np.asarray(rm["success"]))
    np.testing.assert_array_equal(tm["k"].numpy(), np.asarray(rm["k"]))
    want, got = _ref_state_np(rnew), _port_state_np(tnew)
    dflt = _ref_state_np(rdef)
    for name in STATES:
        far = _bf16_far(got[name], want[name])
        assert far <= _bf16_far(dflt[name], want[name]), name
        if name != "g_n":
            assert far <= 1e-4, (name, far)


# ---------------------------------------------------------------------------
# ResNet-9 at width 4 with every codec: afl_round and the reference's step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fed():
    cfg = get_config("resnet9-cifar10").replace(d_model=4)
    tcfg = t_get_config("resnet9-cifar10").replace(d_model=4)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    kw = dict(num_devices=N, rounds=ROUNDS, batch_size=8, learning_rate=0.02,
              mean_contact=6.0, mean_intercontact=30.0,
              energy_budget=(40.0, 80.0))
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    rd = RD.DistConfig(num_clients=N, learning_rate=fl.learning_rate,
                       rounds=fl.rounds, state_dtype="float32")
    rstate = RD.init_state(model, rd, jax.random.key(0))
    params = jax.tree.map(np.asarray, rstate.w)
    provider = build_provider(tfl, "mads", None, ROUNDS, 0, device="cpu")
    sched = [tuple(np.asarray(a, np.float32) for a in provider.round(r))
             for r in range(ROUNDS)]
    rng = np.random.default_rng(11)
    batches = [demo_batch(cfg, N * fl.batch_size, 0, rng) for _ in range(ROUNDS)]
    budgets = sample_budgets(tfl, 0)
    return cfg, model, fl, rd, rstate, tcfg, tmodel, tfl, params, sched, \
        batches, budgets


def _t_dist(fed, policy_name, **step_kw):
    cfg, model, fl, rd, rstate, tcfg, tmodel, tfl, params = fed[:9]
    pol = TBL.ALL[policy_name](tmodel.num_params(), tfl)
    td = TD.DistConfig(num_clients=N, learning_rate=tfl.learning_rate,
                       rounds=tfl.rounds, state_dtype="float32")
    step = TD.make_afl_train_step(tmodel, tcfg, td, pol.controller,
                                  compressor=pol.compressor,
                                  staleness=pol.staleness, **step_kw)
    state = TD.init_state(tmodel, td, 0, device="cpu",
                          params=load_params(tmodel, params))
    return pol, step, state


def _round_inputs(fed, r):
    sched, batches, budgets = fed[9:]
    z, tau, h2 = sched[r]
    return batches[r], (z, tau, h2, budgets)


@pytest.mark.parametrize("policy_name", CODECS)
def test_step_bitwise_matches_afl_round(fed, policy_name):
    """Round by round from one state: the same bits, k, b and global
    model, bit for bit, and one kernel path (no launch on the CPU)."""
    tmodel, tfl, params = fed[6], fed[7], fed[8]
    pol, step, ds = _t_dist(fed, policy_name)
    ss = t_afl_init(tmodel, tfl, 0, "cpu", params=load_params(tmodel, params))
    K.reset_launches()
    shipped = 0.0
    for r in range(ROUNDS):
        batch, args = _round_inputs(fed, r)
        args = tuple(map(torch.as_tensor, args))
        ds, md = step(ds, _t(batch), *args)
        stacked = {k: torch.as_tensor(v.reshape(N, -1, *v.shape[1:]))
                   for k, v in batch.items()}
        ss, ms = t_afl_round(ss, stacked, *args, model=tmodel, fl=tfl,
                             policy=pol)
        for k in ("bits", "k", "b"):
            assert torch.equal(md[k], ms[k]), (policy_name, r, k)
        assert torch.equal(ds.w, ss.w), (policy_name, r)
        assert torch.equal(ds.e_n, ss.e_n) and torch.equal(ds.w_n, ss.w_n)
        shipped += float(md["bits"].sum())
    assert shipped > 0
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("policy_name", CODECS)
def test_step_matches_reference_step(fed, policy_name):
    """The same rounds against the reference's jitted step given its own
    dither seeds: bits, k and b equal; w within 1e-6 of its largest entry
    (a few f32 ulps of a weight near 2.3) at 97 % of the coordinates or
    more, and within 1e-4 everywhere.  The rest are dither flips: the
    gradients differ by fp32 rounding, so where x / step + u lands that
    close to an integer a client's quantised code moves by one step
    (measured: 0.87 % of w at round 3 of ``mads-joint``, b = 13, at most
    2.1e-5 / 2.32 = 9e-6 of the largest entry; 0 for ``mads-topk``)."""
    cfg, model, fl, rd, rstate = fed[:5]
    rpol = BL.ALL[policy_name](model.num_params(), fl)
    rstep = jax.jit(RD.make_afl_train_step(model, cfg, rd, rpol.controller,
                                           compressor=rpol.compressor))
    _, step, ts = _t_dist(fed, policy_name)
    ckey = rstate.ckey
    shipped = 0.0
    for r in range(ROUNDS):
        batch, args = _round_inputs(fed, r)
        seeds, ckey = _ref_seeds(ckey)
        rstate, rm = rstep(rstate, _j(batch), *map(jnp.asarray, args))
        ts, tm = step(ts, _t(batch), *map(torch.as_tensor, args), seeds=seeds)
        for k in ("bits", "k", "b"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(rm[k]),
                                          err_msg=f"{policy_name} r={r} {k}")
        want = _flat(rstate.w)
        off = np.abs(ts.w.numpy() - want) / np.abs(want).max()
        assert np.mean(off > 1e-6) <= 0.03 and off.max() <= 1e-4, (
            policy_name, r, np.mean(off > 1e-6), off.max())
        shipped += float(tm["bits"].sum())
    assert shipped > 0


@pytest.mark.parametrize("per_layer", [False, True],
                         ids=["global-split", "per-layer"])
def test_codec_bits_within_contact_budget(fed, per_layer):
    """Every upload's realised bits <= tau * A(p), global and per-layer
    (the reference's test_dist_codec_bits_within_contact_budget)."""
    from repro_torch.core import mads as TMads

    fed = list(fed)
    fed[7] = dataclasses.replace(fed[7], per_layer_budget=per_layer)
    pol, step, ts = _t_dist(fed, "mads-joint")
    ctl = pol.controller
    total = 0.0
    for r in range(ROUNDS):
        batch, args = _round_inputs(fed, r)
        targs = tuple(map(torch.as_tensor, args))
        ts, m = step(ts, _t(batch), *targs)
        cap = (targs[1].double() * TMads.rate_bps(
            m["power"], targs[2], ctl.bandwidth, ctl.noise_w_hz).double())
        bits = m["bits"].double()
        assert bool(torch.all(bits <= cap * (1 + 1e-5) + 1e-3)), (r, bits, cap)
        total += float(bits.sum())
    assert total > 0


@pytest.mark.parametrize("policy_name", ("mads-topk", "mads-joint", "qsgd"))
def test_history_matches_scan_engine(policy_name):
    """theta_mean / bits_mean of the distributed rounds equal the port's
    scan engine's (same provider, DataShard stream and seed)."""
    rounds = 6
    tcfg = t_get_config("resnet9-cifar10").replace(d_model=4)
    tmodel = t_build_model(tcfg)
    tfl = TFLConfig(num_devices=N, rounds=rounds, batch_size=8,
                    learning_rate=0.02, mean_contact=6.0,
                    mean_intercontact=30.0, energy_budget=(40.0, 80.0))
    dev, ev = build_device_data(tcfg, tfl, train_n=160, eval_n=64, seed=0)
    shard = DataShard(dev, tfl.batch_size, seed=0, device="cpu")
    params = tmodel.init(torch.Generator().manual_seed(0))
    scan = run_afl(tmodel, tcfg, tfl, policy_name, shard, ev, rounds=rounds,
                   eval_every=3, engine="scan", device="cpu", params=params)
    pol = TBL.ALL[policy_name](tmodel.num_params(), tfl)
    td = TD.DistConfig(num_clients=N, learning_rate=tfl.learning_rate,
                       rounds=rounds, state_dtype="float32")
    step = TD.make_afl_train_step(tmodel, tcfg, td, pol.controller,
                                  compressor=pol.compressor)
    state = TD.init_state(tmodel, td, 0, device="cpu", params=params)
    key = shard.seed_key(0)
    _, hist = TD.run_afl_rounds(
        step, state, build_provider(tfl, policy_name, None, rounds, 0, "cpu"),
        lambda r: {k: v.flatten(0, 1) for k, v in
                   shard.traced_batch(key, r).items()},
        sample_budgets(tfl, 0), rounds=rounds)
    pts = eval_points(rounds, 3)
    theta = bits = ups = np.float32(0.0)
    theta_mean, bits_mean = [], []
    for r, m in enumerate(hist):
        theta += np.float32(np.sum(m["theta"].numpy()))
        bits += np.float32(np.sum(m["bits"].numpy()))
        ups += np.float32(np.sum(m["success"].numpy()))
        if (r + 1) in pts:
            theta_mean.append(theta / np.float32((r + 1) * N))
            bits_mean.append(bits / max(ups, np.float32(1.0)))
    np.testing.assert_allclose(theta_mean, scan.history["theta_mean"], rtol=1e-6)
    np.testing.assert_allclose(bits_mean, scan.history["bits_mean"], rtol=1e-6)
    assert bits_mean[-1] > 0


def test_telemetry_matches_reference(fed):
    """``telemetry=afl_registry()``: the fetched counters and histogram
    bins equal the reference's ``AFL_REGISTRY`` over the same rounds."""
    cfg, model, fl, rd, rstate = fed[:5]
    rpol = BL.ALL["mads-joint"](model.num_params(), fl)
    rstep = jax.jit(RD.make_afl_train_step(
        model, cfg, rd, rpol.controller, compressor=rpol.compressor,
        telemetry=R_AFL_REGISTRY))
    reg = afl_registry()
    _, step, ts = _t_dist(fed, "mads-joint", telemetry=reg)
    rt, tt = R_AFL_REGISTRY.init_state(), reg.init_state("cpu")
    ckey = rstate.ckey
    for r in range(ROUNDS):
        batch, args = _round_inputs(fed, r)
        seeds, ckey = _ref_seeds(ckey)
        rstate, _, rt = rstep(rstate, _j(batch), *map(jnp.asarray, args), rt)
        ts, _, tt = step(ts, _t(batch), *map(torch.as_tensor, args), tt,
                         seeds=seeds)
    a, b = reg.fetch(tt), R_AFL_REGISTRY.fetch(rt)
    assert a["counters"]["successes"] > 0
    for k in a["hist"]:
        np.testing.assert_array_equal(a["hist"][k], b["hist"][k], err_msg=k)
    for k in ("rounds", "contacts", "successes", "bits_total"):
        assert a["counters"][k] == b["counters"][k], k
    np.testing.assert_allclose(a["counters"]["energy_total"],
                               b["counters"]["energy_total"], rtol=1e-5)
    assert a["gauges"] == b["gauges"]


def test_single_rank_group_bit_equal_to_no_group(fed):
    """The same rounds through a single-rank gloo mesh (its all-reduce and
    all-gather run) equal the rounds without one, bit for bit."""
    mesh = TM.make_client_mesh(N, device="cpu")
    try:
        assert (mesh.rank, mesh.world_size) == (0, 1)
        assert TM.mesh_num_clients(mesh) == 1
        _, step_g, sg = _t_dist(fed, "mads-joint", mesh=mesh)
        _, step_n, sn = _t_dist(fed, "mads-joint")
        for r in range(ROUNDS):
            batch, args = _round_inputs(fed, r)
            args = tuple(map(torch.as_tensor, args))
            sg, mg = step_g(sg, _t(batch), *args)
            sn, mn = step_n(sn, _t(batch), *args)
            assert all(torch.equal(mg[k], mn[k]) for k in mn), r
            for name in STATES:
                assert torch.equal(getattr(sg, name), getattr(sn, name)), name
        sh = TD.client_state_shardings(sg, mesh)
        assert sh.w is None and sh.w_n == slice(0, N) == sh.kappa
    finally:
        mesh.close()


def test_donated_step_equals_the_functional_step(fed):
    """``donate=True`` writes the new state into the old buffers and
    computes the same rounds."""
    _, step_d, sd = _t_dist(fed, "mads", donate=True)
    _, step_f, sf = _t_dist(fed, "mads")
    for r in range(ROUNDS):
        batch, args = _round_inputs(fed, r)
        args = tuple(map(torch.as_tensor, args))
        buffers = [getattr(sd, name).data_ptr() for name in STATES]
        sd, md = step_d(sd, _t(batch), *args)
        sf, mf = step_f(sf, _t(batch), *args)
        assert [getattr(sd, name).data_ptr() for name in STATES] == buffers
        assert all(torch.equal(md[k], mf[k]) for k in mf), r
        for name in STATES:
            assert torch.equal(getattr(sd, name), getattr(sf, name)), name


def test_abstract_state_and_system_bundle():
    tcfg = t_get_config("internlm2-1.8b")
    tmodel = t_build_model(tcfg)
    dcfg = TD.DistConfig(num_clients=2)
    st = TD.abstract_state(tmodel, dcfg)
    s = tmodel.num_params()
    assert s == 1_889_110_016 == build_model(get_config("internlm2-1.8b")).num_params()
    assert st.w.shape == (s,) and st.w.dtype == torch.bfloat16
    assert st.w_n.shape == st.g_n.shape == st.e_n.shape == (2, s)
    assert st.w_n.device.type == "meta" and st.kappa.dtype == torch.int32
    sys_ = TD.make_afl_train_system(tmodel, tcfg, dcfg=dcfg)
    assert {"step", "dcfg", "controller", "compressor", "telemetry",
            "state_shardings", "scalar_sharding", "telemetry_sharding",
            "abstract_state", "init_state"} <= set(sys_)
    assert sys_["abstract_state"]().w_n.shape == (2, s)
    assert sys_["controller"].s == s
    assert TD.DistConfig(num_clients=2) == TD.DistConfig(
        **dataclasses.asdict(RD.DistConfig(num_clients=2)))


# ---------------------------------------------------------------------------
# Two gloo ranks on the CPU (the reference's MESH_SCRIPT)
# ---------------------------------------------------------------------------

RANK_SCRIPT = textwrap.dedent(r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, store_path = int(sys.argv[1]), sys.argv[2]
from repro_torch.compression.base import strict_threshold
from repro_torch.compression.quant import tree_amax
from repro_torch.configs import FLConfig, get_config
from repro_torch.core import baselines as BL
from repro_torch.core import distributed as D
from repro_torch.core.runner import build_provider, sample_budgets
from repro_torch.experiments import DataShard
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.launch.train import build_device_data
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import TreeLayout

mesh = make_client_mesh(4, device="cpu", rank=rank, world_size=2,
                        store=dist.FileStore(store_path, 2))
out = {"rank": mesh.rank, "world": mesh.world_size}

# 1. the group contract: one threshold, exact amax, count in 4 s.e.
x = np.random.default_rng(0).normal(0, 1, 1 << 16).astype(np.float32)
half = x.size // 2
xl = torch.as_tensor(x[rank * half:(rank + 1) * half])[None]
one = TreeLayout((("x",),), ((half,),))
k = 3000.0
t = strict_threshold(xl, one, torch.tensor([k]), method="sampled",
                     sample=4096, group=mesh.group, s=x.size)
ts = [torch.empty_like(t) for _ in range(2)]
dist.all_gather(ts, t)
out["thresholds"] = [float(v) for v in ts]
out["amax"] = float(tree_amax(xl, group=mesh.group)[0])
out["amax_want"] = float(np.abs(x).max())
out["count"] = float(np.sum(np.abs(x) > float(t[0])))

# 2. world 1 against world 2: bits histories of 3 rounds
cfg = get_config("resnet9-cifar10").replace(d_model=4)
model = build_model(cfg)
fl = FLConfig(num_devices=4, rounds=3, batch_size=8, learning_rate=0.02,
              mean_contact=6.0, mean_intercontact=30.0,
              energy_budget=(40.0, 80.0))
dev, _ = build_device_data(cfg, fl, train_n=160, eval_n=32, seed=0)
shard = DataShard(dev, fl.batch_size, seed=0, device="cpu")
key = shard.seed_key(0)
params = model.init(torch.Generator().manual_seed(0))

def run(name, flv, m):
    pol = BL.ALL[name](model.num_params(), flv)
    dc = D.DistConfig(num_clients=4, rounds=3, learning_rate=flv.learning_rate,
                      state_dtype="float32")
    step = D.make_afl_train_step(model, cfg, dc, pol.controller,
                                 compressor=pol.compressor, mesh=m)
    st = D.init_state(model, dc, 0, mesh=m, device="cpu", params=params)
    st, hist = D.run_afl_rounds(
        step, st, build_provider(flv, name, None, 3, 0, "cpu"),
        lambda r: {k_: v.flatten(0, 1)
                   for k_, v in shard.traced_batch(key, r).items()},
        sample_budgets(flv, 0), rounds=3)
    return st, np.stack([h["bits"].numpy() for h in hist])

out["parity"] = {}
for name, flv in (("mads-topk", fl), ("mads-joint", fl),
                  ("mads-joint", dataclasses.replace(fl, per_layer_budget=True)),
                  ("qsgd", fl), ("fixed-kb", fl)):
    tag = name + ("+pl" if flv.per_layer_budget else "")
    s1, b1 = run(name, flv, None)
    s2, b2 = run(name, flv, m=mesh)
    rows = mesh.rows(4)
    out["parity"][tag] = {
        "equal": bool(np.array_equal(b1, b2)), "total": float(b1.sum()),
        "w_off": float((s1.w - s2.w).abs().max()),
        "w_n_off": float((s1.w_n[rows] - s2.w_n).abs().max()),
        "local_rows": int(s2.w_n.shape[0])}
try:
    make_client_mesh(3, device="cpu")
    out["uneven"] = "accepted"
except ValueError as e:
    out["uneven"] = str(e)
mesh.close()
print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, spawned once (each process with its own
    timeout)."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(tmp / "store")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, err[-3000:]
            line = [l for l in out.splitlines() if l.startswith("RESULT ")]
            outs.append(__import__("json").loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_two_ranks_group_contract(two_ranks):
    a, b = two_ranks
    assert (a["rank"], b["rank"], a["world"]) == (0, 1, 2)
    assert a["thresholds"][0] == a["thresholds"][1] == b["thresholds"][0]
    assert a["amax"] == b["amax"] == a["amax_want"]
    k, s = 3000.0, 1 << 16
    se = np.sqrt(k * s / 8192)  # the reference's quantile error model
    assert abs(a["count"] - k) <= 4 * se, (a["count"], se)
    assert "do not split evenly" in a["uneven"]


@pytest.mark.parametrize("tag", ["mads-topk", "mads-joint", "mads-joint+pl",
                                 "qsgd", "fixed-kb"])
def test_two_ranks_bits_equal_world_one(two_ranks, tag):
    """bits histories of world 1 and world 2 equal; w, and each rank's 2
    rows of w_n, within 1e-6 of world 1's (the all-reduce adds in another
    order)."""
    for res in two_ranks:
        p = res["parity"][tag]
        assert p["equal"] and p["total"] > 0, (res["rank"], p)
        assert p["w_off"] <= 1e-6 and p["w_n_off"] <= 1e-6, (res["rank"], p)
        assert p["local_rows"] == 2


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_uneven_clients_and_model_axis_refused():
    mesh = TM.ClientMesh(group=None, rank=1, world_size=2,
                         device=torch.device("cpu"))
    assert mesh.rows(4) == slice(2, 4)
    with pytest.raises(ValueError, match="do not split evenly"):
        mesh.rows(3)
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    with pytest.raises(ValueError, match="do not split evenly"):
        TD.init_state(tmodel, TD.DistConfig(num_clients=3), mesh=mesh)
    # the model axis is ported for every family (test_torch_model_axis*.py):
    # audio's is no longer refused, and an unknown family is
    TM.require_model_axis("audio", 2)
    with pytest.raises(ValueError, match="unknown family"):
        TM.make_client_mesh(4, device="cpu", model=2, family="speech")


def test_rank_slices_of_state_schedule_and_telemetry():
    """Rank 1 of 2 over N = 4: rows 2-3 of the client-stacked state, of the
    (rounds, N) schedule's columns and of the per-device table; the rest
    whole on every rank."""
    from repro_torch.telemetry import DeviceTable, TelemetrySuite, TheoryProbes

    mesh = TM.ClientMesh(group=None, rank=1, world_size=2,
                         device=torch.device("cpu"))
    rows = slice(2, 4)
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    st = TD.abstract_state(tmodel, TD.DistConfig(num_clients=N), mesh)
    assert st.w_n.shape == (2, tmodel.num_params()) and st.q.shape == (2,)
    sh = TD.client_state_shardings(st, mesh)
    assert (sh.w, sh.rnd, sh.gen) == (None, None, None)
    assert sh.w_n == sh.g_n == sh.e_n == sh.kappa == sh.q == sh.energy == rows
    assert TD.scenario_shardings(mesh, N) == {
        "schedule": (slice(None), rows), "state": rows}
    suite = TelemetrySuite(metrics=afl_registry(), device=DeviceTable(N),
                           probes=TheoryProbes(s=100, u=32))
    tel = TD.telemetry_shardings(suite, mesh, N)
    assert tel["device"]["contacts"] == rows and tel["device"]["rounds"] is None
    assert tel["metrics"]["counters"]["rounds"] is None
    assert all(v is None for v in tel["probes"].values())
    assert TD.telemetry_shardings(None, mesh, N) is None


def test_missing_card_raises_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    dcfg = TD.DistConfig(num_clients=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.make_client_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.init_state(tmodel, dcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.make_afl_train_system(tmodel, tmodel.cfg, dcfg=dcfg)["init_state"]()

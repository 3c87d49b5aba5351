"""The port's streaming ingest path against the JAX reference: the wire
format, the arrival buffer, the staleness family, the fused ingest op, the
server, the soak CLI, and the parity of a batch of uploads with the port's
own ``afl_round``.

Both packages get the same numpy inputs.  The wire arrays and the fused
ingest on batches where no two uploads share a coordinate are held bit
for bit; batches with shared coordinates add in another order (XLA's dot
and scatter against torch's), so they are held at rtol 1e-6 / atol 1e-7,
the reference's own scatter-vs-parity tolerance.  Bit for bit needs N (the
population the MES averages over) a power of two: XLA's compiled program
divides by a constant N as a multiply by 1/N, which rounds otherwise than
the quotient unless 1/N is exact (the port divides, correctly rounded), so
at N = 11 the two are held within one ulp.  The parity ingest is
held bit for bit against the port's ``afl_round`` for the four codec
policies (the reference's own ingest misses its ``afl_round`` for three
of them: tests/test_serve.py).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.compression import wire as RW  # noqa: E402
from repro.core.afl import StalenessWeight as RStalenessWeight  # noqa: E402
from repro.serve import ArrivalBuffer as RArrivalBuffer  # noqa: E402
from repro.serve import IngestServer as RIngestServer  # noqa: E402
from repro.serve import make_fused_ingest as r_make_fused_ingest  # noqa: E402
from repro.telemetry import serve_registry as r_serve_registry  # noqa: E402
from repro_torch.compression import wire as W  # noqa: E402
from repro_torch.configs import FLConfig, get_config  # noqa: E402
from repro_torch.core import baselines as BL  # noqa: E402
from repro_torch.core.afl import StalenessWeight, afl_init, afl_round  # noqa: E402
from repro_torch.core.runner import build_provider, sample_budgets  # noqa: E402
from repro_torch.experiments import DataShard  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.launch import soak  # noqa: E402
from repro_torch.launch.train import build_device_data  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import ArrivalBuffer, IngestServer, make_fused_ingest  # noqa: E402
from repro_torch.telemetry import serve_registry  # noqa: E402
from repro_torch.telemetry.tracing import PhaseTracer  # noqa: E402

CODEC_POLICIES = ("mads-topk", "mads-joint", "qsgd", "fixed-kb")
ROUNDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# Arrival buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["reject", "defer"])
def test_backpressure_never_drops_silently(policy):
    """Every offered upload lands in exactly one counter, through an
    overload and a drain, and the port's counters equal the reference's
    after each operation."""
    buf, ref = ArrivalBuffer(3, policy), RArrivalBuffer(3, policy)
    outcomes = [buf.offer(i) for i in range(10)]
    assert outcomes == [ref.offer(i) for i in range(10)]
    assert outcomes == [True] * 3 + [False] * 7
    c = buf.counters()
    assert c == ref.counters()
    assert c["received"] == 10 and c["accepted"] == 3
    assert c["deferred" if policy == "defer" else "rejected"] == 7
    assert c["received"] == c["accepted"] + c["rejected"] + c["deferred"]
    buf.check_invariant()
    assert buf.take(2) == ref.take(2) == [0, 1]
    assert buf.offer(10) is True and ref.offer(10) is True
    assert buf.offer_all(range(11, 14)) == ref.offer_all(range(11, 14)) == 1
    buf.check_invariant()
    c = buf.counters()
    assert c == ref.counters()
    assert c["accepted"] == c["taken"] + c["depth"]
    assert buf.take() == ref.take() == [2, 10, 11]
    assert len(buf) == buf.depth == 0


def test_buffer_validates_construction():
    with pytest.raises(ValueError):
        ArrivalBuffer(capacity=0)
    with pytest.raises(ValueError):
        ArrivalBuffer(capacity=4, policy="drop")


def test_buffer_invariant_catches_lost_uploads():
    buf = ArrivalBuffer(4)
    buf.offer(0)
    buf.received += 1  # an upload that reached no counter
    with pytest.raises(AssertionError, match="arrival accounting"):
        buf.check_invariant()


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------


def _assert_payload_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "WirePayload"
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y and type(x) is type(y), (f, x, y)


def test_wire_grid_codes_roundtrip_bitwise():
    """b < 32: the port's payload equals the reference's field by field,
    and integer grid codes decode as codes * step, the codecs' exact
    float multiply, so the dense payload reproduces bitwise."""
    rng = np.random.default_rng(0)
    step = 7.3e-4
    q = rng.integers(-(2 ** 14), 2 ** 14, size=50).astype(np.int32)
    dense = np.zeros(512, np.float32)
    idx = np.sort(rng.choice(512, 50, replace=False))
    dense[idx] = q.astype(np.float32) * np.float32(step)
    p = W.encode_upload({"x": torch.as_tensor(dense)}, b=15, step=step)
    _assert_payload_equal(p, RW.encode_upload({"x": dense}, b=15, step=step))
    assert p.k == int(np.count_nonzero(dense))
    packed = W.pack_batch([p], s=512, max_k=64, batch=1)
    rpacked = RW.pack_batch([p], s=512, max_k=64, batch=1)
    for k in W.PACKED_KEYS:
        np.testing.assert_array_equal(packed[k], rpacked[k], err_msg=k)
    vals = W.decode_values(packed["codes"], packed["step"], packed["b"])
    np.testing.assert_array_equal(
        _bits(vals), _bits(RW.decode_values(rpacked["codes"], rpacked["step"],
                                            rpacked["b"])))
    out = np.zeros(512, np.float32)
    out[packed["coords"][0][: p.k]] = vals.numpy()[0][: p.k]
    np.testing.assert_array_equal(_bits(out), _bits(dense))


def test_wire_raw_f32_roundtrip_bitwise():
    """b == 32: raw bit patterns survive the int32 bitcast exactly
    (denormals included); -0.0 is not a nonzero coordinate."""
    dense = np.zeros(64, np.float32)
    dense[[1, 7, 33]] = [1e-40, -0.0, 3.14159]
    dense[5] = np.float32(1.1)
    p = W.encode_upload(torch.as_tensor(dense), b=32)
    _assert_payload_equal(p, RW.encode_upload(dense, b=32))
    assert p.k == 3
    packed = W.pack_batch([p], s=64, max_k=8, batch=1)
    vals = W.decode_values(torch.as_tensor(packed["codes"]),
                           torch.as_tensor(packed["step"]),
                           torch.as_tensor(packed["b"])).numpy()
    out = np.zeros(64, np.float32)
    out[packed["coords"][0][: p.k]] = vals[0][: p.k]
    expect = dense.copy()
    expect[7] = 0.0
    np.testing.assert_array_equal(_bits(out), _bits(expect))


def test_wire_padding_is_dropped_and_limits_enforced():
    dense = np.zeros(32, np.float32)
    dense[:6] = 1.0
    with pytest.raises(ValueError):
        W.encode_upload(dense, max_k=4)
    p = W.encode_upload(dense, max_k=8)
    packed = W.pack_batch([p], s=32, max_k=8, batch=2, server_round=5)
    assert (packed["coords"][0][6:] == 32).all()  # pad coord = s
    assert packed["mask"].tolist() == [1.0, 0.0]
    assert packed["dtau"].tolist() == [5.0, 0.0]
    with pytest.raises(ValueError):
        W.pack_batch([p, p, p], s=32, max_k=8, batch=2)
    with pytest.raises(ValueError):
        W.pack_batch([p], s=32, max_k=4, batch=2)
    assert p.bits == 6 * (32 + W.index_bits(32))
    assert [W.index_bits(s) for s in (1, 2, 3, 1024, 6_573_130)] == [
        RW.index_bits(s) for s in (1, 2, 3, 1024, 6_573_130)]


def test_pack_batch_fills_given_arrays_in_place():
    """``out=`` (the server's staging buffer) is refilled in place: a
    second, shorter batch leaves no trace of the first."""
    rng = np.random.default_rng(1)
    ups = [W.encode_upload(rng.standard_normal(16).astype(np.float32)
                           * (rng.random(16) < 0.5), device=i, rnd=-i)
           for i in range(3)]
    out = W.pack_batch(ups, s=16, max_k=16, batch=3)
    again = W.pack_batch(ups[:1], s=16, max_k=16, batch=3, server_round=2,
                         out=out)
    assert again is out
    want = RW.pack_batch(ups[:1], s=16, max_k=16, batch=3, server_round=2)
    for k in W.PACKED_KEYS:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)


def test_encode_tree_of_tensors_equals_reference():
    """A tree of tensors (two leaves, flatten order: sorted keys) encodes
    to the reference's payload of the same numpy tree."""
    rng = np.random.default_rng(2)
    tree = {"b": rng.standard_normal((3, 5)).astype(np.float32),
            "a": rng.standard_normal(7).astype(np.float32)}
    for leaf in tree.values():
        leaf[rng.random(leaf.shape) < 0.6] = 0.0
    p = W.encode_upload({k: torch.as_tensor(v) for k, v in tree.items()},
                        device=3, rnd=-2, ok=0.0)
    _assert_payload_equal(p, RW.encode_upload(tree, device=3, rnd=-2, ok=0.0))
    assert np.all(np.diff(p.coords) > 0)


# ---------------------------------------------------------------------------
# Staleness family
# ---------------------------------------------------------------------------


STALENESS = {
    "constant": dict(family="constant", alpha=0.25),
    "hinge": dict(family="hinge", alpha=0.7, hinge_a=2.0, hinge_b=4.0),
    "poly": dict(family="poly", alpha=0.5, poly_a=0.5),
}


@pytest.mark.parametrize("name", sorted(STALENESS))
def test_staleness_weights_equal_reference(name):
    dtau = np.arange(0.0, 65.0, dtype=np.float32)
    got = StalenessWeight(**STALENESS[name]).weight(torch.as_tensor(dtau))
    want = RStalenessWeight(**STALENESS[name]).weight(jnp.asarray(dtau))
    if name == "poly":  # pow: torch and XLA may differ by an ulp
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    s = StalenessWeight(**STALENESS[name]).s(torch.as_tensor(dtau)).numpy()
    assert s[0] == 1.0 and np.all(np.diff(s) <= 0) and np.all(s > 0)


def test_staleness_validates_family():
    with pytest.raises(ValueError):
        StalenessWeight(family="exp").s(1.0)
    assert StalenessWeight().is_identity
    assert not StalenessWeight(alpha=0.25).is_identity


# ---------------------------------------------------------------------------
# Fused ingest against the reference's
# ---------------------------------------------------------------------------


def _batch(rng, s, b, k, shared: bool, quantised: bool):
    """b uploads of k coordinates each over s; ``shared``: drawn
    independently (coordinates collide), else disjoint.  Half the rows are
    grid codes when ``quantised``."""
    cols = (rng.choice(s, b * k, replace=False).reshape(b, k) if not shared
            else np.stack([rng.choice(s, k, replace=False) for _ in range(b)]))
    ups = []
    for i in range(b):
        dense = np.zeros(s, np.float32)
        if quantised and i % 2:
            step = 1e-3 * (i + 1)
            q = rng.integers(-127, 128, size=k)
            q[q == 0] = 1
            dense[cols[i]] = q.astype(np.float32) * np.float32(step)
            kw = dict(b=8.0, step=step)
        else:
            dense[cols[i]] = rng.standard_normal(k).astype(np.float32)
            kw = {}
        ups.append(RW.encode_upload({"a": dense[: s // 2], "b": dense[s // 2:]},
                                    device=i, rnd=-3 * i, **kw))
    return ups


def _flat_ref(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(-1)
                           for l in jax.tree.leaves(tree)])


def test_compiled_reference_divides_by_the_reciprocal():
    """Why bitwise cases use N = 16: the reference's jitted ``x / 11`` is
    ``x * (1/11)``, not the quotient; at 16 the two are equal."""
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    for n, differs in ((11, True), (16, False)):
        jitted = np.asarray(jax.jit(lambda a: a / n)(jnp.asarray(x)))
        port = (torch.as_tensor(x) / torch.tensor(float(n))).numpy()
        np.testing.assert_array_equal(port, x / np.float32(n))
        assert bool(np.any(jitted != port)) == differs
        np.testing.assert_array_max_ulp(jitted, port, maxulp=1)


@pytest.mark.parametrize("num_devices", [16, 11])
@pytest.mark.parametrize("shared", [False, True], ids=["disjoint", "shared"])
@pytest.mark.parametrize("staleness", sorted(STALENESS))
@pytest.mark.parametrize("mode", ["parity", "scatter"])
def test_fused_ingest_matches_reference(mode, staleness, shared, num_devices):
    """The same packed batch through both packages' fused ingest: weights
    bit-equal when no two uploads share a coordinate (within one ulp at
    N = 11, see above), else within rtol 1e-6 / atol 1e-7, as under the
    ``poly`` family, whose mixing weights (a pow) may be an ulp apart; the
    registry snapshots' counters and bins equal."""
    rng = np.random.default_rng(3)
    s, B, Kmax = 256, 8, 16
    w_np = {"a": rng.standard_normal(s // 2).astype(np.float32),
            "b": rng.standard_normal(s // 2).astype(np.float32)}
    ups = _batch(rng, s, B - 1, Kmax, shared, quantised=True)
    packed = RW.pack_batch(ups, s=s, max_k=Kmax, batch=B, server_round=2)
    kw = dict(batch=B, max_k=Kmax, num_devices=num_devices, mode=mode)
    sw = StalenessWeight(**STALENESS[staleness])
    reg, rreg = serve_registry(), r_serve_registry()
    ingest = make_fused_ingest(
        {k: torch.as_tensor(v) for k, v in w_np.items()}, staleness=sw,
        registry=reg, **kw)
    r_ingest = r_make_fused_ingest(
        {k: jnp.asarray(v) for k, v in w_np.items()},
        staleness=RStalenessWeight(**STALENESS[staleness]), registry=rreg,
        **kw)
    w0 = torch.as_tensor(np.concatenate([w_np["a"], w_np["b"]]))
    got, ts = ingest(w0, packed, reg.init_state())
    want, rts = r_ingest({k: jnp.asarray(v) for k, v in w_np.items()},
                         {k: jnp.asarray(v) for k, v in packed.items()},
                         rreg.init_state())
    want = _flat_ref(want)
    if shared or staleness == "poly":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    elif num_devices == 11:
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.array_equal(got.numpy(), w0.numpy())
    snap, rsnap = reg.fetch(ts), rreg.fetch(rts)
    for name in ("batches", "ingested", "bits_ingested"):
        assert snap["counters"][name] == rsnap["counters"][name], name
    np.testing.assert_allclose(snap["counters"]["weight_sum"],
                               rsnap["counters"]["weight_sum"], rtol=1e-6)
    assert snap["gauges"] == rsnap["gauges"]
    for name, counts in rsnap["hist"].items():
        np.testing.assert_array_equal(snap["hist"][name], counts, err_msg=name)


def test_scatter_mode_matches_parity_mode():
    """The O(B K) scatter mode agrees with the parity mode to float
    tolerance (bitwise when no two uploads share a coordinate)."""
    rng = np.random.default_rng(4)
    s, B, Kmax = 256, 8, 16
    w = torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    sw = StalenessWeight(family="hinge", alpha=0.7)
    for shared in (False, True):
        packed = W.pack_batch(_batch(rng, s, B, Kmax, shared, False), s=s,
                              max_k=Kmax, batch=B)
        outs = {mode: make_fused_ingest(w, batch=B, max_k=Kmax, num_devices=B,
                                        staleness=sw, mode=mode)(
                    w, packed, {})[0] for mode in ("parity", "scatter")}
        if shared:
            np.testing.assert_allclose(outs["parity"].numpy(),
                                       outs["scatter"].numpy(),
                                       rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(outs["parity"], outs["scatter"])


def test_fused_ingest_validates_mode():
    with pytest.raises(ValueError, match="mode"):
        make_fused_ingest(torch.zeros(4), batch=1, max_k=1, num_devices=1,
                          mode="dense")


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


def test_server_counts_backpressure_in_registry():
    """Rejected uploads surface in the snapshot, equal to the reference
    server's on the same offers."""
    snaps = []
    for server, arr in ((IngestServer, torch.zeros),
                        (RIngestServer, lambda n: jnp.zeros((n,), jnp.float32))):
        srv = server({"a": arr(16)}, num_devices=4, batch=2, max_k=4,
                     queue_capacity=2, queue_policy="reject")
        ups = [W.encode_upload({"a": np.eye(16, dtype=np.float32)[i]},
                               device=i) for i in range(5)]
        assert [srv.submit(p) for p in ups] == [True, True, False, False,
                                                False]
        assert srv.drain() == 2
        snaps.append(srv.snapshot())
    snap, rsnap = snaps
    assert snap["counters"] == rsnap["counters"]
    assert snap["gauges"] == rsnap["gauges"]
    assert snap["counters"]["rejected"] == 3
    assert snap["counters"]["ingested"] == 2
    assert snap["gauges"]["queue_peak"] == 2


def test_server_applies_staleness_weights():
    """weight_sum equals sum(alpha * s(dtau)) over the ingested uploads,
    and the model reflects the discount."""
    s = 32
    sw = StalenessWeight(family="poly", alpha=0.5, poly_a=1.0)
    dense = np.zeros(s, np.float32)
    dense[3] = 4.0
    srv = IngestServer({"a": torch.zeros(s)}, num_devices=1, batch=4,
                       max_k=4, staleness=sw)
    for i in range(3):
        srv.submit(W.encode_upload({"a": dense}, device=i, rnd=-i))
    assert srv.step() == 3 and srv.rnd == 1
    snap = srv.snapshot()
    expect = 0.5 * np.asarray([1.0, 1.0 / 2.0, 1.0 / 3.0])
    np.testing.assert_allclose(snap["counters"]["weight_sum"], expect.sum(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(srv.w[3]),
                               -4.0 * expect.sum(), rtol=1e-6)


def test_empty_step_is_identity():
    srv = IngestServer({"a": torch.ones(8)}, num_devices=2, batch=2, max_k=2)
    assert srv.step() == 0 and srv.rnd == 0
    assert torch.equal(srv.w, torch.ones(8))
    snap = srv.snapshot()
    assert snap["counters"]["batches"] == 0
    assert snap["gauges"]["server_round"] == 0


def test_server_traces_pack_and_ingest_spans():
    tracer = PhaseTracer()
    srv = IngestServer(torch.zeros(8), num_devices=2, batch=2, max_k=2,
                       tracer=tracer)
    srv.submit(W.encode_upload(np.eye(8, dtype=np.float32)[1]))
    assert srv.drain() == 1
    assert {k: v["count"] for k, v in tracer.totals().items()} == {
        "serve.pack": 1, "serve.ingest": 1}
    assert float(srv.w[1]) == -0.5


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="item 5"):
        IngestServer(torch.zeros(4), num_devices=1, batch=1, max_k=1,
                     mesh=object())
    with pytest.raises(NotImplementedError, match="item 5"):
        soak.main(["--mesh", "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Parity with the port's afl_round: a batch of N uploads is one round
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def federation():
    """The reference's fixture (tests/test_serve.py): ResNet-9 at width 4,
    N = 4."""
    cfg = get_config("resnet9-cifar10").replace(d_model=4)
    model = build_model(cfg)
    fl = FLConfig(
        num_devices=4, rounds=ROUNDS, batch_size=8, learning_rate=0.02,
        mean_contact=6.0, mean_intercontact=30.0, energy_budget=(40.0, 80.0),
    )
    dev, _ = build_device_data(cfg, fl, train_n=160, eval_n=64, seed=0)
    shard = DataShard(dev, fl.batch_size, seed=0, device="cpu")
    return model, fl, shard


@pytest.mark.parametrize("policy_name", CODEC_POLICIES)
def test_parity_ingest_bitwise_matches_afl_round(federation, policy_name):
    """Every round's uploads, encoded to the wire and driven through the
    server at batch = N, land on exactly the weights ``afl_round``
    produced, after every round: all four codecs hold bit for bit."""
    model, fl, shard = federation
    n = fl.num_devices
    policy = dataclasses.replace(
        BL.ALL[policy_name](model.num_params(), fl), expose_uploads=True)
    provider = build_provider(fl, policy_name, None, ROUNDS, 0, "cpu")
    budgets = torch.as_tensor(sample_budgets(fl, 0))
    state = afl_init(model, fl, 0, "cpu")
    srv = IngestServer(state.w.clone(), num_devices=n, batch=n,
                       max_k=model.num_params(), queue_capacity=n)
    key = shard.seed_key(0)
    shipped = 0.0
    for r in range(ROUNDS):
        z, t, h2 = provider.round(r)
        state, m = afl_round(
            state, shard.traced_batch(key, r), torch.as_tensor(z),
            torch.as_tensor(t, dtype=torch.float32),
            torch.as_tensor(h2, dtype=torch.float32), budgets,
            model=model, fl=fl, policy=policy)
        b, step, okf = (m[k].to(torch.float64).numpy()
                        for k in ("b", "upload_step", "uploads"))
        for i in range(n):
            # quantised codecs ship grid codes at the codec's (step, b);
            # b = 0 (withheld) and b = 32 rows ride the raw-f32 path
            p = W.encode_upload(m["upload"][i], b=b[i] if b[i] > 0 else 32.0,
                                step=float(step[i]), device=i, ok=float(okf[i]))
            assert srv.submit(p)
            shipped += p.k * okf[i]
        assert srv.step() == n
        np.testing.assert_array_equal(_bits(srv.w), _bits(state.w),
                                      err_msg=f"{policy_name} round {r}")
    assert shipped > 0  # parity is not vacuous
    snap = srv.snapshot()
    assert snap["counters"]["batches"] == ROUNDS
    srv.buffer.check_invariant()


def test_expose_uploads_is_off_in_the_engines(federation):
    model, fl, _ = federation
    for name in CODEC_POLICIES + ("mads",):
        assert not BL.ALL[name](model.num_params(), fl).expose_uploads


# ---------------------------------------------------------------------------
# The soak CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["topk", "topk32", "joint", "fixed-kb"])
def test_soak_smoke_point(codec):
    """The reference's ``--smoke`` point (1500 uploads, s = 2048, batch and
    max_k 128), hinge staleness: the counters add up, and every payload
    has k <= max_k, ascending coordinates and bits by eq. 7c.  One codec
    pass per chunk of 512 uploads, each one kernel call; the payloads then
    go through ``ingest_soak``, ``run_soak``'s server half."""
    s, max_k = 2048, 128
    K.reset_launches()
    payloads = soak.make_payloads(1500, s, max_k, codec=codec, device="cpu")
    assert sum(K.LAUNCHES.values()) == 0  # the CPU runs the plain versions
    assert len(payloads) == 1500
    for i, p in enumerate(payloads):
        assert 0 < p.k <= max_k and p.device == i and -32 < p.rnd <= 0
        assert np.all(np.diff(p.coords) > 0) and p.coords[-1] < s
        quantised = p.b < 32
        assert p.bits == p.k * (p.b + W.index_bits(s)) + 32 * quantised
        assert (p.b == 32.0) == (codec == "topk32")
    res = soak.ingest_soak(payloads, s=s, max_k=max_k, batch=128,
                           staleness_family="hinge", baseline_n=64,
                           device="cpu")
    c = res["snapshot"]["counters"]
    assert c["received"] == c["accepted"] + c["rejected"] + c["deferred"]
    assert c["accepted"] == c["ingested"] == 1500
    assert c["deferred"] > 0  # the queue (4 x batch) overflowed and deferred
    assert res["fused_per_s"] > 0 and res["speedup_vs_loop"] > 0
    assert np.isfinite(res["server"].w.numpy()).all()


def test_soak_cli_writes_bench_file(tmp_path, capsys):
    res = soak.main(["--smoke", "--uploads", "300", "--device", "cpu",
                     "--no-baseline", "--out-dir", str(tmp_path)])
    assert res["snapshot"]["counters"]["ingested"] == 300
    with open(os.path.join(tmp_path, "BENCH_serve.json")) as f:
        bench = json.load(f)
    assert bench["suite"] == "serve"
    assert bench["rows"][0]["name"] == "soak_topk_constant_n300_b128_s2048"
    assert "uploads_per_s" in bench["rows"][0]["metrics"]
    assert "soak_topk_constant" in capsys.readouterr().out

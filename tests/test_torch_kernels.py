"""The port's sparsify kernels: plain versions against the JAX reference.

On the CPU the dispatch (``repro_torch.kernels.ops``) runs the kernels'
plain versions; they are held bit-equal (uploads, counts) and within 1e-6
(errors) to the reference's oracles and to its Pallas kernels in interpret
mode.  The CUDA kernels themselves are held to the plain versions on the
card by tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.compression import quant as JQ  # noqa: E402
from repro.compression.quant import dither_u01 as j_dither  # noqa: E402
from repro.kernels.ref import sparsify_ef_ref, sparsify_quantize_ef_ref  # noqa: E402
from repro.kernels.sparsify_ef import sparsify_ef, sparsify_quantize_ef  # noqa: E402
from repro_torch.compression import quant as TQ  # noqa: E402
from repro_torch.compression.quant import dither_u01  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402

RNG = np.random.default_rng(0)
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
T_EF = [0.0, 0.3, 1.5, np.inf]
T_Q = [0.0, 0.7, np.inf]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes: torch's intra-op threads only contend with the
    other test workers (measured 3x slower with 8 threads than with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.to(torch.float32).numpy()


def _rows(n, dt):
    """Three rows of n normals, as the reference's dtype and the port's."""
    x = RNG.normal(0, 1, (3, n)).astype(np.float32)
    return jnp.asarray(x, dt[0]), torch.tensor(x).to(dt[1])


@pytest.mark.parametrize("n", [7, 128, 4096])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_sparsify_ef_plain_matches_pallas_interpret(n, dt):
    xj, xt = _rows(n, dt)
    for t in T_EF:
        up, err, cnt = ops.sparsify_ef(xt, torch.full((3,), t))
        for r in range(3):
            u, e, c = sparsify_ef(xj[r], jnp.float32(t), interpret=True)
            np.testing.assert_array_equal(_t(up[r]), _np(u))
            np.testing.assert_array_equal(_t(err[r]), _np(e))
            assert float(cnt[r]) == float(c), (n, t)


@pytest.mark.parametrize("n", [7, 128, 4096])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_sparsify_quantize_ef_plain_matches_pallas_interpret(n, dt):
    xj, xt = _rows(n, dt)
    steps = torch.tensor([0.01, 0.02, 0.05])
    levels = torch.tensor([127.0, 7.0, 32767.0])
    seeds = torch.tensor([1234, -77, 2**31 - 2], dtype=torch.int32)
    for t in T_Q:
        up, err, cnt = ops.sparsify_quantize_ef(
            xt, torch.full((3,), t), steps, levels, seeds, base=5)
        for r in range(3):
            u, e, c = sparsify_quantize_ef(
                xj[r], jnp.float32(t), jnp.float32(float(steps[r])),
                jnp.float32(float(levels[r])), int(seeds[r]), 5,
                interpret=True)
            np.testing.assert_array_equal(_t(up[r]), _np(u))
            np.testing.assert_allclose(_t(err[r]), _np(e), atol=1e-6)
            assert float(cnt[r]) == float(c), (n, t)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_plain_versions_match_oracles_at_300001(dt):
    xj, xt = _rows(300001, dt)
    for t in T_EF:
        up, err, cnt = ops.sparsify_ef(xt, torch.full((3,), t))
        u, e, c = sparsify_ef_ref(xj[1], jnp.float32(t))
        np.testing.assert_array_equal(_t(up[1]), _np(u))
        np.testing.assert_array_equal(_t(err[1]), _np(e))
        assert float(cnt[1]) == float(c)
    for t in T_Q:
        up, err, cnt = ops.sparsify_quantize_ef(
            xt, torch.full((3,), t), torch.full((3,), 0.01),
            torch.full((3,), 127.0), torch.tensor([9, 99, 999], dtype=torch.int32),
            base=300001 * 2)
        u, e, c = sparsify_quantize_ef_ref(xj[2], jnp.float32(t), 0.01, 127.0,
                                           999, base=300001 * 2)
        np.testing.assert_array_equal(_t(up[2]), _np(u))
        np.testing.assert_allclose(_t(err[2]), _np(e), atol=1e-6)
        assert float(cnt[2]) == float(c)


def test_batched_call_equals_per_row_reference_with_base():
    """One (N, s) call = N per-row reference calls; a multi-leaf message's
    leaf at flat offset o draws its dither at base o + index."""
    x = RNG.normal(0, 1, (4, 1000)).astype(np.float32)
    t = np.array([0.5, -np.inf, np.inf, 1.0], np.float32)
    t[1] = np.nextafter(np.float32(-np.inf), np.float32(0))
    steps = np.array([0.1, 0.01, 0.2, 0.05], np.float32)
    seeds = np.array([3, 5, 7, 11], np.int32)
    up, err, cnt = ops.sparsify_quantize_ef(
        torch.tensor(x), torch.tensor(t), torch.tensor(steps),
        torch.full((4,), 127.0), torch.tensor(seeds))
    assert cnt.tolist()[1] == 1000.0 and cnt.tolist()[2] == 0.0
    for r in range(4):
        for lo, hi in [(0, 300), (300, 1000)]:  # two "leaves" of one row
            u, e, c = sparsify_quantize_ef_ref(
                jnp.asarray(x[r, lo:hi]), jnp.float32(t[r]),
                jnp.float32(steps[r]), jnp.float32(127.0), int(seeds[r]),
                base=lo)
            np.testing.assert_array_equal(up[r, lo:hi].numpy(), _np(u))
            np.testing.assert_allclose(err[r, lo:hi].numpy(), _np(e), atol=1e-6)
    up1, _, cnt1 = ops.sparsify_ef(torch.tensor(x), torch.tensor(t))
    for r in range(4):
        u, _, c = sparsify_ef_ref(jnp.asarray(x[r]), jnp.float32(t[r]))
        np.testing.assert_array_equal(up1[r].numpy(), _np(u))
        assert float(cnt1[r]) == float(c)


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 2, -5])
def test_dither_bit_equal(seed):
    idx = np.arange(0, 200_000, dtype=np.int64) * 7919 + 123
    ref = np.asarray(j_dither(jnp.int32(seed), jnp.asarray(idx, jnp.int32)))
    got = dither_u01(torch.tensor(seed), torch.tensor(idx)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_quant_primitives_bit_equal():
    b = np.arange(0, 18, dtype=np.float32)
    levels = TQ.quant_levels(torch.tensor(b))
    np.testing.assert_array_equal(levels.numpy(), np.asarray(JQ.quant_levels(b)))
    amax = np.array([0.0, 1e-13, 0.37, 5.0], np.float32)
    lv = np.array([1.0, 7.0, 127.0, 32767.0], np.float32)
    np.testing.assert_array_equal(
        TQ.quant_step(torch.tensor(amax), torch.tensor(lv)).numpy(),
        np.asarray(JQ.quant_step(jnp.asarray(amax), jnp.asarray(lv))))
    x = RNG.normal(0, 1, (16, 33)).astype(np.float32)
    got = TQ.stochastic_round(torch.tensor(x), 0.05, 31.0, 77, base=1000)
    ref = JQ.stochastic_round(jnp.asarray(x), jnp.float32(0.05),
                              jnp.float32(31.0), 77, base=1000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(TQ.tree_amax(torch.tensor(x).reshape(-1))) == float(
        JQ.tree_amax({"x": jnp.asarray(x)}))


def test_cpu_tensor_takes_plain_path_and_counts_nothing():
    K.reset_launches()
    x = torch.randn(2, 64)
    ops.sparsify_ef(x, torch.zeros(2))
    ops.sparsify_quantize_ef(x, torch.zeros(2), torch.ones(2), torch.ones(2),
                             torch.zeros(2, dtype=torch.int32))
    ops.sparsify_quantize_ef_segmented(
        x, torch.zeros(2, 3), torch.ones(2, 3), torch.ones(2, 3),
        torch.zeros(2, dtype=torch.int32), (0, 10, 11, 64))
    ops.sparsify_quantize_ef_blocks(
        x, torch.zeros(2, 2), torch.ones(2, 2), torch.ones(2, 2),
        torch.zeros(2, dtype=torch.int32), (0, 16, 64),
        ((0, 4, 8, True), (40, 48, 96, False)))
    assert K.LAUNCHES == {"sparsify_ef": 0, "sparsify_quantize_ef": 0,
                          "sparsify_quantize_ef_segmented": 0}
    with pytest.raises(ValueError, match="CUDA"):
        K.sparsify_ef_cuda(x, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        K.sparsify_quantize_ef_segmented_cuda(
            x, torch.zeros(2, 1), torch.ones(2, 1), torch.ones(2, 1),
            torch.zeros(2, dtype=torch.int32), (0, 64))
    with pytest.raises(ValueError, match="CUDA"):
        K.sparsify_quantize_ef_blocks_cuda(
            x, torch.zeros(2, 1), torch.ones(2, 1), torch.ones(2, 1),
            torch.zeros(2, dtype=torch.int32), (0, 64), ((0, 64, 64, True),))


# ---------------------------------------------------------------------------
# Index range: the dither column wraps mod 2^32, counts above 2^24
# ---------------------------------------------------------------------------


def _int32(base: int) -> int:
    """``base`` mod 2^32 as the signed int32 with the same bits: the index
    the reference's int32 arithmetic holds after wrapping."""
    return (base + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("base", [2**31 - 100, 2**31, 2**32 - 100, 2**32,
                                  3 * 2**32 + 7, 2**40 + 12345])
def test_plain_dither_column_wraps_like_the_reference(base):
    """The plain ``sparsify_quantize_ef`` at a ``base`` whose columns pass
    2^31 or 2^32 equals the reference's jnp oracle (its int32 index wraps,
    and the uint32 cast reads it mod 2^32) and its own call at base mod
    2^32: uploads and counts bit-equal, errors within 1e-6."""
    n = 300
    x = RNG.normal(0, 1, (2, n)).astype(np.float32)
    t = torch.tensor([0.0, 0.7])
    steps = torch.tensor([0.01, 0.05])
    levels = torch.tensor([127.0, 7.0])
    seeds = torch.tensor([1234, -5], dtype=torch.int32)
    up, err, cnt = ops.sparsify_quantize_ef(torch.tensor(x), t, steps, levels,
                                            seeds, base=base)
    same = ops.sparsify_quantize_ef(torch.tensor(x), t, steps, levels, seeds,
                                    base=base % 2**32)
    for a, b in zip((up, err, cnt), same):
        assert torch.equal(a, b)
    for r in range(2):
        u, e, c = sparsify_quantize_ef_ref(
            jnp.asarray(x[r]), jnp.float32(t[r]), jnp.float32(steps[r]),
            jnp.float32(levels[r]), int(seeds[r]), base=_int32(base))
        np.testing.assert_array_equal(_t(up[r]), _np(u))
        np.testing.assert_allclose(_t(err[r]), _np(e), atol=1e-6)
        assert float(cnt[r]) == float(c)


def test_column_past_2_32_draws_what_column_0_draws():
    """At base = 2^32 - 100, column 100 (flat index 2^32) draws the dither
    of column 0 at base 0, and so quantises the same value alike."""
    base = 2**32 - 100
    seed = torch.tensor([77], dtype=torch.int32)
    u = dither_u01(seed, base + torch.arange(200))
    assert float(u[100]) == float(dither_u01(seed, torch.tensor([0]))[0])
    x = torch.tensor(RNG.normal(0, 1, (1, 200)).astype(np.float32))
    x0 = x[:, 100:101].clone()
    args = (torch.zeros(1), torch.tensor([0.01]), torch.tensor([127.0]), seed)
    up = ops.sparsify_quantize_ef(x, *args, base=base)[0]
    up0 = ops.sparsify_quantize_ef(x0, *args, base=0)[0]
    assert float(up[0, 100]) == float(up0[0, 0])


def test_count_above_2_24_within_one_ulp():
    """A row just over 2^24 f32 elements with nearly all of them kept: the
    port's count (the exact int64 total, rounded to f32 once) is within
    one f32 ulp of the count the reference's Pallas kernel gives (its
    per-block f32 counts summed in f32), run as the reference's tests run
    it (interpret mode on the CPU), for both entries."""
    n = 2**24 + 2**18 + 3
    x = np.random.default_rng(24).normal(0, 1, n).astype(np.float32)
    t = np.float32(1e-3)
    want = int(np.sum(np.abs(x) >= t))
    assert want > 2**24
    ulp = float(np.spacing(np.float32(want)))
    xt = torch.tensor(x)[None]
    cnt = ops.sparsify_ef(xt, torch.tensor([t]))[2]
    qcnt = ops.sparsify_quantize_ef(
        xt, torch.tensor([t]), torch.tensor([0.01]), torch.tensor([127.0]),
        torch.tensor([5], dtype=torch.int32))[2]
    assert float(cnt[0]) == float(qcnt[0]) == float(np.float32(want))
    ref = float(sparsify_ef(jnp.asarray(x), jnp.float32(t))[2])
    qref = float(sparsify_quantize_ef(jnp.asarray(x), jnp.float32(t),
                                      jnp.float32(0.01), jnp.float32(127.0),
                                      5, 0)[2])
    for r in (ref, qref):
        assert abs(float(cnt[0]) - r) <= ulp, (float(cnt[0]), r, want, ulp)

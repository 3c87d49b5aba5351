"""The plain versions of the LLM kernels against the reference's Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and
their oracles, at the reference test's shapes and tolerances: 2e-5 (f32)
and 3e-2 (bf16) for decode attention, 2e-4 for the SSD scan.  Inputs are
drawn with numpy from one seed and handed to both packages; bf16 inputs
are rounded to nearest-even on both sides, so they are bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import decode_attn  # noqa: E402
from repro.kernels.ref import decode_attn_ref, ssd_scan_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RNG = np.random.default_rng(0)
TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(shape, dtype, scale=1.0):
    a = RNG.normal(0, scale, shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(TORCH_DT[dtype])


@pytest.mark.parametrize(
    "b,h,kv,s,d", [(2, 8, 2, 1024, 64), (1, 4, 4, 512, 128), (2, 6, 2, 777, 64),
                   (1, 16, 2, 2048, 128)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attn_plain_matches_pallas_and_ref(b, h, kv, s, d, dtype):
    qj, qt = _both((b, h, d), dtype)
    kj, kt = _both((b, s, kv, d), dtype)
    vj, vt = _both((b, s, kv, d), dtype)
    length = int(0.7 * s)
    got = ops.decode_attn(qt, kt, vt, length)
    assert got.dtype == qt.dtype and tuple(got.shape) == (b, h, d)
    got = got.float().numpy()
    tol = 2e-5 if dtype == jnp.float32 else 3e-2
    for want in (decode_attn(qj, kj, vj, length), decode_attn_ref(qj, kj, vj, length)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_decode_attn_plain_ignores_masked_tail():
    """Entries beyond `length` must not affect the result."""
    b, h, kv, s, d = 1, 4, 2, 512, 64
    _, q = _both((b, h, d), jnp.float32)
    _, k = _both((b, s, kv, d), jnp.float32)
    _, v = _both((b, s, kv, d), jnp.float32)
    out1 = ref.decode_attn_plain(q, k, v, 100)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 1e4
    v2[:, 100:] = -1e4
    assert torch.equal(out1, ref.decode_attn_plain(q, k2, v2, 100))


@pytest.mark.parametrize(
    "b,s,h,p,n,q", [(2, 256, 4, 64, 32, 64), (1, 128, 2, 32, 16, 32),
                    (1, 512, 8, 64, 64, 128)])
def test_ssd_scan_plain_matches_pallas_and_sequential_ref(b, s, h, p, n, q):
    x = RNG.normal(0, 1, (b, s, h, p)).astype(np.float32)
    a = -np.abs(RNG.normal(0, 0.5, (b, s, h))).astype(np.float32)
    bb = RNG.normal(0, 1, (b, s, n)).astype(np.float32)
    cc = RNG.normal(0, 1, (b, s, n)).astype(np.float32)
    y, st = ops.ssd_scan(*(torch.from_numpy(t) for t in (x, a, bb, cc)), q)
    assert tuple(y.shape) == (b, s, h, p) and tuple(st.shape) == (b, h, p, n)
    jx = [jnp.asarray(t) for t in (x, a, bb, cc)]
    for yr, sr in (ssd_scan(*jx, chunk=q), ssd_scan_ref(*jx)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=2e-4, atol=2e-4)

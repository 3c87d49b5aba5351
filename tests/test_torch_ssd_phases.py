"""The plain versions of the ``ssd_scan`` kernel's five phases
(``kernels/ref.py``: cumsum, C Bᵀ, chunk states, state passing, chunk
output) and ``decode_attn``'s split of the cache across blocks, on the CPU.

The phases, composed, are held to the reference's Pallas ``ssd_scan``
(interpret mode, as ``tests/test_kernels.py`` runs it) and its sequential
oracle ``ssd_scan_ref`` at the reference test's shapes and 2e-4, as
``tests/test_torch_llm_kernels.py`` holds ``ssd_scan_plain``; each phase is
held to a direct numpy evaluation; and the composition, which keeps the
in-chunk log decays in f64 as the kernel does, is held at 2e-4 to the
chunked formula evaluated in f64 at chunk 256 with a ~ -0.4 a step (where
the f32 formula is ~1e-3 off) and with a = -10 a step (the overflow
guard).  Inputs are drawn with numpy from one seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_scan_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels import decode_attn as DA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, p, n, a_kind="normal", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    if a_kind == "normal":  # the reference test's draw
        a = -np.abs(rng.normal(0, 0.5, (b, s, h))).astype(np.float32)
    elif a_kind == "-0.4":
        a = (-0.4 + 0.05 * rng.normal(0, 1, (b, s, h))).astype(np.float32)
    else:
        a = np.full((b, s, h), -10.0, np.float32)
    bb = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    cc = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    return x, a, bb, cc


@pytest.mark.parametrize(
    "b,s,h,p,n,q", [(2, 256, 4, 64, 32, 64), (1, 128, 2, 32, 16, 32),
                    (1, 512, 8, 64, 64, 128)])
def test_ssd_phases_match_pallas_and_sequential_ref(b, s, h, p, n, q):
    x, a, bb, cc = _inputs(b, s, h, p, n)
    y, st = ref.ssd_scan_phases(*(torch.from_numpy(t) for t in (x, a, bb, cc)), q)
    assert tuple(y.shape) == (b, s, h, p) and tuple(st.shape) == (b, h, p, n)
    assert y.dtype == st.dtype == torch.float32
    jx = [jnp.asarray(t) for t in (x, a, bb, cc)]
    for yr, sr in (ssd_scan(*jx, chunk=q), ssd_scan_ref(*jx)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,a_kind", [((1, 512, 2, 16, 32, 256), "-0.4"),
                                          ((1, 512, 2, 16, 32, 256), "-10"),
                                          ((2, 256, 3, 8, 16, 256), "normal")])
def test_ssd_phases_hold_the_f64_formula(shape, a_kind):
    b, s, h, p, n, q = shape
    ts = [torch.from_numpy(t) for t in _inputs(b, s, h, p, n, a_kind, seed=1)]
    y, st = ref.ssd_scan_phases(*ts, q)
    yr, sr = ssd_chunked(*(t.double() for t in ts), q)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y.double(), yr, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st.double(), sr, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q", [32, 96])
def test_ssd_chunk_cumsum_and_cb(q):
    b, s, h, p, n = 2, 192, 3, 8, 12
    x, a, bb, cc = _inputs(b, s, h, p, n, seed=2)
    acum = ref.ssd_chunk_cumsum(torch.from_numpy(a), q)
    want = np.cumsum(a.astype(np.float64).reshape(b, s // q, q, h), axis=2)
    assert acum.dtype == torch.float64
    np.testing.assert_allclose(acum.numpy(), want, rtol=1e-12, atol=1e-12)
    cb = ref.ssd_cb(torch.from_numpy(bb), torch.from_numpy(cc), q)
    br, cr = bb.reshape(b, s // q, q, n), cc.reshape(b, s // q, q, n)
    np.testing.assert_allclose(cb.numpy(), np.einsum("bcln,bcsn->bcls", cr, br),
                               rtol=1e-5, atol=1e-5)


def test_ssd_chunk_states_and_state_pass():
    b, s, h, p, n, q = 2, 128, 3, 4, 6, 32
    x, a, bb, cc = _inputs(b, s, h, p, n, seed=3)
    acum = ref.ssd_chunk_cumsum(torch.from_numpy(a), q)
    states = ref.ssd_chunk_states(torch.from_numpy(x), torch.from_numpy(bb), acum)
    nc = s // q
    A = acum.numpy()
    want = np.zeros((b, h, nc, p, n))
    for c in range(nc):
        for t in range(q):
            d = np.exp(A[:, c, -1] - A[:, c, t])  # (B, H)
            xt = x[:, c * q + t].astype(np.float64)  # (B, H, P)
            want[:, :, c] += (d[..., None] * xt)[..., None] * bb[:, c * q + t, None, None, :]
    np.testing.assert_allclose(states.numpy(), want, rtol=1e-5, atol=1e-5)
    prev, final = ref.ssd_state_pass(states, acum)
    run = np.zeros((b, h, p, n))
    for c in range(nc):
        np.testing.assert_allclose(prev[:, :, c].numpy(), run, rtol=1e-5, atol=1e-5)
        run = run * np.exp(A[:, c, -1])[..., None, None] + want[:, :, c]
    np.testing.assert_allclose(final.numpy(), run, rtol=1e-5, atol=1e-5)


def test_ssd_chunk_out_one_chunk_is_the_sequential_scan():
    """With one chunk no state is carried: the output is the masked
    (C Bᵀ * decay) X term alone."""
    b, s, h, p, n = 1, 64, 2, 8, 16
    x, a, bb, cc = _inputs(b, s, h, p, n, seed=4)
    acum = ref.ssd_chunk_cumsum(torch.from_numpy(a), s)
    prev = torch.zeros(b, h, 1, p, n)
    cb = ref.ssd_cb(torch.from_numpy(bb), torch.from_numpy(cc), s)
    y = ref.ssd_chunk_out(torch.from_numpy(x), torch.from_numpy(cc), cb, acum, prev)
    yr, _ = ssd_scan_ref(*(jnp.asarray(t) for t in (x, a, bb, cc)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("heads,length,sms,tile", [
    (64, 2080, 132, 64), (64, 32768, 132, 64), (64, 2080, 132, 32),
    (2, 1, 132, 64), (2, 63, 132, 64), (4, 0, 132, 32), (300, 5000, 132, 64),
    (1, 100000, 132, 64), (264, 4096, 132, 64)])
def test_decode_attn_splits_cover_the_valid_positions(heads, length, sms, tile):
    nsplit, per_split = DA.splits(heads, length, sms, tile)
    assert nsplit >= 1 and per_split % tile == 0
    assert nsplit * per_split >= length  # every valid position has a block
    assert (nsplit - 1) * per_split < max(length, 1)  # and no block is empty
    # at most one wave of BLOCKS_PER_SM blocks per SM, unless heads exceed it
    assert heads * nsplit <= max(heads, sms * DA.BLOCKS_PER_SM)
    if length <= tile or heads >= sms * DA.BLOCKS_PER_SM:
        assert nsplit == 1


def test_decode_attn_splits_at_the_serve_shape():
    """Llama-3.2-3B serve (B 8 x KV 8 heads, 2080 positions) and a 32k
    cache on a 132-SM card: 4 splits each, 256 blocks."""
    assert DA.splits(64, 2080, 132, 64) == (4, 576)
    assert DA.splits(64, 32768, 132, 64) == (4, 8192)

"""The CUDA kernels against their plain versions, on the card.

Needs a CUDA card (the kernels have no CPU mode): every test carries the
``cuda`` marker and skips without one.  Imports no JAX, so it runs on a
machine with the card:  python -m pytest -q tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attn as DA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 7), (2, 300001), (5, 4099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, shape, dtype):
    n, s = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    ninf = math.nextafter(-math.inf, math.inf)
    t = torch.tensor(([0.0, 0.7, 1.5, math.inf, ninf] * 2)[:n], device=cuda)
    K.reset_launches()
    a, b = K.sparsify_ef_cuda(x, t), ref.sparsify_ef_plain(x, t)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    steps = torch.linspace(0.005, 0.05, n, device=cuda)
    levels = torch.full((n,), 127.0, device=cuda)
    seeds = torch.arange(n, dtype=torch.int32, device=cuda) * 7919 + 11
    a = K.sparsify_quantize_ef_cuda(x, t, steps, levels, seeds, 12345)
    b = ref.sparsify_quantize_ef_plain(x, t, steps, levels, seeds, 12345)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert (a[1].float() - b[1].float()).abs().max().item() <= 1e-6
    assert K.LAUNCHES == {"sparsify_ef": 1, "sparsify_quantize_ef": 1,
                          "sparsify_quantize_ef_segmented": 0}


@pytest.mark.cuda
def test_ops_dispatch_cuda_to_the_kernel(cuda):
    x = torch.randn(4, 1001, device=cuda)
    K.reset_launches()
    up, err, cnt = ops.sparsify_ef(x, torch.full((4,), 0.5, device=cuda))
    assert K.LAUNCHES["sparsify_ef"] == 1
    assert torch.equal(up + err, x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sparsify_ef(x[:, ::2], torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="thresholds"):
        ops.sparsify_ef(x, torch.zeros(4, dtype=torch.float64, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("policy,kernel", [("mads", "sparsify_ef"),
                                           ("mads-joint", "sparsify_quantize_ef")])
def test_cuda_round_matches_cpu_round(cuda, policy, kernel):
    """One AFL round at width 4 on the card (through the kernel) and on the
    CPU (plain versions) from the same weights, batch and seeds: equal
    successes; k within 2 (convolutions round differently on the card)."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core.afl import afl_init, afl_round
    from repro_torch.models.registry import build_model

    torch.backends.cudnn.allow_tf32 = False
    model = build_model(get_config("resnet9-cifar10").replace(d_model=4))
    fl = FLConfig(num_devices=4, rounds=5, batch_size=4)
    g = torch.Generator().manual_seed(3)
    batch = {"images": torch.randn(4, 4, 32, 32, 3, generator=g),
             "labels": torch.randint(0, 10, (4, 4), generator=g)}
    sched = (torch.tensor([1, 1, 0, 1]), torch.tensor([8.0, 2.0, 0.0, 8.0]),
             torch.full((4,), 1e-9), torch.full((4,), 100.0))
    out = {}
    for dev in ("cpu", cuda):
        state = afl_init(model, fl, 0, dev)
        K.reset_launches()
        new, m = afl_round(state, {k: v.to(dev) for k, v in batch.items()},
                           *(t.to(dev) for t in sched), model=model, fl=fl,
                           policy=BL.ALL[policy](model.num_params(), fl))
        out[str(dev)] = (new, m, dict(K.LAUNCHES))
    (cn, cm, cl), (gn, gm, gl) = out["cpu"], out[str(cuda)]
    assert cl[kernel] == 0 and gl[kernel] == 1
    assert torch.equal(cm["success"], gm["success"].cpu())
    assert torch.equal(cn.kappa, gn.kappa.cpu())
    assert (cm["k"] - gm["k"].cpu()).abs().max().item() <= 2
    assert torch.allclose(cn.w_n, gn.w_n.cpu(), rtol=1e-4, atol=1e-4)


def _leaf_offsets(arch_or_sizes):
    if isinstance(arch_or_sizes, str):
        from repro_torch.configs import get_config
        from repro_torch.models.registry import build_model

        layout = build_model(get_config(arch_or_sizes)).layout
        return layout.offsets + (layout.size,)
    return tuple([0] + [int(v) for v in
                        torch.tensor(arch_or_sizes).cumsum(0).tolist()])


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [(7, 1, 0, 33, 130, 5, 64),
                                    (4099, 3, 70001, 1, 12, 8191),
                                    "lanegcn-argoverse"],
                         ids=["tiny", "ragged", "lanegcn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segmented_kernel_matches_plain(cuda, leaves, dtype):
    """The segmented sparsify_quantize_ef against its plain version, bit
    for bit: leaf starts off the 16-byte boundary, leaves shorter than a
    vector, an empty leaf, rows whose start is unaligned, thresholds that
    keep all or nothing; and against the unsegmented kernel called leaf by
    leaf with base = the leaf's offset."""
    offsets = _leaf_offsets(leaves)
    rows, n, nl = 5, offsets[-1], len(offsets) - 1
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(rows, n, generator=g, device=cuda).to(dtype)
    t = torch.rand(rows, nl, generator=g, device=cuda) * 1.5
    t[0, 0], t[1, -1] = 0.0, math.inf
    steps = torch.rand(rows, nl, generator=g, device=cuda) * 0.05 + 0.005
    levels = torch.tensor([1.0, 7.0, 127.0, 32767.0], device=cuda)[
        torch.randint(0, 4, (rows, nl), generator=g, device=cuda)]
    seeds = torch.arange(rows, dtype=torch.int32, device=cuda) * 7919 + 11
    K.reset_launches()
    got = K.sparsify_quantize_ef_segmented_cuda(x, t, steps, levels, seeds,
                                                offsets)
    want = ref.sparsify_quantize_ef_segmented_plain(x, t, steps, levels,
                                                    seeds, offsets)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sparsify_quantize_ef_segmented"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[2].shape == (rows, nl)
    for i, (a, b) in enumerate(zip(offsets, offsets[1:])):
        if b == a:
            continue
        u, e, c = K.sparsify_quantize_ef_cuda(
            x[:, a:b].contiguous(), t[:, i].contiguous(),
            steps[:, i].contiguous(), levels[:, i].contiguous(), seeds, a)
        assert torch.equal(got[0][:, a:b], u) and torch.equal(got[1][:, a:b], e)
        assert torch.equal(got[2][:, i], c)


@pytest.mark.cuda
def test_segmented_kernel_refuses_bad_tables(cuda):
    x = torch.randn(2, 100, device=cuda)
    tab = torch.zeros(2, 2, device=cuda)
    seeds = torch.zeros(2, dtype=torch.int32, device=cuda)
    K.reset_launches()
    with pytest.raises(ValueError, match="offsets"):
        K.sparsify_quantize_ef_segmented_cuda(x, tab, tab, tab, seeds, (0, 60, 99))
    with pytest.raises(ValueError, match="offsets"):
        K.sparsify_quantize_ef_segmented_cuda(x, tab, tab, tab, seeds, (0, 70, 60, 100))
    with pytest.raises(ValueError, match="levels"):
        K.sparsify_quantize_ef_segmented_cuda(x, tab, tab, tab[:, :1], seeds,
                                              (0, 60, 100))
    assert K.LAUNCHES["sparsify_quantize_ef_segmented"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy,per_layer,kernel", [
    ("mads", False, "sparsify_ef"),
    ("qsgd", False, "sparsify_quantize_ef"),
    ("mads-joint", True, "sparsify_quantize_ef_segmented")])
def test_cuda_lanegcn_round_matches_cpu_round(cuda, policy, per_layer, kernel):
    """One AFL round of LaneGCN at d_model 32 on the card (one launch of
    the policy's kernel) and on the CPU (plain versions) from the same
    weights, batch and schedule: equal successes; k within 2."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core.afl import afl_init, afl_round
    from repro_torch.models.registry import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(get_config("lanegcn-argoverse").replace(d_model=32,
                                                                d_ff=64))
    fl = FLConfig(num_devices=4, rounds=5, batch_size=8,
                  per_layer_budget=per_layer)
    g = torch.Generator().manual_seed(3)
    batch = {"past": torch.randn(4, 8, 20, 2, generator=g),
             "lanes": torch.randn(4, 8, 32, 2, generator=g),
             "future": torch.randn(4, 8, 30, 2, generator=g)}
    # a weak channel, so that the short contacts ship partial uploads
    sched = (torch.tensor([1, 1, 0, 1]), torch.tensor([8.0, 0.2, 0.0, 0.05]),
             torch.full((4,), 1e-13), torch.full((4,), 100.0))
    out = {}
    for dev in ("cpu", cuda):
        state = afl_init(model, fl, 0, dev)
        K.reset_launches()
        new, m = afl_round(state, {k: v.to(dev) for k, v in batch.items()},
                           *(t.to(dev) for t in sched), model=model, fl=fl,
                           policy=BL.ALL[policy](model.num_params(), fl))
        out[str(dev)] = (new, m, dict(K.LAUNCHES))
    (cn, cm, cl), (gn, gm, gl) = out["cpu"], out[str(cuda)]
    assert float(cm["b"][3]) < 16 or float(cm["k"][3]) < model.num_params()
    assert sum(cl.values()) == 0 and gl[kernel] == 1 and sum(gl.values()) == 1
    assert torch.equal(cm["success"], gm["success"].cpu())
    assert (cm["k"] - gm["k"].cpu()).abs().max().item() <= 2
    assert torch.allclose(cn.w_n, gn.w_n.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,d", [(2, 8, 2, 1024, 64), (1, 4, 4, 512, 128), (2, 6, 2, 777, 64),
                   (1, 16, 2, 2048, 128), (8, 24, 8, 2080, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_matches_plain(cuda, b, h, kv, s, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    DA.reset_launches()
    for length in (int(0.7 * s), s, 1):
        got = DA.decode_attn_cuda(q, k, v, length)
        want = ref.decode_attn_plain(q, k, v, length)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert DA.LAUNCHES["decode_attn"] == 3
    # length is clamped to S; positions at and beyond it never count
    torch.testing.assert_close(DA.decode_attn_cuda(q, k, v, s + 5).float(),
                               ref.decode_attn_plain(q, k, v, s).float(),
                               rtol=tol, atol=tol)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:], v2[:, 100:] = 1e4, -1e4
    assert torch.equal(DA.decode_attn_cuda(q, k, v, 100),
                       DA.decode_attn_cuda(q, k2, v2, 100))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,h,p,n,q", [(2, 256, 4, 64, 32, 64), (1, 128, 2, 32, 16, 32),
                    (1, 512, 8, 64, 64, 128), (1, 512, 2, 64, 128, 256)])
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, n, q):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(b, s, h, p, generator=g, device=cuda)
    a = -torch.randn(b, s, h, generator=g, device=cuda).abs() * 0.5
    bb = torch.randn(b, s, n, generator=g, device=cuda)
    cc = torch.randn(b, s, n, generator=g, device=cuda)
    SSD.reset_launches()
    y, st = SSD.ssd_scan_cuda(x, a, bb, cc, q)
    # the plain version in f64: at chunk 256 the f32 formula carries
    # ~5e-4 of its own rounding (in-chunk cumsums reach |100|)
    yr, sr = ref.ssd_scan_plain(*(t.double() for t in (x, a, bb, cc)), q)
    torch.cuda.synchronize()
    assert SSD.LAUNCHES["ssd_scan"] == 1
    torch.testing.assert_close(y.double(), yr, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st.double(), sr, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", [(2, 16, 2, 1024, 64), (1, 8, 1, 4096, 128),
                                        (8, 24, 8, 2080, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_lengths(cuda, b, h, kv, s, d, dtype):
    """Lengths 1 and 63, ends mid-tile and on a tile edge, one split and
    many; G = 8 at D = 64; two calls agree bitwise (the ticket merge
    does not race); a masked tail of 1e4 is never read."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    tile = DA.TILE[dtype]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lengths = [1, 63, tile, 3 * tile + 17, s // 2 + 5, s]
    assert DA.splits(b * kv, tile, sms, tile)[0] == 1
    assert DA.splits(b * kv, s, sms, tile)[0] > 1 or b * kv >= sms
    for length in lengths:
        got = DA.decode_attn_cuda(q, k, v, length)
        want = ref.decode_attn_plain(q, k, v, length)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        assert torch.equal(got, DA.decode_attn_cuda(q, k, v, length))
    length = 3 * tile + 17
    k2, v2 = k.clone(), v.clone()
    k2[:, length:], v2[:, length:] = 1e4, 1e4
    assert torch.equal(DA.decode_attn_cuda(q, k, v, length),
                       DA.decode_attn_cuda(q, k2, v2, length))


def _ssd_inputs(cuda, b, s, h, p, n, a_kind, seed=6):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device=cuda)
    if a_kind == "normal":
        a = -torch.randn(b, s, h, generator=g, device=cuda).abs() * 0.5
    elif a_kind == "-0.4":  # in-chunk cumsums reach |100| at chunk 256
        a = -0.4 + 0.05 * torch.randn(b, s, h, generator=g, device=cuda)
    else:  # -10 a step: exp(A_l) * exp(-A_s) would overflow
        a = torch.full((b, s, h), -10.0, device=cuda)
    bb = torch.randn(b, s, n, generator=g, device=cuda)
    cc = torch.randn(b, s, n, generator=g, device=cuda)
    return x, a, bb, cc


@pytest.mark.cuda
@pytest.mark.parametrize("shape,a_kind", [
    ((4, 4096, 80, 64, 128, 256), "normal"),  # the Mamba2-2.7B serve shape
    ((1, 1024, 4, 64, 128, 256), "-0.4"),
    ((1, 512, 4, 64, 128, 256), "-10"),
    ((2, 256, 4, 64, 128, 256), "normal"),  # S = chunk: one chunk
    ((1, 96, 3, 24, 20, 96), "normal"),  # ragged P, N and chunk
    ((1, 90, 2, 30, 18, 30), "normal"),  # rows not 16-byte aligned: 4-byte copies
])
def test_ssd_scan_kernel_hard_cases(cuda, shape, a_kind):
    b, s, h, p, n, q = shape
    x, a, bb, cc = _ssd_inputs(cuda, b, s, h, p, n, a_kind)
    y, st = SSD.ssd_scan_cuda(x, a, bb, cc, q)
    yr, sr = ref.ssd_scan_plain(*(t.double() for t in (x, a, bb, cc)), q)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y.double(), yr, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st.double(), sr, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 3, 64, 128, 256), (1, 128, 2, 32, 16, 32)])
def test_ssd_scan_phases_match_plain_phases(cuda, shape):
    """Each phase's output against its plain version in ``ref.py``."""
    b, s, h, p, n, q = shape
    x, a, bb, cc = _ssd_inputs(cuda, b, s, h, p, n, "normal")
    scratch = {}
    y, st = SSD.ssd_scan_cuda(x, a, bb, cc, q, scratch=scratch)
    acum = ref.ssd_chunk_cumsum(a, q)
    torch.testing.assert_close(scratch["acum"], acum, rtol=1e-12, atol=1e-12)
    causal = torch.ones(q, q, dtype=torch.bool, device=cuda).tril()
    cb = ref.ssd_cb(bb, cc, q)
    torch.testing.assert_close(scratch["cb"].masked_fill(~causal, 0),
                               cb.masked_fill(~causal, 0), rtol=1e-4, atol=1e-4)
    prev, final = ref.ssd_state_pass(ref.ssd_chunk_states(x, bb, acum), acum)
    torch.testing.assert_close(scratch["states"], prev, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, final, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, ref.ssd_chunk_out(x, cc, cb, acum, prev),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_refuses_misaligned_views(cuda, dtype):
    """A contiguous view at a storage offset off the 16-byte copies'
    boundary raises ValueError before any launch, and the card still
    works after it."""
    q = torch.randn(1, 4, 64, device=cuda).to(dtype)
    buf = torch.randn(64 * 2 * 64 + 1, device=cuda).to(dtype)
    k = buf[1:].view(1, 64, 2, 64)
    v = buf[:-1].view(1, 64, 2, 64)
    assert k.is_contiguous() and k.data_ptr() % 16
    DA.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        DA.decode_attn_cuda(q, k, v, 10)
    if dtype == torch.bfloat16:  # one element off is 2 bytes off
        with pytest.raises(ValueError, match="4-byte"):
            DA.decode_attn_cuda(buf[1:1 + 4 * 64].view(1, 4, 64), v, v, 10)
    assert DA.LAUNCHES["decode_attn"] == 0
    got = DA.decode_attn_cuda(q, k.clone(), v, 10)
    torch.testing.assert_close(
        got.float(), ref.decode_attn_plain(q, k, v, 10).float(),
        rtol=2e-5 if dtype == torch.float32 else 3e-2,
        atol=2e-5 if dtype == torch.float32 else 3e-2)


@pytest.mark.cuda
def test_ops_dispatch_llm_kernels(cuda):
    q = torch.randn(2, 4, 64, device=cuda)
    k = torch.randn(2, 64, 2, 64, device=cuda)
    DA.reset_launches()
    SSD.reset_launches()
    ops.decode_attn(q, k, k, 10)
    ops.decode_attn(q.cpu(), k.cpu(), k.cpu(), 10)
    assert DA.LAUNCHES["decode_attn"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attn(q, k[:, ::2], k[:, ::2], 10)
    x = torch.randn(1, 64, 2, 64, device=cuda)
    a = -torch.rand(1, 64, 2, device=cuda)
    bc = torch.randn(1, 64, 16, device=cuda, dtype=torch.bfloat16)
    ops.ssd_scan(x, a, bc, bc, 32)
    ops.ssd_scan(x.cpu(), a.cpu(), bc.cpu(), bc.cpu(), 32)
    assert SSD.LAUNCHES["ssd_scan"] == 1
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, a, bc, bc, 48)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_reduced_serve_cuda_matches_cpu(cuda, arch):
    """A reduced float32 serve on the card (through the kernels) and on
    the CPU (plain versions) from the same weights: same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    from repro_torch.utils.device import resolve_device

    resolve_device("cuda")
    cfg = get_config(arch).reduced().replace(dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 64),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    DA.reset_launches()
    SSD.reset_launches()
    out = {}
    for dev in ("cpu", cuda):
        p = model.layout.unflatten(model.layout.flatten(params).to(dev))
        out[str(dev)] = serve(cfg, model, p, prompts.to(dev), gen=8)
    (tc, sc), (tg, sg) = out["cpu"], out[str(cuda)]
    assert torch.equal(tc, tg.cpu())
    torch.testing.assert_close(sg["prefill_logits"].cpu(), sc["prefill_logits"],
                               rtol=1e-3, atol=1e-3)
    kernel = DA if cfg.family == "dense" else SSD
    want = 8 * cfg.num_layers if cfg.family == "dense" else cfg.num_layers
    assert sum(kernel.LAUNCHES.values()) == want


# ---------------------------------------------------------------------------
# The device-resident scenario engine on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gauss_markov", "rwp", "manhattan", "hotspot"])
def test_device_engine_matches_numpy_extraction(cuda, model):
    """A trace built on the card, its in-range mask moved to the host: the
    card's extraction equals the numpy oracle's cell by cell."""
    import numpy as np

    from repro_torch.mobility import intervals_to_rounds
    from repro_torch.scenarios import (TORCH_MODELS, contact_intervals,
                                       contact_intervals_torch,
                                       rounds_from_in_range)

    m = TORCH_MODELS[model](num_devices=3000, area=800.0, seed=1,
                            device=str(cuda))
    mask = m.trace(400.0, 1.0).in_range(100.0)
    host = mask.cpu().numpy()
    dev, start, dur = contact_intervals(host, 1.0)
    z_o, t_o = intervals_to_rounds(dev, start, dur, 3000, 40, 10.0)
    z, t = rounds_from_in_range(mask, 1.0, 40, 10.0)
    assert z.device.type == "cuda" and z_o.sum() > 0
    assert np.array_equal(z.cpu().numpy(), z_o)
    assert np.array_equal(t.cpu().numpy(), t_o)
    got = contact_intervals_torch(mask, 1.0)
    for a, b in zip(got, (dev, start, dur)):
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gauss_markov", "rwp", "manhattan", "hotspot",
                                   "static"])
def test_device_schedule_never_waits_for_the_card(cuda, model):
    """The schedule build and the heterogeneity gate make no synchronising
    call (torch's sync debug mode raises on one)."""
    from repro_torch.configs import FLConfig
    from repro_torch.scenarios import ScenarioProvider

    fl = FLConfig(num_devices=500, rounds=20, mobility_model=model,
                  scenario_backend="jax", area=500.0, het_dropout=0.2,
                  het_availability=0.8, het_compute_mean=1.0)
    provider = ScenarioProvider.from_config(fl, device=str(cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        zeta, tau, h2 = provider.schedule()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert zeta.device.type == tau.device.type == h2.device.type == "cuda"
    assert torch.equal(tau > 0, zeta == 1)
    assert provider.aux["dropout"].device.type == "cuda"


@pytest.mark.cuda
def test_torch_apply_on_the_card(cuda):
    """Draws and gating on the card: equal to ``reference_apply`` on the
    same draws, and P(available) at its stationary value."""
    import numpy as np

    from repro_torch.scenarios.heterogeneity import (HeterogeneityModel,
                                                     reference_apply,
                                                     torch_apply, torch_draws)

    m = HeterogeneityModel(num_devices=20000, availability=0.8,
                           avail_persist=0.4, compute_mean=2.0, dropout=0.2,
                           seed=3)
    g = torch.Generator(device=cuda).manual_seed(0)
    zeta = (torch.rand(30, 20000, generator=g, device=cuda) < 0.4).to(torch.int32)
    tau = torch.rand(30, 20000, generator=g, device=cuda) * 12 * zeta
    avail, latency, drop = torch_draws(m, 30, cuda)
    assert abs(avail.float().mean().item() - 0.8) < 0.02
    z, t, aux = torch_apply(m, zeta, tau)
    # the vectorised rule against the loop, on a slice (the loop is slow)
    sl = slice(0, 300)
    z_r, t_r, aux_r = reference_apply(
        *(x[:, sl].cpu().numpy() for x in (zeta, tau, avail, latency, drop)))
    assert np.array_equal(z[:, sl].cpu().numpy(), z_r)
    assert np.array_equal(t[:, sl].cpu().numpy(), t_r)
    for k in aux_r:
        assert np.array_equal(aux[k][:, sl].cpu().numpy(), aux_r[k])
    assert z.device.type == "cuda" and aux["dropout"][:, sl].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_trace_mobility_run_on_the_card_matches_cpu(cuda, backend):
    """Two ``mads`` rounds at ResNet-9 width 4 under a Manhattan schedule
    with heterogeneity, on the card (one sparsify_ef launch a round) and
    on the CPU: the numpy schedule is the same array on both, so the same
    uploads and an eval within 0.02; the device backend builds its
    schedule on the card and runs."""
    import numpy as np

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    model = build_model(get_config("resnet9-cifar10").replace(d_model=4))
    fl = FLConfig(num_devices=4, rounds=2, batch_size=4, mobility_model="manhattan",
                  speed=15.0, area=300.0, het_dropout=0.2, het_availability=0.8,
                  scenario_backend=backend)
    dev, ev = build_device_data(model.cfg, fl, train_n=64, eval_n=128, seed=0)
    out = {}
    for d in ("cpu", cuda):
        K.reset_launches()
        res = run_afl(model, model.cfg, fl, "mads", DeviceLoader(dev, 4, 0), ev,
                      rounds=2, eval_every=1, device=d)
        out[str(d)] = (res.history, dict(K.LAUNCHES))
    (hc, lc), (hg, lg) = out["cpu"], out[str(cuda)]
    assert lc["sparsify_ef"] == 0 and lg["sparsify_ef"] == 2
    assert np.isfinite(hg["eval"]).all()
    if backend == "numpy":
        assert hg["uploads"] == hc["uploads"] and hc["uploads"][-1] > 0
        assert max(abs(a - b) for a, b in zip(hg["eval"], hc["eval"])) <= 0.02


@pytest.mark.cuda
def test_fedmobile_on_a_card_resident_schedule(cuda):
    """FedMobile's host-side relay rewrite gets a schedule that the device
    backend built on the card."""
    import numpy as np

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.runner import build_provider, run_afl
    from repro_torch.data import DeviceLoader
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    fl = FLConfig(num_devices=4, rounds=3, batch_size=4,
                  mobility_model="gauss_markov", area=300.0,
                  scenario_backend="jax")
    zeta = build_provider(fl, "mads", None, 3, 0, cuda).schedule()[0]
    assert zeta.device.type == "cuda"
    relayed = build_provider(fl, "fedmobile", None, 3, 0, cuda).schedule()
    assert all(isinstance(x, np.ndarray) for x in relayed)
    assert (relayed[0] >= zeta.cpu().numpy()).all()
    model = build_model(get_config("resnet9-cifar10").replace(d_model=4))
    dev, ev = build_device_data(model.cfg, fl, train_n=64, eval_n=64, seed=0)
    res = run_afl(model, model.cfg, fl, "fedmobile", DeviceLoader(dev, 4, 0),
                  ev, rounds=1, device=cuda)
    assert np.isfinite(res.final_eval)


def _telemetry_inputs(rounds, n, seed=0):
    """Metric dicts, tau and heterogeneity masks (numpy) for ``rounds``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        okf = (rng.random(n) < 0.6).astype(np.float32)
        succ = (okf * (rng.random(n) < 0.8)).astype(np.float32)
        k = np.floor(rng.uniform(0, 26350, n) * succ).astype(np.float32)
        m = {"uploads": okf, "success": succ, "k": k, "bits": k * 46.7,
             "b": succ * 32, "theta": rng.integers(1, 140, n).astype(np.float32),
             "energy": rng.uniform(0, 2, n).astype(np.float32) * okf,
             "x_norm2": rng.exponential(3.0, n).astype(np.float32),
             "e_norm2": rng.exponential(1e-3, n).astype(np.float32)}
        tau = rng.exponential(6.0, n).astype(np.float32)
        het = {"unavail": rng.random(n) < 0.2, "dropout": rng.random(n) < 0.1}
        out.append((m, tau, het))
    return out


@pytest.mark.cuda
def test_telemetry_records_on_the_card_without_a_sync(cuda):
    """record_round (suite: registry, DeviceTable.update, TheoryProbes.update),
    record_het and record_ingest on card tensors make no synchronising
    call (torch's sync debug mode raises on one), and give the CPU's bins
    and counts."""
    import numpy as np

    from repro_torch.telemetry import (AFL_REGISTRY, SERVE_REGISTRY,
                                       DeviceTable, TelemetrySuite,
                                       TheoryProbes, record_het, record_ingest,
                                       record_round)

    suite = TelemetrySuite(metrics=AFL_REGISTRY, device=DeviceTable(20),
                           probes=TheoryProbes(s=26350))
    inputs = _telemetry_inputs(8, 20)
    snaps = {}
    for dev in ("cpu", cuda):
        rounds = [({f: torch.as_tensor(v).to(dev) for f, v in m.items()},
                   torch.as_tensor(tau).to(dev),
                   {f: torch.as_tensor(v).to(dev) for f, v in het.items()})
                  for m, tau, het in inputs]
        state, serve = suite.init_state(dev), SERVE_REGISTRY.init_state(dev)
        if dev is cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for m, tau, het in rounds:
                state = record_het(suite, record_round(suite, state, m, tau),
                                   het)
                serve = record_ingest(SERVE_REGISTRY, serve,
                                      mask=m["uploads"], dtau=m["theta"],
                                      bits=m["bits"], weights=m["uploads"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert state["device"]["contacts"].device.type == torch.device(dev).type
        snaps[str(dev)] = (suite.fetch(state), SERVE_REGISTRY.fetch(serve))
    (a, sa), (b, sb) = snaps["cpu"], snaps[str(cuda)]
    for k in a["metrics"]["hist"]:
        assert np.array_equal(a["metrics"]["hist"][k], b["metrics"]["hist"][k])
    for k in sa["hist"]:
        assert np.array_equal(sa["hist"][k], sb["hist"][k])
    for k in ("rounds", "contacts", "successes"):
        assert a["metrics"]["counters"][k] == b["metrics"]["counters"][k]
        assert a["probes"][k] == b["probes"][k]
    for k in ("contacts", "successes", "failures", "last_contact",
              "staleness_sum", "staleness_max", "unavail", "dropouts"):
        assert np.array_equal(a["device"][k], b["device"][k]), k
    for k in a["probes"]:
        assert np.isclose(a["probes"][k], b["probes"][k], rtol=1e-6), k


@pytest.mark.cuda
def test_telemetry_run_on_the_card_matches_cpu(cuda):
    """Six ``mads`` rounds at ResNet-9 width 4, Manhattan schedule (numpy
    backend, the same arrays on both devices) with heterogeneity, with the
    full suite, on the card and on the CPU: equal counters, bins and
    count fields; float fields within the CPU tests' whole-run tolerances
    (tests/test_torch_telemetry.py: rtol 1e-4, e_norm2 rtol 0.5)."""
    import numpy as np

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    model = build_model(get_config("resnet9-cifar10").replace(d_model=4))
    fl = FLConfig(num_devices=4, rounds=6, batch_size=4, mobility_model="manhattan",
                  speed=15.0, area=300.0, het_dropout=0.2, het_availability=0.8,
                  telemetry_perdevice=True, telemetry_probes=True)
    dev, ev = build_device_data(model.cfg, fl, train_n=64, eval_n=64, seed=0)
    out = {}
    for d in ("cpu", cuda):
        K.reset_launches()
        res = run_afl(model, model.cfg, fl, "mads", DeviceLoader(dev, 4, 0), ev,
                      rounds=6, eval_every=3, device=d)
        out[str(d)] = (res.telemetry, dict(K.LAUNCHES))
    (a, lc), (b, lg) = out["cpu"], out[str(cuda)]
    assert lc["sparsify_ef"] == 0 and lg["sparsify_ef"] == 6
    am, bm = a["metrics"], b["metrics"]
    assert bm["counters"]["contacts"] > 0
    for k in ("rounds", "contacts", "successes"):
        assert am["counters"][k] == bm["counters"][k], k
    for k in am["hist"]:
        assert am["hist"][k].sum() == bm["hist"][k].sum(), k
    for k in ("staleness", "contact_tau"):
        assert np.array_equal(am["hist"][k], bm["hist"][k]), k
    for k in ("contacts", "successes", "failures", "last_contact",
              "staleness_sum", "staleness_max", "unavail", "dropouts"):
        assert np.array_equal(a["device"][k], b["device"][k]), k
    for k in ("bits_total", "energy_total"):
        assert np.isclose(am["counters"][k], bm["counters"][k], rtol=1e-4), k
    assert np.allclose(a["device"]["e_norm2"], b["device"]["e_norm2"],
                       rtol=0.5, atol=1e-9)
    for k in ("contacts", "successes", "rounds", "tau_sum"):
        assert np.isclose(a["probes"][k], b["probes"][k], rtol=1e-6), k


@pytest.mark.cuda
def test_train_cli_profile_trace_holds_spans_and_the_kernel(cuda, tmp_path):
    """``--telemetry --perdevice --probes --profile-dir`` on the card: the
    Chrome trace holds the phase spans and the sparsify kernel, and the
    telemetry.jsonl renders."""
    import json

    from repro_torch.launch import train
    from repro_torch.telemetry import read_jsonl, render_report

    prof = tmp_path / "prof"
    res = train.main(["--width", "4", "--devices", "4", "--rounds", "3",
                      "--eval-every", "3", "--batch-size", "8", "--train-n",
                      "64", "--intercontact", "20", "--telemetry",
                      "--perdevice", "--probes", "--profile-dir", str(prof),
                      "--workdir", str(tmp_path / "w")])
    assert res.telemetry["metrics"]["counters"]["rounds"] == 3.0
    names = [e.get("name", "") for e in
             json.loads((prof / "trace.json").read_text())["traceEvents"]]
    assert {"compile", "execute", "eval"} <= set(names)
    assert any("row_pass" in n for n in names)
    text = render_report(read_jsonl(str(tmp_path / "w" / "telemetry.jsonl")))
    assert "## Theory vs measured" in text

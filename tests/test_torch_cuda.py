"""The CUDA kernels against their plain versions, on the card.

Needs a CUDA card (the kernels have no CPU mode): every test carries the
``cuda`` marker and skips without one.  Imports no JAX, so it runs on a
machine with the card:  python -m pytest -q tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402


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
    assert K.LAUNCHES == {"sparsify_ef": 1, "sparsify_quantize_ef": 1}


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

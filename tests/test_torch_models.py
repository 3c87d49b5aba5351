"""The port's ResNet-9 against the JAX reference: trees, loss, gradients.

The reference's initial weights are carried over with ``load_params``.
Convolutions and batch statistics reduce in another order than XLA's, so
losses and gradients agree to fp32 tolerance (rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config  # noqa: E402
from repro.models import resnet as R  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.afl import device_grads  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import demo_batch as t_demo_batch  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.utils.tree import flatten_concat, tree_flatten, unflatten_like  # noqa: E402

N = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes: torch's intra-op threads only contend with the
    other test workers (measured 3x slower with 8 threads than with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = get_config("resnet9-cifar10").replace(d_model=4)
    model = build_model(cfg)
    tmodel = t_build_model(t_get_config("resnet9-cifar10").replace(d_model=4))
    params = jax.jit(model.init)(jax.random.key(1))
    return cfg, model, tmodel, params


def test_full_width_param_count_matches():
    ref = build_model(get_config("resnet9-cifar10")).num_params()
    port = t_build_model(t_get_config("resnet9-cifar10"))
    assert port.num_params() == ref == 6_573_130
    assert port.layout.size == ref


def test_load_params_keeps_flatten_order_and_shapes(models):
    _, _, tmodel, params = models
    tp = load_params(tmodel, jax.tree.map(np.asarray, params))
    ref_paths = [tuple(k.key for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert list(tmodel.layout.paths) == ref_paths
    flat = tmodel.layout.flatten(tp)
    ref_flat = np.concatenate([np.asarray(l).reshape(-1)
                               for l in jax.tree.leaves(params)])
    np.testing.assert_array_equal(flat.numpy(), ref_flat)
    assert [tuple(l.shape) for l in tmodel.layout.leaves(flat)] == [
        l.shape for l in jax.tree.leaves(params)]
    np.testing.assert_array_equal(flatten_concat(tp).numpy(), ref_flat)
    back = unflatten_like(flat, tp)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_flatten(back)[1], tree_flatten(tp)[1]))


def test_load_params_rejects_mismatch(models):
    _, _, tmodel, params = models
    tree = jax.tree.map(np.asarray, params)
    tree["fc"]["w"] = tree["fc"]["w"][:, :5]
    with pytest.raises(ValueError, match="fc/w"):
        load_params(tmodel, tree)
    tree = jax.tree.map(np.asarray, params)
    del tree["r2b"]
    with pytest.raises(ValueError, match="leaf paths"):
        load_params(tmodel, tree)


def test_loss_grads_and_accuracy_match(models):
    cfg, model, tmodel, params = models
    rng = np.random.default_rng(0)
    batches = [demo_batch(cfg, 6, 0, rng) for _ in range(N)]
    tp = load_params(tmodel, jax.tree.map(np.asarray, params))

    b0 = batches[0]
    ref_loss = float(jax.jit(lambda p, b: R.loss_fn(p, cfg, b))(params, b0))
    tb0 = {k: torch.as_tensor(v) for k, v in b0.items()}
    port_loss = float(TR.loss_fn(tp, tmodel.cfg, tb0))
    np.testing.assert_allclose(port_loss, ref_loss, rtol=1e-4, atol=1e-5)
    assert float(TR.accuracy(tp, tmodel.cfg, tb0)) == float(
        jax.jit(lambda p, b: R.accuracy(p, cfg, b))(params, b0))

    # per-device gradients at N different models, one vmapped call each side
    stacked = jax.tree.map(
        lambda l: np.stack([np.asarray(l) * (1.0 + 0.1 * i) for i in range(N)]),
        params)
    batch = {k: np.stack([b[k] for b in batches]) for k in b0}
    ref_g = jax.jit(jax.vmap(jax.grad(lambda p, b: R.loss_fn(p, cfg, b))))(
        stacked, batch)
    w_n = tmodel.layout.flatten(
        jax.tree.map(torch.tensor, stacked), lead=1)
    g = device_grads(tmodel, w_n, {k: torch.as_tensor(v) for k, v in batch.items()})
    ref_flat = np.concatenate([np.asarray(l).reshape(N, -1)
                               for l in jax.tree.leaves(ref_g)], axis=1)
    np.testing.assert_allclose(g.numpy(), ref_flat, rtol=1e-4, atol=1e-5)


def test_demo_batch_matches_reference_draws():
    cfg = get_config("resnet9-cifar10")
    a = demo_batch(cfg, 5, 0, np.random.default_rng(4))
    b = t_demo_batch(t_get_config("resnet9-cifar10"), 5, 0, np.random.default_rng(4))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# First two values and the f64 sum of each weight leaf of full-width
# ResNet-9 drawn from torch.Generator().manual_seed(0): the draws a CPU
# generator gives must not change when init learns to draw on a CUDA
# generator's device.
RESNET9_SEED0_DRAWS = {
    ("c1", "w"): ([-0.6500039100646973, -0.6653154492378235], 27.664724274916807),
    ("c2", "w"): ([-0.5740811228752136, -0.06697548180818558], -115.40842419685487),
    ("c3", "w"): ([0.40169286727905273, 1.3539648056030273], -566.0897725519167),
    ("c4", "w"): ([-0.19085532426834106, 1.2748816013336182], 73.83873723096463),
    ("fc", "w"): ([0.011847879737615585, -0.016066700220108032], 1.4989049403325225),
    ("r1a", "w"): ([0.0076207853853702545, -0.11795081198215485], -4.96070326072595),
    ("r1b", "w"): ([0.2920352518558502, 0.623094379901886], -152.40946038987818),
    ("r2a", "w"): ([0.17586830258369446, 0.42366188764572144], 219.6806604692771),
    ("r2b", "w"): ([0.13767561316490173, 0.7987514138221741], 923.5058836813747),
}


def test_init_from_cpu_generator_keeps_resnet9_draws():
    model = t_build_model(t_get_config("resnet9-cifar10"))
    params = model.init(torch.Generator().manual_seed(0))
    weights = {p: l for p, l in zip(*tree_flatten(params)) if l.dim() >= 2}
    assert sorted(weights) == sorted(RESNET9_SEED0_DRAWS)
    for path, (head, total) in RESNET9_SEED0_DRAWS.items():
        leaf = weights[path]
        assert leaf.device.type == "cpu" and leaf.dtype == torch.float32
        assert leaf.reshape(-1)[:2].tolist() == head
        np.testing.assert_allclose(float(leaf.double().sum()), total, rtol=1e-9)

"""The port's LaneGCN slice (the paper's Argoverse experiment, §VI-C)
against the JAX reference: tree, forward, loss, gradients, data, ADE
eval and a short federated run.

The reference's initial weights are carried over with ``load_params``.
The model is cut to d_model 32, d_ff 64.  Convolutions, products and the
softmax reduce in another order than XLA's, so forward, loss and
gradients agree to fp32 tolerance (1e-5); the data generators are numpy
on both sides and array-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import FLConfig, get_config  # noqa: E402
from repro.core import runner  # noqa: E402
from repro.core.afl import afl_init  # noqa: E402
from repro.core.runner import make_eval_fn, run_afl  # noqa: E402
from repro.data import DeviceLoader  # noqa: E402
from repro.data.synthetic import SyntheticTrajectories  # noqa: E402
from repro.launch.train import build_device_data  # noqa: E402
from repro.models import lanegcn as G  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import FLConfig as TFLConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.afl import device_grads  # noqa: E402
from repro_torch.core.runner import make_eval_fn as t_make_eval_fn  # noqa: E402
from repro_torch.core.runner import run_afl as t_run_afl  # noqa: E402
from repro_torch.data import DeviceLoader as TDeviceLoader  # noqa: E402
from repro_torch.data import SyntheticTrajectories as TSyntheticTrajectories  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import lanegcn as TG  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import demo_batch as t_demo_batch  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402

N = 4
ARCH = "lanegcn-argoverse"
SMALL = dict(d_model=32, d_ff=64)
JIT_INIT = jax.jit(afl_init, static_argnums=(0, 1, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes: torch's intra-op threads only contend with the
    other test workers (measured 3x slower with 8 threads than with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    cfg = get_config(ARCH).replace(**SMALL)
    model = build_model(cfg)
    tmodel = t_build_model(t_get_config(ARCH).replace(**SMALL))
    params = jax.jit(model.init)(jax.random.key(1))
    return cfg, model, tmodel, params


def test_full_width_tree_matches_reference():
    ref = build_model(get_config(ARCH))
    port = t_build_model(t_get_config(ARCH))
    assert port.num_params() == ref.num_params() == 247_100
    shapes = jax.eval_shape(ref.init, jax.random.key(0))
    paths = [tuple(k.key for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert list(port.layout.paths) == paths and len(paths) == 20
    assert list(port.layout.shapes) == [l.shape for l in jax.tree.leaves(shapes)]


def test_load_params_carries_the_tree(models):
    _, _, tmodel, params = models
    tree = jax.tree.map(np.asarray, params)
    tp = load_params(tmodel, tree)
    ref_flat = np.concatenate([l.reshape(-1) for l in jax.tree.leaves(tree)])
    np.testing.assert_array_equal(tmodel.layout.flatten(tp).numpy(), ref_flat)
    tree["actor_conv2"]["w"] = tree["actor_conv2"]["w"][:, :, :5]
    with pytest.raises(ValueError, match="actor_conv2/w"):
        load_params(tmodel, tree)


def test_forward_loss_and_grad_match(models):
    cfg, _, tmodel, params = models
    batch = demo_batch(cfg, 6, 0, np.random.default_rng(0))
    tp = load_params(tmodel, jax.tree.map(np.asarray, params))
    tb = _t(batch)
    pred, aux = jax.jit(lambda p, b: G.forward(p, cfg, b["past"], b["lanes"]))(
        params, batch)
    tpred, taux = TG.forward(tp, tmodel.cfg, tb["past"], tb["lanes"])
    assert tuple(tpred.shape) == (6, 30, 2) and float(taux) == float(aux) == 0.0
    np.testing.assert_allclose(tpred.numpy(), np.asarray(pred), rtol=1e-5,
                               atol=1e-5)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: G.loss_fn(p, cfg, b)))(params, batch)
    tloss, tgrads = torch.func.grad_and_value(
        lambda p: TG.loss_fn(p, tmodel.cfg, tb))(tp)[::-1]
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5, atol=1e-5)
    ref_g = np.concatenate([np.asarray(l).reshape(-1)
                            for l in jax.tree.leaves(grads)])
    np.testing.assert_allclose(tmodel.layout.flatten(tgrads).numpy(), ref_g,
                               rtol=1e-5, atol=1e-5)


def test_max_over_time_splits_tied_gradients_like_jax(models):
    """A constant track makes every interior time step of the actor convs
    equal, so the max over time ties; its gradient must split over the
    tied steps as ``jnp.max``'s does (``torch.max(dim)`` would send it all
    to one step)."""
    cfg, _, tmodel, params = models
    batch = demo_batch(cfg, 3, 0, np.random.default_rng(1))
    batch["past"][:] = 1.0
    tp = load_params(tmodel, jax.tree.map(np.asarray, params))
    grads = jax.jit(jax.grad(lambda p, b: G.loss_fn(p, cfg, b)))(params, batch)
    tgrads = torch.func.grad(lambda p: TG.loss_fn(p, tmodel.cfg, _t(batch)))(tp)
    assert np.abs(np.asarray(grads["actor_conv2"]["w"])).max() > 1e-3
    for key in ("actor_conv1", "actor_conv2"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(tgrads[key][leaf].numpy(),
                                       np.asarray(grads[key][leaf]),
                                       rtol=1e-5, atol=1e-5)


def test_vmapped_device_grads_match(models):
    cfg, _, tmodel, params = models
    rng = np.random.default_rng(2)
    batches = [demo_batch(cfg, 5, 0, rng) for _ in range(N)]
    batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    stacked = jax.tree.map(
        lambda l: np.stack([np.asarray(l) * (1.0 + 0.1 * i) for i in range(N)]),
        params)
    ref_g = jax.jit(jax.vmap(jax.grad(lambda p, b: G.loss_fn(p, cfg, b))))(
        stacked, batch)
    w_n = tmodel.layout.flatten(jax.tree.map(torch.tensor, stacked), lead=1)
    g = device_grads(tmodel, w_n, _t(batch))
    ref_flat = np.concatenate([np.asarray(l).reshape(N, -1)
                               for l in jax.tree.leaves(ref_g)], axis=1)
    np.testing.assert_allclose(g.numpy(), ref_flat, rtol=1e-5, atol=1e-5)


def test_data_is_array_equal():
    a = SyntheticTrajectories(seed=3).make_split(50, seed=4)
    b = TSyntheticTrajectories(seed=3).make_split(50, seed=4)
    assert sorted(a) == sorted(b) == ["future", "lanes", "past"]
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    cfg = get_config(ARCH)
    fl, tfl = FLConfig(num_devices=6), TFLConfig(num_devices=6)
    dev, ev = build_device_data(cfg, fl, train_n=100, eval_n=20, seed=5)
    tdev, tev = t_train.build_device_data(t_get_config(ARCH), tfl,
                                          train_n=100, eval_n=20, seed=5)
    assert len(tdev) == len(dev) == 6
    for d, td in zip(dev + [ev], tdev + [tev]):
        assert sorted(d) == sorted(td)
        for k in d:
            np.testing.assert_array_equal(d[k], td[k])
    rd = demo_batch(cfg, 4, 0, np.random.default_rng(6))
    td = t_demo_batch(t_get_config(ARCH), 4, 0, np.random.default_rng(6))
    for k in rd:
        np.testing.assert_array_equal(rd[k], td[k])


def test_ade_eval_matches(models):
    cfg, model, tmodel, params = models
    _, ev = build_device_data(cfg, FLConfig(num_devices=2), train_n=8,
                              eval_n=64, seed=0)
    ref = float(make_eval_fn(model, cfg)(params, ev))
    tp = load_params(tmodel, jax.tree.map(np.asarray, params))
    port = float(t_make_eval_fn(tmodel, tmodel.cfg)(tp, _t(ev)))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)
    pred = np.random.default_rng(0).normal(0, 3, (7, 30, 2)).astype(np.float32)
    fut = np.random.default_rng(1).normal(0, 3, (7, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(float(TG.ade(torch.tensor(pred), torch.tensor(fut))),
                               float(G.ade(pred, fut)), rtol=1e-6, atol=1e-6)


def test_run_afl_tracks_reference_ade(models, monkeypatch):
    """Six ``mads`` rounds of the loop engine from the same weights, data
    and schedule, with contacts short enough that uploads are sparse: the
    same uploads and mean k, and eval ADE within 1e-5 relative (gradients
    differ in fp32 rounding; a coordinate at the threshold could fall on
    the other side)."""
    cfg, model, tmodel, _ = models
    kw = dict(num_devices=N, rounds=6, batch_size=8, mean_intercontact=20.0,
              mean_contact=0.3)
    fl, tfl = FLConfig(**kw), TFLConfig(**kw)
    state = JIT_INIT(model, cfg, fl, jax.random.key(0))
    monkeypatch.setattr(runner, "afl_init", JIT_INIT)  # the same weights
    dev, ev = build_device_data(cfg, fl, train_n=64, eval_n=64, seed=0)
    ref = run_afl(model, cfg, fl, "mads", DeviceLoader(dev, 8, 0), ev,
                  rounds=6, eval_every=1, engine="loop")
    K.reset_launches()
    port = t_run_afl(tmodel, tmodel.cfg, tfl, "mads", TDeviceLoader(dev, 8, 0),
                     ev, rounds=6, eval_every=1, device="cpu",
                     params=load_params(tmodel, jax.tree.map(np.asarray,
                                                             state.w)))
    assert K.LAUNCHES["sparsify_ef"] == 0  # the CPU path: plain versions
    assert ref.history["round"] == port.history["round"]
    assert port.history["uploads"][-1] > 0
    np.testing.assert_allclose(port.history["uploads"], ref.history["uploads"])
    np.testing.assert_allclose(port.history["k_mean"], ref.history["k_mean"])
    assert 0 < port.history["k_mean"][-1] < tmodel.num_params()
    np.testing.assert_allclose(port.history["eval"], ref.history["eval"],
                               rtol=1e-5)
    assert port.history["eval"][-1] < port.history["eval"][0]


@pytest.mark.parametrize("policy", ["mads", "qsgd", "mads-joint"])
def test_train_cli_runs_lanegcn(tmp_path, policy):
    """The CPU smoke of the paper's Argoverse experiment, per policy."""
    res = t_train.main(["--device", "cpu", "--arch", ARCH, "--width", "32",
                        "--devices", "4", "--rounds", "3", "--eval-every", "1",
                        "--train-n", "200", "--intercontact", "20",
                        "--policy", policy, "--workdir", str(tmp_path)])
    assert res.history["round"] == [1, 2, 3]
    assert np.isfinite(res.history["eval"]).all()
    assert res.history["uploads"][-1] > 0

"""The clients' vmapped gradient of the MoE, hybrid, VLM and audio
families in the port against the JAX reference (the distributed step:
``test_torch_family_dist.py``; the rest of their fine-tuning:
``test_torch_family_finetune.py``).

The MoE dispatch runs under ``torch.func.vmap(torch.func.grad(...))``
with a batching rule for every operator: functorch's fallback warning is
an error here.  The standard against the reference is that of
``test_torch_lm_finetune.py``, held against the port's float64 gradient
on the same inputs: no leaf of the f32 gradient further from f64,
relative to its largest entry, than 1.5 x the reference's farthest.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.afl import device_grads  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
# both MoE configs (Qwen2-MoE has shared experts), the hybrid, the VLM
# (with ``vision_embeds``) and the audio enc-dec (with ``frames``)
GRAD_ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "zamba2-7b",
              "qwen2-vl-72b", "whisper-large-v3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    """Reduced f32 reference and port models, the reference's weights and
    the port's copy of them."""
    cfg = get_config(name).reduced().replace(**F32)
    tcfg = t_get_config(name).reduced().replace(**F32)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    params = jax.jit(model.init)(jax.random.key(0))
    return cfg, model, params, tcfg, tmodel, load_params(
        tmodel, jax.tree.map(np.asarray, params))


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _f64(batch):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_vmapped_gradient_matches_stacked_and_reference(name):
    """``device_grads`` over 3 clients (``torch.func.vmap(torch.func.
    grad(loss_fn))``, any functorch fallback an error) on batches with
    ``vision_embeds`` (VLM) and ``frames`` (audio) as ``demo_batch`` draws
    them.  Held: against each client's own gradient, stacked, within 1e-4
    of each leaf's largest entry (bit-equal but for Qwen2-MoE, 3e-5 off);
    against the reference's ``jax.vmap(jax.grad(loss_fn))`` as
    ``test_loss_fn_gradients_match_reference`` holds it: no leaf further
    from the port's f64 gradient, relative to its largest entry, than 1.5
    x the reference's farthest leaf.  (Reduced Whisper's f32 gradient is
    only good to ~1e-2 of a leaf's largest entry in the reference, ~2e-3
    in the port, so the per-leaf 1e-3 of dense models cannot hold it.)  A
    leaf whose f64 gradient is zero to 1e-6 of the whole gradient's
    largest entry (the key biases: a shift of all of a query's scores
    leaves its softmax alone) is held to that bound instead."""
    cfg, model, params, tcfg, tmodel, tp = _pair(name)
    rng = np.random.default_rng(5)
    one = [demo_batch(cfg, 2, 32, rng) for _ in range(3)]
    batch = {k: np.stack([b[k] for b in one]) for k in one[0]}
    w = tmodel.layout.flatten(tp)
    w_n = torch.stack([w, w * 1.01, w * 0.99])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = device_grads(tmodel, w_n, _tb(batch))
    loss = lambda p, b: tmodel.loss_fn(p, tcfg, b)  # noqa: E731
    stacked = torch.stack([
        tmodel.layout.flatten(torch.func.grad(loss)(
            tmodel.layout.unflatten(w_n[i]), {k: v[i] for k, v in
                                              _tb(batch).items()}))
        for i in range(3)])
    ref_w = jax.tree.map(lambda l: jnp.stack([l, l * 1.01, l * 0.99]), params)
    want = jax.vmap(jax.grad(model.loss_fn), in_axes=(0, None, 0))(
        ref_w, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    model64 = t_build_model(tcfg.replace(dtype=torch.float64,
                                         param_dtype=torch.float64))
    exact = device_grads(model64, w_n.double(), _f64(_tb(batch)))
    layout = tmodel.layout
    top = exact.abs().max().item()
    off = {"ref": 0.0, "port": 0.0}
    for path, g, st, ref, e in zip(layout.paths, layout.leaves(got),
                                   layout.leaves(stacked),
                                   jax.tree.leaves(want),
                                   layout.leaves(exact)):
        ref, e = np.asarray(ref), e.numpy()
        peak = np.abs(e).max()
        np.testing.assert_allclose(g.numpy(), st.numpy(), rtol=0,
                                   atol=1e-4 * peak, err_msg="/".join(path))
        if peak <= 1e-6 * top:
            assert max(np.abs(g.numpy()).max(), np.abs(ref).max()) <= 1e-6 * top
            continue
        off["ref"] = max(off["ref"], np.abs(ref - e).max() / peak)
        off["port"] = max(off["port"], np.abs(g.numpy() - e).max() / peak)
    print(f"{name}: largest f32 error / leaf max against f64: {off}")
    assert off["port"] <= 1.5 * off["ref"]

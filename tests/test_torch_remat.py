"""Activation checkpointing (``ModelConfig.remat``, ``models/remat.py``)
against no checkpoint and against the JAX reference's ``jax.checkpoint``.

* ``full`` and ``dots`` gradients equal ``none``'s bit for bit: under the
  vmapped per-client gradient of training (``core/afl.py::device_grads``)
  for the dense (reduced InternLM2, f32 and bf16) and ssm (reduced Mamba2)
  families, and under one client's ``torch.func.grad`` of the MoE, hybrid,
  audio and VLM ``loss_fn``s (their vmapped training is not ported yet);
* against the reference's ``loss_fn`` gradient with the same ``remat``,
  at test_torch_lm_finetune.py's tolerances (rtol 1e-3, atol 1e-3 x the
  leaf's largest entry, f32);
* what each policy keeps for the backward pass, by the bytes autograd
  saves: ``full`` < ``dots`` < ``none``; and that a checkpoint's gradient
  comes back detached from ``create_graph``'s graph;
* without a gradient every policy runs the layers as they are.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.afl import device_grads  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
SEQ = 64  # a multiple of the reduced SSD chunk (32)
POLICIES = ("full", "dots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, dtype="float32", **kw):
    cfg = t_get_config(name).reduced().replace(dtype=dtype, param_dtype=dtype,
                                               **kw)
    model = t_build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _batch(cfg, n, seed=1):
    return {k: torch.as_tensor(v) for k, v in
            demo_batch(cfg, n, SEQ, np.random.default_rng(seed)).items()}


def _equal(a, b):
    pa, la = tree_flatten(a)
    pb, lb = tree_flatten(b)
    assert pa == pb
    for path, x, y in zip(pa, la, lb):
        assert torch.equal(x, y), ("/".join(path),
                                   (x.float() - y.float()).abs().max())


def test_config_takes_the_three_policies():
    for p in ("none", "full", "dots"):
        assert t_get_config("internlm2-1.8b").replace(remat=p).remat == p
    assert t_get_config("internlm2-1.8b").remat == "none"
    with pytest.raises(ValueError, match="remat"):
        t_get_config("internlm2-1.8b").replace(remat="all")
    with pytest.raises(ValueError, match="remat"):
        remat.checkpoint(lambda t, x: x, "some", {}, torch.ones(2))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,dtype", [("internlm2-1.8b", "float32"),
                                        ("internlm2-1.8b", "bfloat16"),
                                        ("mamba2-2.7b", "float32")],
                         ids=["dense-f32", "dense-bf16", "ssm-f32"])
def test_vmapped_gradients_equal_none(name, dtype, policy):
    """Two clients' gradients, as a training round takes them (one vmapped
    call), bit-equal to no checkpoint."""
    cfg, model, params = _model(name, dtype)
    w_n = model.layout.flatten(params).repeat(2, 1)
    w_n[1] *= 1.01
    batch = {k: v.reshape(2, -1, *v.shape[1:])
             for k, v in _batch(cfg, 4).items()}
    want = device_grads(model, w_n, batch)
    got = device_grads(dataclasses.replace(model, cfg=cfg.replace(remat=policy)),
                       w_n, batch)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "zamba2-7b",
                                  "whisper-large-v3", "qwen2-vl-72b"])
def test_one_client_gradients_equal_none(name, policy):
    """The MoE (aux loss included), hybrid, audio and VLM ``loss_fn``s:
    one client's gradient bit-equal to no checkpoint."""
    cfg, model, params = _model(name)
    batch = _batch(cfg, 2)

    def grad(c):
        return torch.func.grad(lambda p: model.loss_fn(p, c, batch))(params)

    _equal(grad(cfg.replace(remat=policy)), grad(cfg))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["internlm2-1.8b", "mamba2-2.7b"])
def test_gradients_match_reference_with_the_same_remat(name, policy):
    """The port's ``loss_fn`` gradient under ``remat`` against the
    reference's under the same ``remat``, from the reference's weights."""
    cfg = get_config(name).reduced().replace(remat=policy, **F32)
    tcfg = t_get_config(name).reduced().replace(remat=policy, **F32)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    params = jax.jit(model.init)(jax.random.key(0))
    tp = load_params(tmodel, jax.tree.map(np.asarray, params))
    batch = demo_batch(cfg, 2, SEQ, np.random.default_rng(1))
    grads = jax.grad(model.loss_fn)(params, cfg,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tgrads = torch.func.grad(lambda p: tmodel.loss_fn(p, tcfg, tb))(tp)
    paths, got = tree_flatten(tgrads)
    for path, want, g in zip(paths, jax.tree.leaves(grads), got):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()),
                                   err_msg="/".join(path))


def _saved_bytes(model, cfg, params, batch) -> int:
    """Bytes autograd keeps for the backward pass of one ``loss_fn``."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    leaves = [p.requires_grad_() for p in tree_flatten(params)[1]]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model.loss_fn(params, cfg, batch)
    torch.autograd.grad(loss, leaves)
    return total


def test_policies_keep_less_for_the_backward():
    """full keeps each layer's inputs, dots those plus the weight products,
    none everything: saved bytes full < dots < none, and the gradient
    through plain autograd is the same under each."""
    cfg, model, params = _model("internlm2-1.8b", num_layers=4)
    batch = _batch(cfg, 2)
    saved = {p: _saved_bytes(model, cfg.replace(remat=p), params, batch)
             for p in ("none", "full", "dots")}
    assert saved["full"] < saved["dots"] < saved["none"], saved


@pytest.mark.parametrize("policy", ("none",) + POLICIES)
def test_checkpoint_gradient_holds_no_graph(policy):
    """``torch.func.grad`` differentiates with create_graph=True; a layer's
    gradient through a checkpoint comes back detached from that graph (so
    the layer's recomputed activations are freed when its backward
    returns), the layers' stacked weights' gradients with it; without a
    checkpoint they carry the graph."""
    cfg, model, params = _model("internlm2-1.8b")
    batch = _batch(cfg, 2)
    leaves = [p.requires_grad_() for p in tree_flatten(params)[1]]
    loss = model.loss_fn(params, cfg.replace(remat=policy), batch)
    grads = torch.autograd.grad(loss, leaves, create_graph=True)
    layers = [g for (path, _), g in zip(
        zip(*tree_flatten(params)), grads) if path[0] == "layers"]
    assert all(g.requires_grad == (policy == "none") for g in layers)


def test_no_checkpoint_without_a_gradient(monkeypatch):
    """Under ``no_grad`` (serving, evals) the layers run as they are: no
    checkpoint Function is applied and the logits equal ``none``'s."""
    cfg, model, params = _model("internlm2-1.8b")
    tokens = _batch(cfg, 2)["tokens"]
    calls = []
    real = remat._Checkpoint.apply
    monkeypatch.setattr(remat._Checkpoint, "apply",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        want = model.forward(params, cfg, tokens)[0]
        for p in POLICIES:
            got = model.forward(params, cfg.replace(remat=p), tokens)[0]
            assert torch.equal(got, want)
    assert not calls
    loss = model.loss_fn(params, cfg.replace(remat="full"), _batch(cfg, 2))
    assert calls and torch.isfinite(loss)

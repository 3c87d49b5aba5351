"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
reference's ``repro/models/moe.py``: top-k ties, the capacity dispatch
(which tokens each expert keeps and which it drops), a decode batch where
two tokens want one expert, padded groups and their load-balance loss,
and int8 expert weights carried by ``load_params``.

The kept and dropped sets are compared bit for bit; outputs in float32 at
rtol/atol 1e-5 (atol scaled by the largest entry: the reduced init's
experts are drawn with fan-in = the layer count, so outputs reach |100|);
the auxiliary loss at 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name="qwen3-moe-30b-a3b", **kw):
    kw = {**F32, **kw}
    return (get_config(name).reduced().replace(**kw),
            t_get_config(name).reduced().replace(**kw))


def _moe_params(cfg, tcfg):
    """Layer 0's MoE weights of the reference's reduced model, both sides."""
    params = jax.jit(build_model(cfg).init)(jax.random.key(0))
    tp = load_params(t_build_model(tcfg), jax.tree.map(np.asarray, params))
    return (jax.tree.map(lambda a: a[0], params["layers"]["moe"]),
            layer(tp["layers"], 0)["moe"])


def _ref_plan(logits, cfg):
    """The reference's routing plan, as its ``moe_apply`` computes it."""
    weights, mask = RM.route(logits, cfg)
    pos_in_exp = (jnp.cumsum(mask, axis=1) - 1.0) * mask
    keep = (pos_in_exp < RM._capacity(logits.shape[1], cfg)).astype(jnp.float32) * mask
    return weights, mask, keep


def _close(got, want, tol, name):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=atol,
                               err_msg=name)


def _apply_both(cfg, tcfg, p, tp, x):
    y, aux = jax.jit(lambda p, x: RM.moe_apply(p, cfg, x))(p, x)
    ty, taux = TM.moe_apply(tp, tcfg, torch.from_numpy(x))
    _close(ty, y, 1e-5, "moe output")
    assert abs(float(taux) - float(aux)) <= 1e-6, (float(taux), float(aux))
    return ty


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_to_the_lower_index_as_lax_top_k(k):
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, (64, 6)).astype(np.float32) / 4  # many ties
    probs[:4] = 0.25  # whole rows of ties, as pad tokens' uniform rows
    want_v, want_i = jax.lax.top_k(probs, k)
    got_v, got_i = TM.top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_capacity_drops_the_same_tokens_as_reference():
    """capacity_factor 0.25: each expert keeps 10 of the ~40 tokens of an
    80-token group that choose it; the same logits give bit-equal choice
    masks and kept sets, and the whole layer the same output and aux."""
    cfg, tcfg = _configs(capacity_factor=0.25)
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 1, (2, 80, cfg.num_experts)).astype(np.float32)
    weights, mask, keep = jax.jit(lambda l: _ref_plan(l, cfg))(logits)
    tw, tkeep, topi, slot, _ = TM.dispatch(torch.from_numpy(logits), tcfg)
    tmask = torch.zeros_like(tkeep).scatter_(-1, topi, 1.0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    np.testing.assert_allclose(tw.numpy(), np.asarray(weights), rtol=1e-6, atol=1e-7)
    dropped = int((np.asarray(mask) - np.asarray(keep)).sum())
    assert dropped > 0.5 * mask.sum(), dropped
    # each kept choice's slot is its rank among the expert's tokens, < cap
    kept = torch.gather(tkeep, -1, topi) > 0
    assert int(slot[kept].max()) == TM.capacity(80, tcfg) - 1

    p, tp = _moe_params(cfg, tcfg)
    x = rng.normal(0, 1, (2, 40, cfg.d_model)).astype(np.float32)
    ty = _apply_both(cfg, tcfg, p, tp, x)
    # the layer's own logits give the same kept set on both sides
    logits = np.asarray(x.reshape(1, 80, -1) @ np.asarray(p["router"]))
    _, _, keep = _ref_plan(jnp.asarray(logits), cfg)
    tkeep = TM.dispatch(torch.from_numpy(x).reshape(1, 80, -1) @ tp["router"], tcfg)[1]
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    assert torch.isfinite(ty).all()


def test_decode_batch_of_4_drops_the_second_token_on_a_shared_expert():
    """At decode a group is the batch: 4 tokens, top-2 of 16 experts, so
    each expert holds cap = max(int(4 * 2 * 1.25 / 16), 1) = 1 token.
    Tokens 0 and 2 are equal and so choose the same two experts: token 2
    is dropped by both, in the reference and in the port, and with no
    shared experts its output is exactly zero on both sides."""
    cfg, tcfg = _configs(num_experts=16)
    assert TM.capacity(4, tcfg) == RM._capacity(4, cfg) == 1
    p, tp = _moe_params(cfg, tcfg)
    x = np.random.default_rng(2).normal(0, 1, (4, 1, cfg.d_model)).astype(np.float32)
    x[2] = x[0]
    ty = _apply_both(cfg, tcfg, p, tp, x)
    y = np.asarray(jax.jit(lambda p, x: RM.moe_apply(p, cfg, x))(p, x)[0])
    assert np.all(y[2] == 0) and bool((ty[2] == 0).all())
    assert np.any(y[0] != 0) and bool((ty[0] != 0).any())
    logits = torch.from_numpy(x).reshape(1, 4, -1) @ tp["router"]
    _, tkeep, topi, _, _ = TM.dispatch(logits, tcfg)
    assert torch.equal(topi[0, 0].sort().values, topi[0, 2].sort().values)
    assert float(tkeep[0, 2].sum()) == 0 and float(tkeep[0, 0].sum()) == 2


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"])
def test_padded_groups_match_reference_aux_loss(name):
    """600 tokens make a group of 512 and one of 88 real tokens and 424
    zero pads.  The pads' logits are 0, their probabilities uniform, so
    top-k takes the k lowest experts (ties to the lower index, as
    ``lax.top_k``); they come last and take no real token's slot, but they
    count in the aux loss's means, which agree to 1e-6.  Qwen2-MoE adds
    its shared experts."""
    cfg, tcfg = _configs(name)
    p, tp = _moe_params(cfg, tcfg)
    x = np.random.default_rng(3).normal(0, 1, (2, 300, cfg.d_model)).astype(np.float32)
    _apply_both(cfg, tcfg, p, tp, x)
    xt = torch.nn.functional.pad(torch.from_numpy(x).reshape(600, -1), (0, 0, 0, 424))
    _, _, topi, _, _ = TM.dispatch((xt @ tp["router"]).reshape(2, 512, -1), tcfg)
    k = tcfg.num_experts_per_tok
    assert torch.equal(topi[1, 88:], torch.arange(k).expand(424, k))


def test_int8_experts_are_carried_bit_exactly_and_match_reference():
    """``expert_dtype="int8"``: ``load_params`` keeps the int8 expert
    weights int8 and their f32 scales f32, bit for bit (casting them to
    ``param_dtype`` would round the scales and widen the weights); the
    layer and the whole model's forward then match the reference."""
    cfg, tcfg = _configs(expert_dtype="int8", param_dtype="bfloat16")
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    params = jax.jit(model.init)(jax.random.key(0))
    tp = load_params(tmodel, jax.tree.map(np.asarray, params))
    seen = set()
    for path, (r, t) in zip(tree_flatten(tp)[0],
                            zip(jax.tree.leaves(params), tree_flatten(tp)[1])):
        r = np.asarray(r)
        if r.dtype in (np.int8, np.float32):
            seen.add(str(r.dtype))
            assert t.dtype == {np.dtype(np.int8): torch.int8,
                               np.dtype(np.float32): torch.float32}[r.dtype], path
            np.testing.assert_array_equal(t.numpy(), r)
    assert seen == {"int8", "float32"}
    moe = tp["layers"]["moe"]
    assert moe["wi_gate"].dtype == torch.int8 and moe["s_gate"].dtype == torch.float32
    assert int(moe["wi_gate"].abs().max()) <= 127

    # the port's own init draws int8 leaves in [-127, 127] and constant scales
    own = tmodel.init(torch.Generator().manual_seed(0))["layers"]["moe"]
    assert own["wi_up"].dtype == torch.int8 and int(own["wi_up"].abs().max()) <= 127
    np.testing.assert_array_equal(own["s_down"].numpy(), np.asarray(params["layers"]["moe"]["s_down"]))

    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, aux = jax.jit(lambda p, t: model.forward(p, cfg, t))(params, toks)
    tlogits, taux = tmodel.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tlogits, logits, 1e-5, "int8-expert forward logits")
    assert abs(float(taux) - float(aux)) <= 1e-6

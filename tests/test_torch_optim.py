"""The port's ``optim/`` against the JAX reference's: ``sgd``, ``momentum``
(with and without ``nesterov``), ``adamw`` (with and without weight
decay), ``clip_by_global_norm`` and ``apply_updates``, on constant rates
and on the schedules, over several steps of seeded gradients, and the
schedules themselves.

Tolerances: f32 trees within rtol 1e-6 (atol 1e-6 of the largest entry,
for entries near 0); bf16 parameters within one bf16 ulp (rtol 2^-8),
since an update computed in f32 an ulp apart can round to the
neighbouring bf16 value.  Dtypes are held exactly: f32 moments, an int32
count, updates in the parameter's dtype where the reference casts them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as RO  # noqa: E402
from repro.optim.optimizers import apply_updates as r_apply  # noqa: E402
from repro_torch import optim as TO  # noqa: E402

SHAPES = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}
STEPS = 5


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.normal(0, scale, shapes)).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _close(got, want, dtype, what):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert _dtype_name(g) == str(w.dtype), what
        gn, wn = _np(g), _np(w)
        if dtype == "float32":
            peak = max(np.abs(wn).max(), 1e-30)
            np.testing.assert_allclose(gn, wn, rtol=1e-6, atol=1e-6 * peak,
                                       err_msg=what)
        else:
            np.testing.assert_allclose(gn, wn, rtol=2.0**-8, atol=0,
                                       err_msg=what)


OPTS = {
    "sgd": (lambda O: O.sgd(0.1)),
    "sgd-warmup-cosine": (lambda O: O.sgd(O.warmup_cosine(0.1, 2, 6))),
    "momentum": (lambda O: O.momentum(0.05)),
    "momentum-nesterov": (lambda O: O.momentum(0.05, nesterov=True)),
    "momentum-cosine": (lambda O: O.momentum(O.cosine_decay(0.05, 4, 0.01))),
    "adamw": (lambda O: O.adamw(1e-2)),
    "adamw-decay": (lambda O: O.adamw(1e-3, weight_decay=0.1)),
    "adamw-constant": (lambda O: O.adamw(O.constant(3e-3), b2=0.99,
                                         weight_decay=0.01)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_steps_match_reference(name, dtype):
    """STEPS steps of clipped seeded gradients: updates, states and the
    parameters after ``apply_updates`` each step."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, SHAPES)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rp = _map(lambda a: jnp.asarray(a, jdt), p0)
    tp = _map(lambda a: torch.from_numpy(a).to(tdt), p0)
    ropt, topt = OPTS[name](RO), OPTS[name](TO)
    rs, ts = ropt.init(rp), topt.init(tp)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 0
    for step in range(STEPS):
        g = _tree(rng, SHAPES, scale=3.0)
        rg, rnorm = RO.clip_by_global_norm(_map(lambda a: jnp.asarray(a, jdt), g), 4.0)
        tg, tnorm = TO.clip_by_global_norm(
            _map(lambda a: torch.from_numpy(a).to(tdt), g), 4.0)
        assert tnorm.dtype == torch.float32
        np.testing.assert_allclose(float(tnorm), float(rnorm), rtol=1e-6)
        _close(tg, rg, dtype, f"{name} step {step} clipped grads")
        ru, rs = ropt.update(rg, rs, rp)
        tu, ts = topt.update(tg, ts, tp)
        _close(tu, ru, dtype, f"{name} step {step} updates")
        for key in rs:
            if key == "count":
                assert ts[key].dtype == torch.int32
                assert int(ts[key]) == int(rs[key]) == step + 1
            else:
                _close(ts[key], rs[key], "float32", f"{name} step {step} {key}")
        rp, tp = r_apply(rp, ru), TO.apply_updates(tp, tu)
        _close(tp, rp, dtype, f"{name} step {step} params")


@pytest.mark.parametrize("name", ["constant", "cosine_decay", "warmup_cosine"])
def test_schedules_match_reference(name):
    make = {"constant": lambda O: O.constant(0.3),
            "cosine_decay": lambda O: O.cosine_decay(0.3, 7, 0.02),
            "warmup_cosine": lambda O: O.warmup_cosine(0.3, 3, 10, 0.01)}[name]
    rf, tf = make(RO), make(TO)
    for step in range(14):
        want = rf(jnp.asarray(step, jnp.int32))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = tf(arg)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{name} at {step}")

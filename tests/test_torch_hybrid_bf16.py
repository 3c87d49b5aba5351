"""Zamba2's bf16 gradient against its f32 gradient, in both packages.

At 12 layers of full width, as drawn, the hybrid's bf16 gradients sit
5-24 % from f32's in |x|^2 on one card and on a (2, 2) mesh alike
(PERF.md §6).  Whether the port's bf16 path adds error of its own is
held here on the reduced Zamba2 (4 layers, bf16 weights and
activations): from the reference's bf16 draws, carried across, one
client's gradient is taken in bf16 and, from the same values upcast, in
f32, in the port (``core/afl.py::device_grads``) and in the reference
(``jax.grad`` compiled with XLA's excess precision off, so that every
operation rounds to its own dtype as the port's does).

The |x|^2 gap, | |g_bf16|^2 / |g_f32|^2 - 1 | (|x|^2 of round 1 is
eta^2 |g|^2), is a signed sum of the bf16 error against g: on the three
batches here the reference's is 0.32-0.58 % and the port's 0.24-0.74 %,
either the larger by up to 2x, so it cannot tell one package's error
from the other's and is only printed.  The error itself,
e = |g_bf16 - g_f32| / |g_f32|, is held: the reference's 4.43-5.19 %
and the port's 4.54-5.15 %, each batch's two within 3 % of the
reference's (held within 10 %), and the port's bf16 gradient 1.65-1.88 %
of |g_f32| from the reference's bf16 gradient, nearer to it than either
is to f32 (held within half the reference's e), where the two f32
gradients are 1e-5 apart (held within 1e-4).  A layer of the port that
rounded where the reference does not would add to e and to that
distance.
"""
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

ARCH = "zamba2-7b"
SEQ = 64  # two chunks of the reduced SSD
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in leaves])


@pytest.fixture(scope="module")
def reference():
    cfg16 = get_config(ARCH).reduced()
    cfg32 = cfg16.replace(**F32)
    m16, m32 = build_model(cfg16), build_model(cfg32)
    p16 = jax.jit(m16.init)(jax.random.key(0))
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)

    def grad_fn(model, cfg):
        def g(p, b):
            return jax.grad(lambda q: model.loss_fn(q, cfg, b))(p)
        return g

    return dict(cfg16=cfg16, p16=p16, p32=p32,
                g16=jax.jit(grad_fn(m16, cfg16)),
                g32=jax.jit(grad_fn(m32, cfg32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_gap_in_x_norm2_matches_reference(reference, seed):
    """The |x|^2 gaps printed; the bf16 error held against the
    reference's (the module's docstring)."""
    ref = reference
    batch = demo_batch(ref["cfg16"], 2, SEQ, np.random.default_rng(seed))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opts = {"xla_allow_excess_precision": False}
    g16 = ref["g16"].lower(ref["p16"], jb).compile(
        compiler_options=opts)(ref["p16"], jb)
    r16 = _flat(jax.tree.leaves(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), g16)))
    r32 = _flat(jax.tree.leaves(ref["g32"](ref["p32"], jb)))
    got = {}
    for name, cfg in (("f32", t_get_config(ARCH).reduced().replace(**F32)),
                      ("bf16", t_get_config(ARCH).reduced())):
        tm = t_build_model(cfg)
        tp = load_params(tm, jax.tree.map(np.asarray, ref["p16"]))
        tb = {k: torch.as_tensor(v)[None] for k, v in batch.items()}
        g = device_grads(tm, tm.layout.flatten(tp)[None], tb)[0]
        got[name] = g.double().numpy()
    p16, p32 = got["bf16"], got["f32"]
    norm = np.linalg.norm
    ref_gap = abs(r16 @ r16 / (r32 @ r32) - 1.0)
    port_gap = abs(p16 @ p16 / (p32 @ p32) - 1.0)
    ref_err = norm(r16 - r32) / norm(r32)
    port_err = norm(p16 - p32) / norm(p32)
    apart = norm(p16 - r16) / norm(r32)
    print(f"seed {seed}: |x|^2 bf16 against f32: reference {ref_gap:.4g}, "
          f"port {port_gap:.4g}; bf16 error: reference {ref_err:.4g}, port "
          f"{port_err:.4g}, port from reference {apart:.4g}")
    assert norm(p32 - r32) <= 1e-4 * norm(r32), seed  # f32 alike
    assert abs(port_err - ref_err) <= 0.1 * ref_err, (seed, port_err, ref_err)
    assert apart <= 0.5 * ref_err, (seed, apart, ref_err)

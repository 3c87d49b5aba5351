"""The distributed step (``core/distributed.py``) of the MoE, hybrid, VLM
and audio families in the port against the JAX reference's, on batches
that carry ``vision_embeds`` and ``frames`` (the clients' vmapped
gradient alone: ``test_torch_family_grads.py``).

The standard against the reference is that of
``test_torch_lm_finetune.py``, held against the port's float64 step on
the same inputs: a step's update no further from the f64 step, relative
to its largest entry, than twice the reference's; k within 2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.core.mads import MadsController  # noqa: E402
from repro.models.registry import build_model, demo_batch  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core.mads import MadsController as TMadsController  # noqa: E402
from repro_torch.models.registry import build_model as t_build_model  # noqa: E402
from repro_torch.models.registry import load_params  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, lead=()):
    return np.concatenate([np.asarray(l, np.float32).reshape(lead + (-1,))
                           for l in jax.tree.leaves(tree)], axis=-1)


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _f64(batch):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in batch.items()}


def _dist_on(state, dtype):
    return dataclasses.replace(state, **{f: getattr(state, f).to(dtype) for f
                                         in ("w", "w_n", "g_n", "e_n")})


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "zamba2-7b",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_distributed_step_matches_reference(name):
    """``make_afl_train_step`` (no mesh, f32 states, N = 4) against the
    reference's jitted step from the reference's state, on a global batch
    of 8 with ``vision_embeds`` (VLM) or ``frames`` (audio) split over the
    clients; two rounds, every client in contact in the second; every
    coordinate in the threshold's sample.  The
    same uploads, k within 2; the update of w and of w_n no further from
    the port's f64 step, relative to its largest entry, than twice the
    reference's (the round standard above)."""
    cfg = get_config(name).reduced().replace(**F32)
    tcfg = t_get_config(name).reduced().replace(**F32)
    model, tmodel = build_model(cfg), t_build_model(tcfg)
    s = model.num_params()
    # a threshold sample of 2^22 >= s takes every coordinate: the fixed-u
    # threshold is then the exact order statistic and k holds within 2 (at
    # the default 65,536, a swap of two samples of near-equal |x| moves k
    # by ~s/m coordinates, and reduced Whisper's f32 gradients swap some)
    kw = dict(num_clients=N, learning_rate=0.01, rounds=50,
              state_dtype="float32", upload_dtype="float32",
              sample_size=1 << 22)
    rd, td = RD.DistConfig(**kw), TD.DistConfig(**kw)
    td64 = dataclasses.replace(td, state_dtype=torch.float64,
                               upload_dtype=torch.float64,
                               accum_dtype=torch.float64)
    rstate = RD.init_state(model, rd, jax.random.key(0))
    rstep = jax.jit(RD.make_afl_train_step(model, cfg, rd, MadsController(s=s)))
    tstep = TD.make_afl_train_step(tmodel, tcfg, td, TMadsController(s=s))
    tmodel64 = t_build_model(tcfg.replace(dtype=torch.float64,
                                          param_dtype=torch.float64))
    tstep64 = TD.make_afl_train_step(tmodel64, tmodel64.cfg, td64,
                                     TMadsController(s=s))
    rng = np.random.default_rng(8)
    o = np.ones(N, np.float32)
    for r, zeta in enumerate((np.array([1, 0, 1, 0], np.float32), o)):
        batch = demo_batch(cfg, 2 * N, 32, rng)
        assert {"vlm": "vision_embeds", "audio": "frames"}.get(
            cfg.family, "tokens") in batch
        args = (zeta, 8.0 * zeta, o * 1e-9, o * 100.0)
        tstate = TD.init_state(tmodel, td, 0, device="cpu", params=load_params(
            tmodel, jax.tree.map(np.asarray, rstate.w)))
        tstate = dataclasses.replace(
            tstate, w_n=torch.as_tensor(_flat(rstate.w_n, (N,))),
            g_n=torch.as_tensor(_flat(rstate.g_n, (N,))),
            e_n=torch.as_tensor(_flat(rstate.e_n, (N,))),
            kappa=torch.as_tensor(np.array(rstate.kappa)),
            q=torch.as_tensor(np.array(rstate.q)), rnd=int(rstate.rnd))
        rnew, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()},
                         *map(jnp.asarray, args))
        tin = [torch.as_tensor(a) for a in args]
        tnew, tm = tstep(tstate, _tb(batch), *tin)
        enew, _ = tstep64(_dist_on(tstate, torch.float64), _f64(_tb(batch)),
                          *tin)
        np.testing.assert_array_equal(tm["uploads"].numpy(),
                                      np.asarray(rm["uploads"]))
        np.testing.assert_allclose(tm["k"].numpy(), np.asarray(rm["k"]),
                                   atol=2)
        w0, wn0 = tstate.w.double().numpy(), tstate.w_n.double().numpy()
        for q, ref, got, f64 in (
                ("w", _flat(rnew.w), tnew.w, enew.w),
                ("w_n", _flat(rnew.w_n, (N,)), tnew.w_n, enew.w_n)):
            base = w0 if q == "w" else wn0
            f64 = f64.numpy() - base
            peak = max(np.abs(f64).max(), 1e-30)
            d_port = np.abs(got.double().numpy() - base - f64).max() / peak
            d_ref = np.abs(ref.astype(np.float64) - base - f64).max() / peak
            print(f"{name} round {r} {q}: port {d_port:.3g}, reference "
                  f"{d_ref:.3g} of its largest entry from f64")
            assert d_port <= 2 * d_ref + 1e-6, (r, q)
        assert float(tm["uploads"].sum()) == float(zeta.sum())
        rstate = rnew

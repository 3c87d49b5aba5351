"""A ``dp_client`` client's batch split over ranks, with its batch-wide
quantities kept those of the whole batch (gloo on the CPU), against one
process and the JAX reference.

One pair of gloo ranks is spawned for the module on a file store; each
rank holds its rows of the same numpy inputs (rank r rows [r B/2, (r + 1)
B/2), as ``core/distributed.py`` chunks a client's batch) and saves what
it computed; this process holds it:

* ``collectives.all_sum`` (all-reduce forward and backward) under
  ``torch.func.vmap`` over 3 clients of ``torch.func.grad``: a batch
  norm of x @ W whose mean and variance are the whole batch's, each
  rank's loss the mean over its rows; the ranks' gradients summed and
  halved (the round's ``div(all_reduce(g), M)``) equal the gradient of
  the whole batch's loss in one process (f64) within 1e-5 of its largest
  entry, and the ranks' losses halved the whole batch's within 1e-6;
* the same with ``collectives.reduce_from`` (all-reduce forward, the
  identity backward) in its place gives a gradient more than 1e-2 of its
  largest entry away: the statistics' cross terms are lost, and the
  first test can see that fault;
* ``collectives.counts_before`` under ``vmap`` over 3 clients: rank 0
  zeros, rank 1 rank 0's counts, exactly;
* ``models/resnet.py::_conv_bn`` over the pair against the reference's
  (``src/repro/models/resnet.py::_conv_bn``) on the whole batch: the
  rank's rows of the output within 1e-5 of the largest entry, and the
  gradient of sum(out * c) for the conv weight, the scale and the bias
  (the ranks' summed) within 1e-4 of each's largest entry;
* ``models/moe.py::moe_apply`` over the pair (``batch_axis``: 600
  tokens in groups of 512, so that the rank-1 tokens span both groups,
  whose slots need ``counts_before``, and the second group holds 424 pads
  on the last rank) against the reference's ``moe_apply`` on the whole
  batch: the rank's output rows within 1e-5 of the largest entry and
  ``aux`` within 1e-6 relative; ``keep`` and the slots of the rank's
  rows bit-equal to one process's on the whole batch; and the router's
  gradient of the aux loss, taken under ``vmap(grad)`` on each rank and
  summed over the pair and halved, within 1e-5 of the largest entry of
  ``jax.grad`` of the reference's aux.

In this process: ``steps.materialize`` of a ``dp_client`` train step
draws each rank's state whole, as the step's rules place it.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import resnet as RRES  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 150  # seconds a spawned process may take
M = 2  # the ranks a client's batch is split over
CLIENTS = 3
BN = (4, 8, 8, 3, 5)  # rows, height, width, in- and out-channels
MOE = (2, 300)  # rows, tokens a row: 600 tokens in groups of 512
MOE_CFG = dict(num_experts=4, d_model=16, moe_d_ff=8)


def _moe_cfg(get):
    return get("qwen3-moe-30b-a3b").reduced().replace(
        dtype="float32", param_dtype="float32", **MOE_CFG)


def _inputs() -> dict:
    rng = np.random.default_rng(30)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    b, h, w, ci, co = BN
    cfg = _moe_cfg(get_config)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "x": f(CLIENTS, 6, 4), "w": f(CLIENTS, 4, 3), "c": f(CLIENTS, 6, 3),
        "counts": rng.integers(0, 9, (M, CLIENTS, 2, 4)).astype(np.float32),
        "bn": {"w": f(3, 3, ci, co) * 0.3, "scale": 1.0 + 0.1 * f(co),
               "bias": 0.1 * f(co)},
        "images": f(b, h, w, ci), "bn_c": f(b, h, w, co),
        "moe": {"router": f(d, e), "wi_gate": f(e, d, ff) * 0.3,
                "wi_up": f(e, d, ff) * 0.3, "wo": f(e, ff, d) * 0.3},
        "tokens": f(*MOE, d),
    }


RANK_SCRIPT = textwrap.dedent(r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from repro_torch.models import resnet as RES
from repro_torch.sharding import collectives as C

torch.set_num_threads(1)
rank, tmp = int(sys.argv[1]), sys.argv[2]
M, CLIENTS, MOE_CFG = %d, %d, %r
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", M),
                        rank=rank, world_size=M)
axis = C.ModelAxis(dist.group.WORLD, rank, M)
data = np.load(f"{tmp}/inputs.npy", allow_pickle=True).item()
t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731


def mine(a, dim=0):  # the rank's rows of a whole batch
    return a.chunk(M, dim=dim)[rank]


def bn_loss(total):
    def loss(w, x, c):  # a batch norm of x @ w, the mean over the rows
        y = x @ w
        n = y.shape[0] * M
        mu = total(y.sum(0), axis) / n
        var = total((y - mu).square().sum(0), axis) / n
        return ((y - mu) * torch.rsqrt(var + 1e-5) * c).sum(1).mean()
    return loss


res = {}
x, w, c = t(data["x"]), t(data["w"]), t(data["c"])
for name, total in (("all_sum", C.all_sum), ("reduce_from", C.reduce_from)):
    axis.counts.clear()
    g = torch.func.vmap(torch.func.grad(bn_loss(total)))(
        w, mine(x, 1), mine(c, 1))
    res[name] = g.numpy()
    res[name + "_counts"] = dict(axis.counts)
    res[name + "_loss"] = torch.func.vmap(bn_loss(total))(
        w, mine(x, 1), mine(c, 1)).numpy()
res["before"] = torch.func.vmap(lambda k: C.counts_before(k, axis))(
    t(data["counts"][rank])).numpy()

# _conv_bn: the rank's rows, the statistics the whole batch's
p = {k: t(v).requires_grad_() for k, v in data["bn"].items()}
xi = mine(t(data["images"])).permute(0, 3, 1, 2)
out = RES._conv_bn(p, xi, axis)
(out * mine(t(data["bn_c"])).permute(0, 3, 1, 2)).sum().backward()
res["bn_out"] = out.detach().permute(0, 2, 3, 1).numpy()
res["bn_grad"] = {k: v.grad.numpy() for k, v in p.items()}

# moe_apply: routes of the rank's rows and of the whole batch
cfg = get_config("qwen3-moe-30b-a3b").reduced().replace(
    dtype="float32", param_dtype="float32", **MOE_CFG)
mp = {k: t(v) for k, v in data["moe"].items()}
xm = t(data["tokens"])
routes = []
real = MOE.dispatch


def spy(logits, cfg_, **kw):
    out = real(logits, cfg_, **kw)
    routes.append((out[1], out[3], kw.get("own")))
    return out


MOE.dispatch = spy
with torch.no_grad():
    y, aux = MOE.moe_apply(mp, cfg, mine(xm), batch_axis=axis)
    MOE.moe_apply(mp, cfg, xm)
MOE.dispatch = real
res["moe_y"], res["moe_aux"] = y.numpy(), float(aux)
res["routes"] = [[None if a is None else a.numpy() for a in r]
                 for r in routes]


def aux_of(router, xs):
    return MOE.moe_apply(dict(mp, router=router), cfg, xs, batch_axis=axis)[1]


axis.counts.clear()
res["moe_grad"] = torch.func.vmap(torch.func.grad(aux_of))(
    mp["router"][None], mine(xm)[None])[0].numpy()
res["moe_counts"] = dict(axis.counts)
np.save(f"{tmp}/rank{rank}.npy", res, allow_pickle=True)
dist.destroy_process_group()
print("RESULT ok")
""" % (M, CLIENTS, MOE_CFG))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_split")
    data = _inputs()
    np.save(tmp / "inputs.npy", data, allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(M)]
    try:
        for r, p in enumerate(procs):
            text, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0 and "RESULT ok" in text, (r, err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return data, [np.load(tmp / f"rank{r}.npy", allow_pickle=True).item()
                  for r in range(M)]


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    atol = tol * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=name)


def _whole_bn_grad(data):
    """One process's gradient of the whole batch's loss, each client."""
    def loss(w, x, c):
        y = x @ w
        z = (y - y.mean(0)) * torch.rsqrt(y.var(0, correction=0) + 1e-5)
        return (z * c).sum(1).mean()

    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    args = t(data["w"]), t(data["x"]), t(data["c"])
    return (torch.func.vmap(torch.func.grad(loss))(*args).numpy(),
            torch.func.vmap(loss)(*args).numpy())


def test_all_sum_gives_the_whole_batch_gradient_under_vmap(spawned):
    data, ranks = spawned
    want, want_loss = _whole_bn_grad(data)
    got = sum(r["all_sum"] for r in ranks) / M
    _close(got, want, 1e-5, "all_sum gradient")
    _close(sum(r["all_sum_loss"] for r in ranks) / M, want_loss, 1e-6,
           "loss")
    for r in ranks:
        # two sums forward, two backward: one collective for the 3 clients
        assert r["all_sum_counts"]["all-reduce"][0] == 4


def test_reduce_from_in_its_place_gives_another_gradient(spawned):
    data, ranks = spawned
    want, _ = _whole_bn_grad(data)
    got = sum(r["reduce_from"] for r in ranks) / M
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


def test_counts_before_under_vmap(spawned):
    data, ranks = spawned
    assert np.array_equal(ranks[0]["before"], np.zeros_like(data["counts"][0]))
    assert np.array_equal(ranks[1]["before"], data["counts"][0])


def test_conv_bn_on_split_rows_matches_reference(spawned):
    data, ranks = spawned
    p = {k: jnp.asarray(v) for k, v in data["bn"].items()}
    x, c = jnp.asarray(data["images"]), jnp.asarray(data["bn_c"])
    want = np.asarray(RRES._conv_bn(p, x))
    grads = jax.grad(lambda p: jnp.sum(RRES._conv_bn(p, x) * c))(p)
    rows = BN[0] // M
    for r, res in enumerate(ranks):
        _close(res["bn_out"], want[r * rows:(r + 1) * rows], 1e-5,
               f"rank {r} output")
    for k in p:
        _close(sum(res["bn_grad"][k] for res in ranks), grads[k], 1e-4,
               f"gradient of {k}")


def test_moe_apply_on_split_rows_matches_reference(spawned):
    data, ranks = spawned
    cfg = _moe_cfg(get_config)
    p = {k: jnp.asarray(v) for k, v in data["moe"].items()}
    x = jnp.asarray(data["tokens"])
    y, aux = RMOE.moe_apply(p, cfg, x)
    g = jax.grad(lambda r: RMOE.moe_apply(dict(p, router=r), cfg, x)[1])(
        p["router"])
    rows = MOE[0] // M
    for r, res in enumerate(ranks):
        _close(res["moe_y"], np.asarray(y)[r * rows:(r + 1) * rows], 1e-5,
               f"rank {r} output")
        assert abs(res["moe_aux"] - float(aux)) <= 1e-6 * abs(float(aux))
        # the load-balance sum each way, the counts' all-gather forward
        assert {k: n for k, (n, _) in res["moe_counts"].items()} == {
            "all-reduce": 2, "all-gather": 1}
    _close(sum(res["moe_grad"] for res in ranks) / M, g, 1e-5,
           "router gradient of aux")


def test_moe_split_routes_bit_equal_to_whole(spawned):
    """``keep`` and the slots of the rank's tokens (on the last rank with
    the whole batch's pads) equal one process's on the whole batch."""
    _, ranks = spawned
    per = MOE[0] * MOE[1] // M
    for r, res in enumerate(ranks):
        (keep, slot, own), (wk, ws, _) = res["routes"]
        rows = own.reshape(-1) > 0
        n = int(rows.sum())
        e, k = keep.shape[-1], slot.shape[-1]
        assert n == (per if r < M - 1 else wk.shape[0] * wk.shape[1] - r * per)
        assert np.array_equal(keep.reshape(-1, e)[rows],
                              wk.reshape(-1, e)[r * per:r * per + n])
        assert np.array_equal(slot.reshape(-1, k)[rows],
                              ws.reshape(-1, k)[r * per:r * per + n])
        assert wk.reshape(-1, e)[r * per:r * per + n].any()


def test_materialize_places_a_dp_client_state_whole():
    """``steps.materialize`` of a ``dp_client`` train step draws each
    rank's state by the step's rules: the whole parameters on every rank
    of a (1, 2) mesh, as ``build_step``'s placement holds them (drawn on
    the default rules' blocks, a rank's state was half the model)."""
    from repro_torch.configs import InputShape
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.launch import mesh as TM
    from repro_torch.launch.steps import build_step, materialize

    cfg = t_get_config("qwen3-moe-30b-a3b").reduced()
    shape = InputShape("train_4k", 16, 2, "train")
    for rank in range(M):
        mesh = TM.ClientMesh(group=None, rank=rank, world_size=M,
                             device=torch.device("cpu"), model=M)
        built = build_step(cfg, shape, mesh, variant="dp_client")
        state = materialize(built, shape, torch.Generator().manual_seed(0),
                            "cpu", mesh)[0]
        s = built["model"].num_params()
        assert built["system"]["placement"].layout.size == s
        assert state.w.shape == (s,) and state.w_n.shape == (1, s)

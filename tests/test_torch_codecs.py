"""The ``qsgd`` codec, the per-layer (k_l, b_l) solver and codec, and the
segmented ``sparsify_quantize_ef`` against the JAX reference.

Given the same x, budgets and dither seeds, every selection and code is
bit-equal: uploads, errors, the solver's (k_l, b_l) and its scores, and
the codecs' k, bits, b and step.  The port runs all devices in one (N, s)
call; the reference runs one device at a time.  Per-leaf energies are
float sums taken in another order on each side, so the per-layer codec is
compared where the two solvers' (k_l, b_l) agree, and the test asserts
that they do on its draws.  The tree has conv, norm, bias and FC leaves
in unsorted insertion order, and one device holds two all-zero leaves
(tied zero energies).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.compression import perlayer as RP  # noqa: E402
from repro.compression.base import CompressorState  # noqa: E402
from repro.compression.joint import JointCompressor  # noqa: E402
from repro.compression.qsgd import QSGDCompressor  # noqa: E402
from repro.compression.quant import seed_from_key  # noqa: E402
from repro_torch.compression import joint as TJ  # noqa: E402
from repro_torch.compression import perlayer as TP  # noqa: E402
from repro_torch.compression import qsgd as TQ  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402
from repro_torch.utils.tree import TreeLayout  # noqa: E402

N = 4
SHAPES = {"conv2": {"w": (3, 3, 16, 32), "bias": (32,)},
          "conv1": {"w": (3, 3, 3, 16)},
          "norm": {"scale": (32,)},
          "fc": {"w": (32, 10), "b": (10,)}}
LAYOUT = TreeLayout.of({k: {kk: np.zeros(v) for kk, v in d.items()}
                        for k, d in SHAPES.items()})
S = LAYOUT.size
B_GRID = tuple(range(2, 17))
INDEX_BITS = int(np.ceil(np.log2(S)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes: torch's intra-op threads only contend with the
    other test workers (measured 3x slower with 8 threads than with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(flat_row):
    """One device's row as a reference tree of jnp leaves."""
    leaves = [jnp.asarray(l.numpy()) for l in LAYOUT.leaves(torch.tensor(flat_row))]
    tree = {}
    for path, leaf in zip(LAYOUT.paths, leaves):
        tree.setdefault(path[0], {})[path[1]] = leaf
    return tree


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(-1)
                           for l in jax.tree.leaves(tree)])


def _flat_n(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(N, -1)
                           for l in jax.tree.leaves(tree)], axis=1)


def _seeds(keys):
    return np.array([int(seed_from_key(k)) for k in keys], np.int32)


@pytest.fixture(scope="module")
def signal():
    """(g, e): per-leaf scales differ; device 1 holds two all-zero leaves."""
    rng = np.random.default_rng(21)
    g = rng.normal(0, 0.1, (N, S)).astype(np.float32)
    for i, (off, n) in enumerate(zip(LAYOUT.offsets, LAYOUT.sizes)):
        g[:, off:off + n] *= 0.3 + (i % 4)
    zero = [i for i, p in enumerate(LAYOUT.paths) if p[1] in ("bias", "b")]
    for i in zero:
        g[1, LAYOUT.offsets[i]:LAYOUT.offsets[i] + LAYOUT.sizes[i]] = 0.0
    e = rng.normal(0, 0.01, (N, S)).astype(np.float32)
    e[1] = 0.0
    return g, e


def _ref_compress(ref_codec, g, e, budget, keys):
    out = [ref_codec.compress(_tree(g[r]), jnp.float32(budget[r]),
                              CompressorState(error=_tree(e[r]), key=keys[r]))
           for r in range(N)]
    return out


# --- qsgd --------------------------------------------------------------------

# no send (b < 2), b = 2 exactly, b = 9, and b clipped to 16
QSGD_BUDGETS = np.array([100.0, 2 * S + 32, 9 * S + 500, 1e9], np.float32)


def test_qsgd_bit_equal_to_eager_reference(signal):
    g, e = signal
    keys = jax.random.split(jax.random.key(3), N)
    pay, err, st = TQ.QSGDCompressor(s=S).compress(
        torch.tensor(g), torch.tensor(QSGD_BUDGETS), torch.tensor(e),
        torch.tensor(_seeds(keys)), LAYOUT)
    ref = _ref_compress(QSGDCompressor(s=S), g, e, QSGD_BUDGETS, keys)
    for r, (rp, rs, rst) in enumerate(ref):
        np.testing.assert_array_equal(pay[r].numpy(), _flat(rp))
        np.testing.assert_array_equal(err[r].numpy(), _flat(rs.error))
        for key in ("k", "bits", "b", "step"):
            assert float(st[key][r]) == float(rst[key]), (key, r)
    np.testing.assert_array_equal(st["b"].numpy(), [0.0, 2.0, 9.0, 16.0])
    assert (st["bits"] <= torch.tensor(QSGD_BUDGETS)).all()
    assert float(st["k"][0]) == 0.0 and (st["k"][1:] == S).all()
    # a withheld round keeps the whole signal in the error memory
    np.testing.assert_array_equal(err[0].numpy(), g[0] + e[0])
    assert not pay[0].any()


def test_qsgd_within_one_ulp_of_jitted_reference(signal):
    """The reference's codec under jit(vmap) as its afl_round runs it:
    uploads within one ulp (ROADMAP.md queue 3), stats equal."""
    g, e = signal
    keys = jax.random.split(jax.random.key(3), N)
    pay, _, st = TQ.QSGDCompressor(s=S).compress(
        torch.tensor(g), torch.tensor(QSGD_BUDGETS), torch.tensor(e),
        torch.tensor(_seeds(keys)), LAYOUT)
    stack = lambda rows: jax.tree.map(lambda *l: jnp.stack(l),
                                      *[_tree(row) for row in rows])
    rp, _, rst = jax.jit(jax.vmap(QSGDCompressor(s=S).compress))(
        stack(g), jnp.asarray(QSGD_BUDGETS),
        CompressorState(error=stack(e), key=keys))
    for key in ("k", "bits", "b"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(rst[key]))
    np.testing.assert_allclose(st["step"].numpy(), np.asarray(rst["step"]),
                               rtol=2.0**-23, atol=0)
    np.testing.assert_allclose(pay.numpy(), _flat_n(rp), rtol=2.0**-22, atol=0)


# --- the per-layer solver ----------------------------------------------------

SIZES = (1728, 64, 64, 18432, 36864, 128, 640, 10, 2359296, 512, 512, 147456)


@pytest.fixture(scope="module")
def solver_draws():
    """Budgets from empty to saturating and log-normal energies with ties:
    equal pairs, all-zero prefixes and all-equal rows."""
    rng = np.random.default_rng(0)
    rows = 48
    energies = rng.lognormal(0, 3, (rows, len(SIZES))).astype(np.float32)
    energies[::5, 3] = energies[::5, 4]
    energies[::7, :4] = 0.0
    energies[1::9] = 1.0
    budgets = np.exp(rng.uniform(np.log(50.0), np.log(3e8), rows))
    return budgets.astype(np.float32), energies


def test_solver_bit_equal(solver_draws):
    budgets, energies = solver_draws
    s = sum(SIZES)
    ib = int(np.ceil(np.log2(s)))
    tb, te = torch.tensor(budgets), torch.tensor(energies)
    k, b = TP.solve_kb_per_leaf(tb, SIZES, te, ib, B_GRID)
    ku, bu = TP.uniform_split(tb, SIZES, ib, B_GRID)
    score = TP.split_score(k, b, SIZES, te)
    sz = np.asarray(SIZES, np.float32)
    for r in range(len(budgets)):
        rb = jnp.float32(budgets[r])
        rk, rbw = RP.solve_kb_per_leaf(rb, SIZES, jnp.asarray(energies[r]),
                                       ib, B_GRID)
        np.testing.assert_array_equal(k[r].numpy(), np.asarray(rk))
        np.testing.assert_array_equal(b[r].numpy(), np.asarray(rbw))
        rku, rbu = RP.uniform_split(rb, SIZES, ib, B_GRID)
        np.testing.assert_array_equal(ku[r].numpy(), np.asarray(rku))
        np.testing.assert_array_equal(bu[r].numpy(), np.asarray(rbu))
        assert float(score[r]) == float(RP.split_score(
            rk, rbw, sz, jnp.asarray(energies[r])))
    np.testing.assert_array_equal(TP.eps_b(torch.tensor(B_GRID)).numpy(),
                                  np.asarray(RP.eps_b(jnp.asarray(B_GRID))))


def test_solver_within_budget_and_never_below_uniform(solver_draws):
    budgets, energies = solver_draws
    ib = int(np.ceil(np.log2(sum(SIZES))))
    tb, te = torch.tensor(budgets), torch.tensor(energies)
    k, b = TP.solve_kb_per_leaf(tb, SIZES, te, ib, B_GRID)
    ku, bu = TP.uniform_split(tb, SIZES, ib, B_GRID)
    cost = (k * (b + ib)).double().sum(-1) + 32.0 * (k > 0).sum(-1)
    assert (cost <= tb.double()).all()
    assert (k >= 0).all() and (k <= torch.tensor(SIZES, dtype=torch.float32)).all()
    assert (TP.split_score(k, b, SIZES, te)
            >= TP.split_score(ku, bu, SIZES, te)).all()


def test_argsort_and_argmax_take_the_first_of_ties():
    """What the solver relies on: a stable descending order keeps tied
    leaves in leaf order, and argmax picks the first maximum, as
    ``jnp.argsort(-d)`` and ``jnp.argmax`` do."""
    d = np.array([[0.0, 2.0, 0.0, 2.0, 1.0, 0.0]], np.float32)
    got = torch.argsort(-torch.tensor(d), dim=-1, stable=True)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argsort(-jnp.asarray(d[0]))))
    assert int(torch.argmax(torch.tensor(d), dim=-1)) == int(jnp.argmax(d[0])) == 1


# --- the per-layer codec -----------------------------------------------------

# infeasible once the per-leaf scales are paid, short, medium, saturating
PL_BUDGETS = np.array([150.0, 4e3, 6e4, 5e6], np.float32)


@pytest.mark.parametrize("method,sample", [("exact", 65536), ("sampled", 1024)])
def test_per_layer_codec_bit_equal(signal, method, sample):
    g, e = signal
    keys = jax.random.split(jax.random.key(9), N)
    port = TJ.JointCompressor(s=S, method=method, sample=sample, per_layer=True)
    reference = JointCompressor(s=S, method=method, sample=sample,
                                per_layer=True)
    xt = torch.tensor(g) + torch.tensor(e)
    k_l, b_l = TP.solve_kb_per_leaf(torch.tensor(PL_BUDGETS), LAYOUT.sizes,
                                    TP.leaf_energies(xt, LAYOUT), INDEX_BITS,
                                    B_GRID)
    K.reset_launches()
    pay, err, st = port.compress(torch.tensor(g), torch.tensor(PL_BUDGETS),
                                 torch.tensor(e), torch.tensor(_seeds(keys)),
                                 LAYOUT)
    assert K.LAUNCHES["sparsify_quantize_ef_segmented"] == 0  # CPU: plain
    ref = _ref_compress(reference, g, e, PL_BUDGETS, keys)
    for r, (rp, rs, rst) in enumerate(ref):
        leaves = jax.tree.leaves(_tree(g[r] + e[r]))
        rk, rb = RP.solve_kb_per_leaf(
            jnp.float32(PL_BUDGETS[r]), LAYOUT.sizes, RP.leaf_energies(leaves),
            INDEX_BITS, B_GRID)
        # the premise of the comparison: both solvers chose the same split
        np.testing.assert_array_equal(k_l[r].numpy(), np.asarray(rk))
        np.testing.assert_array_equal(b_l[r].numpy(), np.asarray(rb))
        np.testing.assert_array_equal(pay[r].numpy(), _flat(rp))
        np.testing.assert_array_equal(err[r].numpy(), _flat(rs.error))
        for key in ("k", "bits", "b", "step"):
            assert float(st[key][r]) == float(rst[key]), (key, r)
    assert (st["bits"] <= torch.tensor(PL_BUDGETS)).all()
    assert float(st["k"][0]) == 0.0 and (st["k"][1:] > 0).all()
    assert (st["step"] == 0).all()
    # at a medium budget the water-filling funds some leaves and not others
    assert (k_l[2] == 0).any() and (k_l[2] > 0).any()


# --- the segmented kernel's plain version ------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segmented_plain_equals_per_leaf_calls(dtype):
    """One segmented call equals the unsegmented plain version called leaf
    by leaf with base = the leaf's offset (the reference's per-layer call
    pattern), at ragged leaf sizes, thresholds that keep all or nothing,
    and an empty leaf."""
    rng = np.random.default_rng(5)
    sizes = [7, 1, 0, 33, 130, 5, 64]
    offsets = tuple(np.concatenate([[0], np.cumsum(sizes)]).tolist())
    rows, n, leaves = 3, offsets[-1], len(sizes)
    x = torch.tensor(rng.normal(0, 1, (rows, n)).astype(np.float32)).to(dtype)
    t = torch.tensor(rng.uniform(0, 1.5, (rows, leaves)).astype(np.float32))
    t[0, 0], t[1, 3] = 0.0, float("inf")
    steps = torch.tensor(rng.uniform(0.01, 0.1, (rows, leaves)).astype(np.float32))
    levels = torch.tensor(rng.choice([1.0, 7.0, 127.0], (rows, leaves)).astype(np.float32))
    seeds = torch.tensor([11, 2**31 - 2, 12345], dtype=torch.int32)
    K.reset_launches()
    up, err, cnt = ops.sparsify_quantize_ef_segmented(x, t, steps, levels,
                                                      seeds, offsets)
    assert K.LAUNCHES["sparsify_quantize_ef_segmented"] == 0
    assert cnt.shape == (rows, leaves) and cnt.dtype == torch.float32
    for i, (a, b) in enumerate(zip(offsets, offsets[1:])):
        u, e_, c = ref.sparsify_quantize_ef_plain(
            x[:, a:b], t[:, i].contiguous(), steps[:, i].contiguous(),
            levels[:, i].contiguous(), seeds, base=a)
        assert torch.equal(up[:, a:b], u) and torch.equal(err[:, a:b], e_)
        assert torch.equal(cnt[:, i], c)
    assert int(cnt[0, 0]) == 7 and int(cnt[1, 3]) == 0 and not cnt[:, 2].any()

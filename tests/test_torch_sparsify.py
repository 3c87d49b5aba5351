"""Thresholds, tree sparsification and the codecs against the JAX reference.

Given the same x (and the reference's dither seeds and budgets), every
selection is bit-equal: thresholds, masks, counts, uploads and the codecs'
k, bits, b and step.  The port runs all devices in one (N, s) call; the
reference runs one device at a time.  The tree has ResNet-9-like leaves
(4-D HWIO conv weights, biases, an FC matrix) in unsorted insertion order,
so the sampled threshold strides conv leaves and the flatten order is the
sorted one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.compression.base import CompressorState, strict_threshold  # noqa: E402
from repro.compression.joint import JointCompressor  # noqa: E402
from repro.compression.quant import seed_from_key  # noqa: E402
from repro.compression.topk import FixedKbCompressor, TopKCompressor  # noqa: E402
from repro.core import sparsify as SP  # noqa: E402
from repro_torch.compression import joint as TJ  # noqa: E402
from repro_torch.compression import topk as TT  # noqa: E402
from repro_torch.compression.base import strict_threshold as t_strict  # noqa: E402
from repro_torch.core import sparsify as TSP  # noqa: E402
from repro_torch.utils.tree import TreeLayout  # noqa: E402

N = 3
SHAPES = {"conv2": {"w": (3, 3, 32, 64), "bias": (64,)},
          "conv1": {"w": (3, 3, 8, 32)},
          "fc": {"w": (64, 10), "b": (10,)}}
LAYOUT = TreeLayout.of({k: {kk: np.zeros(v) for kk, v in d.items()}
                        for k, d in SHAPES.items()})
S = LAYOUT.size


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


def _flat_n(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(N, -1)
                           for l in jax.tree.leaves(tree)], axis=1)


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(-1)
                           for l in jax.tree.leaves(tree)])


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(3)
    # per-leaf scales differ so the global threshold is not uniform
    x = rng.normal(0, 1, (N, S)).astype(np.float32)
    for i, (off, n) in enumerate(zip(LAYOUT.offsets, LAYOUT.sizes)):
        x[:, off:off + n] *= 0.5 + (i % 5)
    return x


@pytest.mark.parametrize("method,sample", [("exact", 65536), ("sampled", 4096),
                                           ("sampled", 512)])
def test_threshold_for_k(x, method, sample):
    k = np.array([0.0, 37.0, 2000.5], np.float32)
    got = TSP.threshold_for_k(torch.tensor(np.abs(x)), torch.tensor(k),
                              method=method, sample=sample)
    for r in range(N):
        ref = SP.threshold_for_k(jnp.abs(jnp.asarray(x[r])), k[r],
                                 method=method, sample=sample)
        assert float(got[r]) == float(ref)


@pytest.mark.parametrize("method,sample", [("exact", 65536), ("sampled", 4096),
                                           ("sampled", 1000)])
def test_tree_threshold_and_sparsify_tree(x, method, sample):
    k = np.array([1.0, 150.0, 9000.0], np.float32)
    xt = torch.tensor(x)
    t = TSP.tree_threshold(xt, LAYOUT, torch.tensor(k), method=method,
                           sample=sample)
    up, err, cnt = TSP.sparsify_tree(xt, LAYOUT, torch.tensor(k),
                                     method=method, sample=sample)
    for r in range(N):
        tree = _tree(x[r])
        ref_t = SP.tree_threshold(tree, k[r], method=method, sample=sample)
        assert float(t[r]) == float(ref_t)
        u, e, c = SP.sparsify_tree(tree, k[r], method=method, sample=sample)
        np.testing.assert_array_equal(up[r].numpy(), _flat(u))
        np.testing.assert_array_equal(err[r].numpy(), _flat(e))
        assert float(cnt[r]) == float(c)


@pytest.mark.parametrize("method,sample", [("exact", 65536), ("sampled", 2048)])
def test_strict_threshold(x, method, sample):
    k = np.array([0.5, 777.0, float(S)], np.float32)
    got = t_strict(torch.tensor(x), LAYOUT, torch.tensor(k), method=method,
                   sample=sample)
    for r in range(N):
        ref = strict_threshold(_tree(x[r]), k[r], method=method, sample=sample)
        assert float(got[r]) == float(ref)


def test_bits_for_k_and_quantize_values(x):
    k = torch.tensor([0.0, 12.0, float(S)])
    np.testing.assert_array_equal(TSP.bits_for_k(k, S).numpy(),
                                  np.asarray(SP.bits_for_k(jnp.asarray(k.numpy()), S)))
    np.testing.assert_array_equal(
        TSP.k_for_bits(torch.tensor([1e3, 1e7]), S).numpy(),
        np.asarray(SP.k_for_bits(jnp.asarray([1e3, 1e7], jnp.float32), S)))
    q = TSP.quantize_values(torch.tensor(x), LAYOUT, 8)
    for r in range(N):
        ref = SP.quantize_values(_tree(x[r]), 8)
        np.testing.assert_array_equal(q[r].numpy(), _flat(ref))


CODECS = [
    (TopKCompressor, TT.TopKCompressor, {}),
    (TopKCompressor, TT.TopKCompressor, {"u": 8}),
    (FixedKbCompressor, TT.FixedKbCompressor, {"k_frac": 0.02, "b": 6}),
    (JointCompressor, TJ.JointCompressor, {}),
]


@pytest.mark.parametrize("method", ["exact", "sampled"])
@pytest.mark.parametrize("codec", CODECS, ids=["topk32", "topk8", "fixedkb",
                                               "joint"])
def test_codecs_bit_equal(x, codec, method):
    ref_cls, port_cls, kw = codec
    rng = np.random.default_rng(11)
    g = (0.1 * x).astype(np.float32)
    e = rng.normal(0, 0.01, x.shape).astype(np.float32)
    # short, medium and long contact windows; the first one is infeasible
    # for the quantising codecs once the 32-bit scale is paid
    budget = np.array([30.0, 4e4, 3e6], np.float32)
    sample = 2048
    ref = ref_cls(s=S, method=method, sample=sample, **kw)
    port = port_cls(s=S, method=method, sample=sample, **kw)
    keys = jax.random.split(jax.random.key(5), N)
    seeds = np.array([int(seed_from_key(kk)) for kk in keys], np.int32)
    pay, err, st = port.compress(torch.tensor(g), torch.tensor(budget),
                                 torch.tensor(e), torch.tensor(seeds), LAYOUT)
    for r in range(N):
        rp, rs, rst = ref.compress(_tree(g[r]), jnp.float32(budget[r]),
                                   CompressorState(error=_tree(e[r]),
                                                   key=keys[r]))
        np.testing.assert_array_equal(pay[r].numpy(), _flat(rp))
        np.testing.assert_allclose(err[r].numpy(), _flat(rs.error), atol=1e-6)
        for key in ("k", "bits", "b", "step"):
            assert float(st[key][r]) == float(rst[key]), (key, r)
    assert float(st["k"][0]) == 0.0 and float(st["k"][2]) > 0.0


def test_quantised_uploads_within_one_ulp_of_jitted_reference(x):
    """The reference's jitted codec (as its afl_round runs it) rounds some
    quantised uploads one ulp away from its own eager code, its Pallas
    kernel and their oracle, which the port matches bit for bit (above).
    ROADMAP.md queue 3 records this; here it is held to one ulp."""
    g = (0.1 * x).astype(np.float32)
    e = np.zeros_like(g)
    budget = np.array([4e4, 1e5, 3e6], np.float32)
    ref = FixedKbCompressor(s=S, k_frac=0.02, b=6)
    port = TT.FixedKbCompressor(s=S, k_frac=0.02, b=6)
    keys = jax.random.split(jax.random.key(5), N)
    seeds = np.array([int(seed_from_key(kk)) for kk in keys], np.int32)
    pay, _, st = port.compress(torch.tensor(g), torch.tensor(budget),
                               torch.tensor(e), torch.tensor(seeds), LAYOUT)
    stack = lambda rows: jax.tree.map(lambda *l: jnp.stack(l),
                                      *[_tree(row) for row in rows])
    rp, _, rst = jax.jit(jax.vmap(ref.compress))(
        stack(g), jnp.asarray(budget), CompressorState(error=stack(e), key=keys))
    np.testing.assert_array_equal(st["k"].numpy(), np.asarray(rst["k"]))
    np.testing.assert_allclose(pay.numpy(), _flat_n(rp), rtol=2.0**-22, atol=0)


def test_joint_per_layer_is_not_ported(x):
    """It is now: ``per_layer=True`` no longer raises but spends the budget
    through ``perlayer.compress_per_layer`` on x + error (held to the
    reference in test_torch_codecs.py)."""
    from repro_torch.compression.perlayer import compress_per_layer

    comp = TJ.JointCompressor(s=S, per_layer=True)
    g, e = torch.tensor(0.1 * x), torch.full((N, S), 0.01)
    budget, seeds = torch.tensor([30.0, 4e4, 3e6]), torch.arange(N, dtype=torch.int32)
    got = comp.compress(g, budget, e, seeds, LAYOUT)
    want = compress_per_layer(comp, g + e, LAYOUT, budget, seeds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for key in ("k", "bits", "b", "step"):
        assert torch.equal(got[2][key], want[2][key])
    assert float(got[2]["k"][0]) == 0.0 and float(got[2]["k"][2]) > 0.0

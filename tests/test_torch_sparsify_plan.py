"""The sparsify kernels' host partition (``kernels/sparsify_ef.py::plan``).

The CUDA kernels run one wave of blocks over the flat array's pieces
(cut at every 16 KB tile and every (row, leaf) boundary), two units a
block and the rest taken from a counter; the kernel's counts are int64
partials added per (row, leaf) and rounded once, whatever the order.
The segmented kernel reads the pieces from ``plan``'s table; the row
entries' kernel takes tiles and cuts each at the rows it crosses, the
row found from a double product (``Tiles`` in the .cu).  The kernel
itself runs only on the card (tests/test_torch_cuda.py); this holds the
partition on the CPU, for rows of 1, 3 and 20 and the paper models' leaf
layouts, the tiles' pieces against the table's, and the counts combined
in the kernel's order against the plain version's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sparsify_ef as K  # noqa: E402

SLOTS = (660, 528, 3)  # resident blocks: 5 and 4 a SM of 132, and a few
VECS = {"float32": 4, "bfloat16": 8}  # elements a 16-byte vector


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _paper_offsets(arch: str) -> tuple:
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    layout = build_model(get_config(arch)).layout
    return layout.offsets + (layout.size,)


LAYOUTS = {
    "one leaf 7": (0, 7),
    "one leaf 300001": (0, 300001),
    "ragged": (0, 7, 8, 8, 41, 171, 176, 240),  # an empty leaf, short ones
    "resnet9": "resnet9-cifar10",
    "lanegcn": "lanegcn-argoverse",
}


def _offsets(name: str) -> tuple:
    spec = LAYOUTS[name]
    return _paper_offsets(spec) if isinstance(spec, str) else spec


def _segments(rows: int, offsets) -> tuple:
    """Each (row, leaf)'s flat [start, end), in segment order."""
    cols = offsets[-1]
    lo = np.array([r * cols + a for r in range(rows) for a in offsets[:-1]])
    hi = np.array([r * cols + b for r in range(rows) for b in offsets[1:]])
    return lo, hi


@pytest.mark.parametrize("rows", [1, 3, 20])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", list(VECS))
@pytest.mark.parametrize("resident", SLOTS)
@pytest.mark.parametrize("entry", ["rows", "segmented"])
def test_plan_covers_each_element_once_in_one_wave(rows, layout, dtype,
                                                   resident, entry):
    """``plan`` at the row entries' tiles and at the segmented entry's
    (``SEGMENTED_TILE_VECS``: twice as long in bf16)."""
    offsets = _offsets(layout)
    vec, cols = VECS[dtype], offsets[-1]
    total = rows * cols
    tile_vecs = (K.TILE_VECS if entry == "rows"
                 else K.SEGMENTED_TILE_VECS[vec])
    g, pieces = K.plan(rows, cols, offsets, vec, resident, tile_vecs)
    tile = tile_vecs * vec
    # one wave: at most the resident blocks, none idle (block b starts on
    # pieces b and b + G and takes the rest from a counter)
    assert g == min(resident, len(pieces))
    # the pieces tile [0, total) in flat order, none empty
    assert pieces[0, 0] == 0 and pieces[-1, 1] == total
    assert np.array_equal(pieces[1:, 0], pieces[:-1, 1])
    assert (pieces[:, 1] > pieces[:, 0]).all()
    # every tile boundary is a cut, each starting on a 16-byte boundary (the
    # base is aligned), so a piece lies in one tile: its vector body is
    # aligned and at most tile_vecs vectors
    tiles = np.arange(0, total, tile)
    assert np.isin(tiles, pieces[:, 0]).all()
    assert (tiles * (16 // vec) % 16 == 0).all()
    assert (pieces[:, 0] // tile == (pieces[:, 1] - 1) // tile).all()
    # each piece lies in one (row, leaf): its segment's
    lo, hi = _segments(rows, offsets)
    seg = pieces[:, 2]
    assert (lo[seg] <= pieces[:, 0]).all() and (pieces[:, 1] <= hi[seg]).all()
    # the cuts are the tiles' and the (row, leaf) runs' and nothing else,
    # so a tile's pieces are the runs it crosses, in order; an empty leaf
    # has none
    bounds = np.union1d(tiles, lo[hi > lo])
    assert np.array_equal(pieces[:, 0], bounds)
    if total <= 1 << 22:  # tile by tile and element by element where small
        tile_of = pieces[:, 0] // tile
        for t in range(len(tiles)):
            a, e = t * tile, min((t + 1) * tile, total)
            crossed = np.nonzero((lo < e) & (hi > a) & (hi > lo))[0]
            assert np.array_equal(seg[tile_of == t], crossed)
        hits = np.zeros(total, dtype=np.int64)
        for f0, f1, _ in pieces:
            hits[f0:f1] += 1
        assert (hits == 1).all()


def _tile_pieces(rows: int, cols: int, vec: int) -> np.ndarray:
    """The row entries' pieces as the kernel cuts its tiles (``Tiles``:
    load, then each), tile by tile."""
    tile, total = K.TILE_VECS * vec, rows * cols
    out = []
    for a in range(0, total, tile):
        e, r = min(a + tile, total), a // cols
        while a < e:
            b = min(e, (r + 1) * cols)
            out.append((a, b, r))
            a, r = b, r + 1
    return np.array(out, dtype=np.int64).reshape(-1, 3)


@pytest.mark.parametrize("rows", [1, 3, 20])
@pytest.mark.parametrize("cols", [7, 4099, 300001])
@pytest.mark.parametrize("dtype", list(VECS))
@pytest.mark.parametrize("resident", SLOTS)
def test_row_tiles_cut_the_plans_pieces_in_one_wave(rows, cols, dtype,
                                                    resident):
    """The row entries' grid is a block a tile up to the resident blocks,
    and the pieces the kernel cuts from its tiles are ``plan``'s with one
    leaf a row."""
    vec = VECS[dtype]
    tiles = -(-rows * cols // (K.TILE_VECS * vec))
    assert K.row_blocks(rows, cols, vec, resident) == max(1, min(resident,
                                                                 tiles))
    _, pieces = K.plan(rows, cols, (0, cols), vec, resident)
    assert np.array_equal(_tile_pieces(rows, cols, vec), pieces)


@pytest.mark.parametrize("rows,cols", [(20, 6_573_130), (20, 61_775),
                                       (10, 123_550), (2, 1_889_110_016),
                                       (1, 3_212_749_824), (65535, 4099),
                                       (3, 7)])
@pytest.mark.parametrize("dtype", list(VECS))
def test_row_tiles_find_their_row_without_a_division(rows, cols, dtype):
    """``Tiles::load``'s row of a tile's first element: the product with
    the double 1 / cols, truncated, is within one row of the quotient, and
    one correction each way makes it exact (IEEE doubles, as the card's)."""
    a = np.arange(0, rows * cols, K.TILE_VECS * VECS[dtype], dtype=np.int64)
    est = (a.astype(np.float64) * (1.0 / cols)).astype(np.int64)
    want = a // cols
    assert (np.abs(est - want) <= 1).all()
    r = np.where(est * cols > a, est - 1,
                 np.where((est + 1) * cols <= a, est + 1, est))
    assert np.array_equal(r, want)


def test_plan_of_nothing_is_one_block_with_no_pieces():
    g, pieces = K.plan(3, 0, (0, 0), 4, 1056)
    assert g == 1 and pieces.shape == (0, 3)


def _kernel_order_counts(mask: np.ndarray, plan, nseg, seed=0) -> np.ndarray:
    """The kernel's counts: block b takes pieces b and b + G, then pieces
    from a counter (here dealt at random: whichever block asks first), and
    sums their int64 totals while the (row, leaf) stays the same, adding
    the sum into it when it changes."""
    g, pieces = plan
    n = len(pieces)
    rng = np.random.default_rng(seed)
    owner = np.concatenate([np.arange(min(2 * g, n)) % g,
                            rng.integers(0, g, max(n - 2 * g, 0))])
    acc = np.zeros(nseg, dtype=np.int64)
    flat = mask.reshape(-1)
    for b in range(g):
        cur, count = -1, 0
        for f0, f1, s in pieces[owner == b]:
            if s != cur:
                if cur >= 0:
                    acc[cur] += count
                cur, count = s, 0
            count += int(flat[f0:f1].sum())
        if cur >= 0:
            acc[cur] += count
    return acc


def _segmented_inputs(rows, offsets, seed=0):
    rng = np.random.default_rng(seed)
    nl = len(offsets) - 1
    x = torch.from_numpy(rng.standard_normal((rows, offsets[-1]),
                                             dtype=np.float32))
    t = torch.from_numpy(rng.uniform(0.0, 2.0, (rows, nl)).astype(np.float32))
    t[0, 0] = 0.0
    t[-1, -1] = np.inf
    steps = torch.from_numpy(rng.uniform(0.004, 0.054, (rows, nl))
                             .astype(np.float32))
    levels = torch.from_numpy(rng.choice([1.0, 7.0, 127.0], (rows, nl))
                              .astype(np.float32))
    seeds = torch.from_numpy((np.arange(rows) * 7919 + 11).astype(np.int32))
    return x, t, steps, levels, seeds


@functools.cache
def _plain_counts(rows: int, layout: str) -> tuple:
    """The plain version's counts and mask, made once for every slot
    count."""
    offsets = _offsets(layout)
    x, t, steps, levels, seeds = _segmented_inputs(rows, offsets)
    _, _, want = ref.sparsify_quantize_ef_segmented_plain(
        x, t, steps, levels, seeds, offsets)
    mask = (x.abs() >= torch.repeat_interleave(
        t, torch.from_numpy(np.diff(offsets)), dim=1)).numpy()
    return want, mask


@pytest.mark.parametrize("rows", [1, 3, 20])
@pytest.mark.parametrize("layout", ["one leaf 300001", "ragged", "lanegcn"])
@pytest.mark.parametrize("resident", SLOTS)
def test_counts_in_the_kernels_order_equal_the_plain_counts(rows, layout,
                                                            resident):
    offsets = _offsets(layout)
    want, mask = _plain_counts(rows, layout)
    plan = K.plan(rows, offsets[-1], offsets, 4, resident)
    acc = _kernel_order_counts(mask, plan, rows * (len(offsets) - 1))
    got = torch.from_numpy(acc).reshape(rows, -1).to(torch.float32)
    assert torch.equal(got, want)


def test_counts_in_the_kernels_order_past_2_24():
    """A leaf of 2^24 + 3 columns, all kept: its exact count rounds once
    to f32 (16,777,220), as the plain version's does; f32 partial sums
    taken in another order could land elsewhere."""
    big = 2**24 + 3
    offsets = (0, 5, 5 + big, 5 + big + 9)
    x, t, steps, levels, seeds = _segmented_inputs(1, offsets, seed=1)
    t[0, 1] = 0.0
    _, _, want = ref.sparsify_quantize_ef_segmented_plain(
        x, t, steps, levels, seeds, offsets)
    assert float(want[0, 1]) == float(np.float32(big))
    mask = (x.abs() >= torch.repeat_interleave(
        t, torch.tensor(np.diff(offsets)), dim=1)).numpy()
    for resident in (1056, 7):
        plan = K.plan(1, offsets[-1], offsets, 4, resident)
        acc = _kernel_order_counts(mask, plan, 3)
        assert acc[1] == big
        assert torch.equal(torch.from_numpy(acc)[None].to(torch.float32), want)

"""Fused sparsify (+ quantise) + error feedback: the CUDA kernels' wrappers.

Replaces the Pallas kernels of ``src/repro/kernels/sparsify_ef.py``
(``sparsify_ef`` and ``sparsify_quantize_ef``).  Where the reference vmaps
one kernel call per device and per leaf, these take the whole federation
at once: x is (N, s), the flat concatenation of each device's leaves in
flatten order, with one threshold (and one seed, step and levels) per row,
so each call site launches once per round.  The kernels are in
``csrc/sparsify_ef.cu`` (its header says what bounds them and how); their
plain versions are ``ref.py``'s ``sparsify_ef_plain`` /
``sparsify_quantize_ef_plain``.

``sparsify_quantize_ef_segmented_cuda`` takes one threshold, step and
levels per (row, leaf) and does every leaf of every row in one launch,
where the reference's per-layer codec calls its kernel once per leaf and
per device; its plain version is ``sparsify_quantize_ef_segmented_plain``.
``sparsify_quantize_ef_blocks_cuda`` launches the same kernel under a
counter map: x is a rank's blocks of each leaf on a (data, model) mesh,
and each leaf's (g0, R, G, owned) (``core/sparsify.py::block_counters``)
gives its elements the dither counter of their whole-model coordinate
and skips the count of a leaf another rank counts; its plain version is
``sparsify_quantize_ef_blocks_plain``.  Without a map the kernel runs
under world 1's (g0 the leaf's offset, R = G = its size: the flat
column), so both wrappers count their launches as the segmented
kernel's.

Each wrapper takes CUDA tensors only, checks them, launches once on the
current stream and adds one to ``LAUNCHES`` of the kernel it launches;
``ops.py`` sends CPU tensors to the plain versions.  A call is one device
operation: the kernel writes the counts itself, in their final type.

The launch.  The grid is the most blocks the card holds at once of the
kernel launched (``resident_blocks``), fewer for a small x.  The rows x
cols elements are one flat array, cut into pieces of at most a 16 KB
tile and of one (row, leaf) each (``plan``); block b takes units b and b
+ G, then the next from a counter, so the grid sweeps the array together
and a slower SM takes fewer.  The row entries' units are the tiles,
whose pieces (the rows a tile crosses) the kernel works out from the
tile's index and cols (``row_blocks``: their grid); the segmented
entry's units are ``plan``'s pieces over its leaves, a table made on the
host and cached per layout on the device (a captured graph reads it).
Blocks add their counts into a per-device int64 workspace
(``workspace``: a ticket, the unit counter, then one slot a (row,
leaf)); the last block writes the totals out and leaves the workspace at
zero.  The segmented entry's tables and the workspace are made on a call
outside CUDA graph capture: a call during capture that finds either
missing raises (call once at that layout first, as the captured engine's
eager round 0 does).  Two calls on one device must not run at the same
time on two streams: they would share the workspace.  The port makes no
such calls.

Index range.  A row's count is an exact int64 total, so a row may hold
2^31 columns and more (full-width Llama-3.2-3B's s = 3,212,749,824).  The
dither column is ``(base + column) mod 2^32``, the value the reference's
int32 index takes once it is cast to uint32, so a call may cross 2^32;
the plain versions wrap the same way (``compression/quant.py::lowbias32``
takes its index mod 2^32).

Counts come back as f32 of the exact total, rounded once.  The
reference sums per-block f32 counts (blocks of 2^18 elements), which is
exact below 2^24; above it each of its additions can round, and the two
counts agree within one f32 ulp of the count at a row just over 2^24
(``tests/test_torch_kernels.py::test_count_above_2_24_within_one_ulp``;
an ulp is 2 there, 128 near 1e9).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = [
    "LAUNCHES", "library", "plan", "plan_table", "reset_launches",
    "SEGMENTED_TILE_VECS", "TILE_VECS", "resident_blocks", "row_blocks",
    "sparsify_ef_cuda", "sparsify_quantize_ef_blocks_cuda",
    "sparsify_quantize_ef_cuda", "sparsify_quantize_ef_segmented_cuda",
    "workspace",
]

LAUNCHES = {"sparsify_ef": 0, "sparsify_quantize_ef": 0,
            "sparsify_quantize_ef_segmented": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"sparsify_ef": 0, "sparsify_quantize_ef": 1, "segmented": 2}
_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_THREADS = 256  # kThreads of the .cu
TILE_VECS = 4 * _THREADS  # kTileVecs: the most vectors of a row piece
# the segmented entry's tiles, by elements a vector: 16 KB in f32, 32 KB
# in bf16, where the quantising op is near the issue rate and a piece's
# start (a division a thread to place its counter under the map) costs
# time; in f32 the longer tiles ran slower at the small shapes (PERF.md)
SEGMENTED_TILE_VECS = {4: TILE_VECS, 8: 2 * TILE_VECS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' library (built on first use), its C signatures set."""
    lib = build.load("sparsify_ef")
    lib.sparsify_ef_resident_blocks.argtypes = [_INT, _INT]
    lib.sparsify_ef_resident_blocks.restype = _INT
    lib.sparsify_ef_launch.argtypes = [_P, _P, _P, _P, _P, _I64, _P, _I64,
                                       _I64, _INT, _P]
    lib.sparsify_ef_launch.restype = _INT
    lib.sparsify_quantize_ef_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_uint32, _I64, _P, _I64,
        _I64, _INT, _P]
    lib.sparsify_quantize_ef_launch.restype = _INT
    lib.sparsify_quantize_ef_segmented_launch.argtypes = [
        _P, _P, _P, _P, _INT, _P, _P, _P, _P, _P, _I64, _I64, _P, _I64, _P,
        _I64, _I64, _INT, _P]
    lib.sparsify_quantize_ef_segmented_launch.restype = _INT
    return lib


@functools.cache
def resident_blocks(kind: str, dtype: torch.dtype, index: int) -> int:
    """The most blocks of kernel ``kind`` (a key of ``_KINDS``) for x of
    ``dtype`` that card ``index`` holds at once (occupancy times SMs)."""
    with torch.cuda.device(index):
        n = library().sparsify_ef_resident_blocks(_KINDS[kind],
                                                  _DTYPES[dtype])
    if n <= 0:
        raise RuntimeError(f"occupancy query for the {kind} kernel failed: "
                           f"CUDA error {-n}")
    return n


def plan(rows: int, cols: int, offsets, vec: int, resident: int,
         tile_vecs: int = TILE_VECS):
    """The kernels' partition of (rows, cols) elements, leaf boundaries
    ``offsets`` (0, ..., cols) within each row, ``vec`` elements a 16-byte
    vector, at most ``resident`` blocks -> (blocks G, pieces (P, 3) int64
    numpy array).  The flat array is cut at every tile of ``tile_vecs``
    vectors (so a tile starts on a 16-byte boundary) and at every (row,
    leaf) boundary; each piece is (flat first, flat end, segment = row *
    leaves + leaf), in flat order.  The segmented kernel reads this table:
    block b takes pieces b and b + G, then the next of 2 G, 2 G + 1, ...
    from a counter, so the grid sweeps the array together and a slower SM
    takes fewer.  The row entries' kernel takes tiles the same way (G from
    ``row_blocks``) and cuts each at the rows it crosses, which gives the
    pieces of ``plan(rows, cols, (0, cols), ...)``, tile by tile."""
    total = rows * cols
    tile = tile_vecs * vec
    starts = np.arange(0, total, tile, dtype=np.int64)
    off = np.asarray(offsets[:-1], dtype=np.int64)
    seg_starts = (np.arange(rows, dtype=np.int64)[:, None] * cols
                  + off[None, :]).ravel()
    cuts = np.unique(np.concatenate([starts, seg_starts, [total]]))
    lo, hi = cuts[:-1], cuts[1:]
    # the last segment starting at or before a piece: empty leaves skipped
    seg = np.searchsorted(seg_starts, lo, side="right") - 1
    return max(1, min(resident, len(lo))), np.stack([lo, hi, seg], axis=1)


def row_blocks(rows: int, cols: int, vec: int, resident: int) -> int:
    """The row entries' grid: a block a tile, at most ``resident``."""
    tiles = -(-rows * cols // (TILE_VECS * vec))
    return max(1, min(resident, tiles))


_TABLES = {}  # (layout, device) -> (the plan's device table, blocks, pieces)
_WORK = {}  # device index -> int64 workspaces, the newest last; never freed


def _not_capturing(what: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"the sparsify kernels' {what} is made on a call outside CUDA "
            "graph capture: call the kernel once at this layout on this "
            "device before capturing")


def _table(x: torch.Tensor, offsets) -> tuple:
    """(the device table, blocks, pieces) of a segmented launch on x."""
    rows, cols = x.shape
    offsets = tuple(offsets)
    key = (rows, cols, offsets, x.element_size(), x.device)
    if key not in _TABLES:
        _not_capturing("partition table")
        vec = 16 // x.element_size()
        g, pieces = plan(rows, cols, offsets, vec,
                         resident_blocks("segmented", x.dtype,
                                         x.device.index),
                         SEGMENTED_TILE_VECS[vec])
        host = torch.from_numpy(pieces.reshape(-1))
        # pinned and asynchronous: no host sync
        _TABLES[key] = (host.pin_memory().to(x.device, non_blocking=True),
                        g, len(pieces))
    return _TABLES[key]


def plan_table(x: torch.Tensor, offsets) -> torch.Tensor:
    """The int64 device table a segmented launch on x reads: ``plan``'s
    pieces over the leaf boundaries ``offsets`` (tiles of
    ``SEGMENTED_TILE_VECS``), made on the first call at the layout and
    kept for later ones."""
    return _table(x, offsets)[0]


def workspace(device: torch.device, slots: int) -> torch.Tensor:
    """The device's int64 workspace: the ticket, the piece counter, then at
    least ``slots`` count slots, all zero between calls.  A larger one is
    made (outside capture) when a call needs it; older ones stay alive,
    since a captured graph may read them."""
    held = _WORK.setdefault(device.index, [])
    if not held or held[-1].numel() < 2 + slots:
        _not_capturing("workspace")
        size = max(4096, 1 << max(slots - 1, 0).bit_length())
        held.append(torch.zeros(2 + size, dtype=torch.int64, device=device))
    return held[-1]


def _check(x: torch.Tensor, **rows) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kernel takes CUDA tensors, got x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in (float32, bfloat16)")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, s) tensor, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    if not 0 < x.shape[0] <= 65535:
        raise ValueError(f"N = {x.shape[0]} rows not in [1, 65535]")
    want = {"seeds": torch.int32}
    for name, t in rows.items():
        dt = want.get(name, torch.float32)
        if (t.device != x.device or t.dtype != dt
                or tuple(t.shape) != (x.shape[0],) or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous ({x.shape[0]},) {dt} tensor on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_table(name: str, t: torch.Tensor, x: torch.Tensor,
                 leaves: int) -> None:
    want = (x.shape[0], leaves)
    if (t.device != x.device or t.dtype != torch.float32
            or tuple(t.shape) != want or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {want} float32 tensor on "
            f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _rows_call(name: str, x: torch.Tensor, launch, *params):
    """One launch of the row entry ``name``: (upload, error, count f32)."""
    rows, cols = x.shape
    blocks = row_blocks(rows, cols, 16 // x.element_size(),
                        resident_blocks(name, x.dtype, x.device.index))
    work = workspace(x.device, rows)
    up, err = torch.empty_like(x), torch.empty_like(x)
    cnt = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), up.data_ptr(), err.data_ptr(),
                    cnt.data_ptr(), *params, blocks, work.data_ptr(), rows,
                    cols, _DTYPES[x.dtype], stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return up, err, cnt


def sparsify_ef_cuda(x: torch.Tensor, thresholds: torch.Tensor):
    """x (N, s) f32/bf16, thresholds (N,) f32 -> (upload, error, count f32)."""
    _check(x, thresholds=thresholds)
    return _rows_call("sparsify_ef", x, library().sparsify_ef_launch,
                      thresholds.data_ptr())


def sparsify_quantize_ef_cuda(x: torch.Tensor, thresholds, steps, levels,
                              seeds, base: int = 0):
    """x (N, s); thresholds, steps, levels (N,) f32; seeds (N,) int32;
    base: dither counter of column 0 (taken mod 2^32) -> (upload, error,
    count f32)."""
    _check(x, thresholds=thresholds, steps=steps, levels=levels, seeds=seeds)
    return _rows_call("sparsify_quantize_ef", x,
                      library().sparsify_quantize_ef_launch,
                      thresholds.data_ptr(), steps.data_ptr(),
                      levels.data_ptr(), seeds.data_ptr(), int(base) & _M32)


@functools.cache  # a captured graph reads these tables
def _map_table(offsets: tuple, counters: tuple | None, device: torch.device):
    """Each leaf's (first column, g0, R, G, owned) for the kernel; with
    ``counters`` None world 1's: (offset, offset, size, size, 1)."""
    if counters is None:
        rows = [(a, a & _M32, max(b - a, 1), (b - a) & _M32, 1)
                for a, b in zip(offsets, offsets[1:])]
    else:
        rows = [(off, g0 & _M32, max(run, 1), stride & _M32, int(bool(own)))
                for off, (g0, run, stride, own) in zip(offsets, counters)]
    _not_capturing("counter map")
    host = torch.tensor(rows, dtype=torch.int64).reshape(-1, 5)
    return host.pin_memory().to(device, non_blocking=True)


def _segmented(x: torch.Tensor, thresholds, steps, levels, seeds, offsets,
               counters, f32_counts: bool):
    """One launch of the segmented kernel under ``counters`` (None: world
    1's map): (upload, error, count (N, L) f32 or int64)."""
    offsets = tuple(int(o) for o in offsets)
    _check(x, seeds=seeds)
    leaves = len(offsets) - 1
    if (leaves < 1 or offsets[0] != 0 or offsets[-1] != x.shape[1]
            or any(b < a for a, b in zip(offsets, offsets[1:]))):
        raise ValueError(f"offsets must rise from 0 to {x.shape[1]}, got "
                         f"{offsets[:4]}...{offsets[-2:]}")
    if any(b - a > _M32 for a, b in zip(offsets, offsets[1:])):
        raise ValueError("a leaf of the segmented kernel holds at most 2^32 "
                         "columns")
    if counters is not None:
        counters = tuple((int(g0), int(run), int(stride), bool(own))
                         for g0, run, stride, own in counters)
        if len(counters) != leaves or any(
                not 0 <= run <= _M32 or stride < run
                or (b > a and (run < 1 or (b - a) % run))
                for (a, b), (_, run, stride, _) in zip(
                    zip(offsets, offsets[1:]), counters)):
            raise ValueError("counters must give each leaf (g0, R, G, owned)"
                             " with 0 < R <= G, R dividing its size, below "
                             "2^32")
    for tname, t in (("thresholds", thresholds), ("steps", steps),
                     ("levels", levels)):
        _check_table(tname, t, x, leaves)
    table, blocks, npieces = _table(x, offsets)
    cmap = _map_table(offsets if counters is None else offsets[:-1],
                      counters, x.device)
    work = workspace(x.device, x.shape[0] * leaves)
    lib = library()
    up, err = torch.empty_like(x), torch.empty_like(x)
    cnt = torch.empty((x.shape[0], leaves), device=x.device,
                      dtype=torch.float32 if f32_counts else torch.int64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sparsify_quantize_ef_segmented_launch(
            x.data_ptr(), up.data_ptr(), err.data_ptr(), cnt.data_ptr(),
            int(f32_counts), thresholds.data_ptr(), steps.data_ptr(),
            levels.data_ptr(), seeds.data_ptr(), table.data_ptr(), blocks,
            npieces, cmap.data_ptr(), leaves, work.data_ptr(), x.shape[0], x.shape[1],
            _DTYPES[x.dtype], stream)
    _raise_on(rc, "sparsify_quantize_ef_segmented")
    LAUNCHES["sparsify_quantize_ef_segmented"] += 1
    return up, err, cnt


def sparsify_quantize_ef_segmented_cuda(x: torch.Tensor, thresholds, steps,
                                        levels, seeds, offsets):
    """x (N, s); thresholds, steps, levels (N, L) f32; seeds (N,) int32;
    offsets: the L + 1 leaf boundaries 0 = o_0 <= ... <= o_L = s (a
    sequence of ints) -> (upload, error, count (N, L) f32).  The dither
    counter is the column."""
    return _segmented(x, thresholds, steps, levels, seeds, offsets, None,
                      True)


def sparsify_quantize_ef_blocks_cuda(x: torch.Tensor, thresholds, steps,
                                     levels, seeds, offsets, counters):
    """The segmented kernel on a rank's blocks: as
    ``sparsify_quantize_ef_segmented_cuda``, with ``counters`` each
    leaf's (g0, R, G, owned) (the module docstring) -> (upload, error,
    count (N, L) int64, 0 where a leaf is not owned: the exact totals,
    for an all-reduce).  Counted as a launch of the segmented kernel."""
    return _segmented(x, thresholds, steps, levels, seeds, offsets, counters,
                      False)

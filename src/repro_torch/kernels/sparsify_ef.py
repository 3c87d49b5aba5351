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
``ops.py`` sends CPU tensors to the plain versions.

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

import torch

from repro_torch.kernels import build

__all__ = [
    "LAUNCHES", "library", "reset_launches", "sparsify_ef_cuda",
    "sparsify_quantize_ef_blocks_cuda", "sparsify_quantize_ef_cuda",
    "sparsify_quantize_ef_segmented_cuda", "tiles",
]

LAUNCHES = {"sparsify_ef": 0, "sparsify_quantize_ef": 0,
            "sparsify_quantize_ef_segmented": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_THREADS = 256  # kThreads of the .cu
TILE_VECS = 8  # 16-byte vectors per thread in a segmented tile


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' library (built on first use), its C signatures set."""
    lib = build.load("sparsify_ef")
    lib.sparsify_ef_launch.argtypes = [_P, _P, _P, _P, _P, _I64, _I64,
                                       ctypes.c_int, _P]
    lib.sparsify_ef_launch.restype = ctypes.c_int
    lib.sparsify_quantize_ef_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_uint32, _I64, _I64,
        ctypes.c_int, _P]
    lib.sparsify_quantize_ef_launch.restype = ctypes.c_int
    lib.sparsify_quantize_ef_segmented_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _I64, _I64, _I64,
        ctypes.c_int, _P]
    lib.sparsify_quantize_ef_segmented_launch.restype = ctypes.c_int
    return lib


@functools.cache  # unbounded: a captured graph reads these tables
def _tile_table(offsets: tuple, tile: int, device: torch.device):
    rows = [(leaf, c, min(c + tile, end))
            for leaf, (start, end) in enumerate(zip(offsets, offsets[1:]))
            for c in range(start, end, tile)]
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 3).to(device)


@functools.cache  # as ``_tile_table``: keyed on the layout and the map
def _map_table(offsets: tuple, counters: tuple | None, device: torch.device):
    """Each leaf's (first column, g0, R, G, owned) for the kernel; with
    ``counters`` None world 1's: (offset, offset, size, size, 1)."""
    if counters is None:
        rows = [(a, a & _M32, max(b - a, 1), (b - a) & _M32, 1)
                for a, b in zip(offsets, offsets[1:])]
    else:
        rows = [(off, g0 & _M32, max(run, 1), stride & _M32, int(bool(own)))
                for off, (g0, run, stride, own) in zip(offsets, counters)]
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 5).to(device)


def tiles(offsets, dtype: torch.dtype, device) -> torch.Tensor:
    """The segmented kernel's (tiles, 3) int64 table of (leaf, first
    column, end column) for leaf boundaries ``offsets``: each leaf cut
    into tiles of TILE_VECS 16-byte vectors per thread, none crossing a
    leaf boundary.  Cached per layout, dtype and device."""
    per_vec = 16 // dtype.itemsize
    return _tile_table(tuple(int(o) for o in offsets),
                       _THREADS * TILE_VECS * per_vec, torch.device(device))


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


def _outputs(x):
    return (torch.empty_like(x), torch.empty_like(x),
            torch.empty(x.shape[0], dtype=torch.int64, device=x.device))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def sparsify_ef_cuda(x: torch.Tensor, thresholds: torch.Tensor):
    """x (N, s) f32/bf16, thresholds (N,) f32 -> (upload, error, count f32)."""
    _check(x, thresholds=thresholds)
    lib = library()
    up, err, cnt = _outputs(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sparsify_ef_launch(
            x.data_ptr(), up.data_ptr(), err.data_ptr(), cnt.data_ptr(),
            thresholds.data_ptr(), x.shape[0], x.shape[1], _DTYPES[x.dtype],
            stream)
    _raise_on(rc, "sparsify_ef")
    LAUNCHES["sparsify_ef"] += 1
    return up, err, cnt.to(torch.float32)


def sparsify_quantize_ef_cuda(x: torch.Tensor, thresholds, steps, levels,
                              seeds, base: int = 0):
    """x (N, s); thresholds, steps, levels (N,) f32; seeds (N,) int32;
    base: dither counter of column 0 (taken mod 2^32) -> (upload, error,
    count f32)."""
    _check(x, thresholds=thresholds, steps=steps, levels=levels, seeds=seeds)
    lib = library()
    up, err, cnt = _outputs(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sparsify_quantize_ef_launch(
            x.data_ptr(), up.data_ptr(), err.data_ptr(), cnt.data_ptr(),
            thresholds.data_ptr(), steps.data_ptr(), levels.data_ptr(),
            seeds.data_ptr(), int(base) & 0xFFFFFFFF, x.shape[0], x.shape[1],
            _DTYPES[x.dtype], stream)
    _raise_on(rc, "sparsify_quantize_ef")
    LAUNCHES["sparsify_quantize_ef"] += 1
    return up, err, cnt.to(torch.float32)


def _segmented(x: torch.Tensor, thresholds, steps, levels, seeds, offsets,
               counters):
    """One launch of the segmented kernel under ``counters`` (None: world
    1's map): (upload, error, count (N, L) int64)."""
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
    table = tiles(offsets, x.dtype, x.device)
    cmap = _map_table(offsets if counters is None else offsets[:-1],
                      counters, x.device)
    lib = library()
    up, err = torch.empty_like(x), torch.empty_like(x)
    cnt = torch.empty((x.shape[0], leaves), dtype=torch.int64,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sparsify_quantize_ef_segmented_launch(
            x.data_ptr(), up.data_ptr(), err.data_ptr(), cnt.data_ptr(),
            thresholds.data_ptr(), steps.data_ptr(), levels.data_ptr(),
            seeds.data_ptr(), table.data_ptr(), table.shape[0],
            cmap.data_ptr(), leaves, x.shape[0], x.shape[1],
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
    up, err, cnt = _segmented(x, thresholds, steps, levels, seeds, offsets,
                              None)
    return up, err, cnt.to(torch.float32)


def sparsify_quantize_ef_blocks_cuda(x: torch.Tensor, thresholds, steps,
                                     levels, seeds, offsets, counters):
    """The segmented kernel on a rank's blocks: as
    ``sparsify_quantize_ef_segmented_cuda``, with ``counters`` each
    leaf's (g0, R, G, owned) (the module docstring) -> (upload, error,
    count (N, L) int64, 0 where a leaf is not owned: the exact totals,
    for an all-reduce).  Counted as a launch of the segmented kernel."""
    return _segmented(x, thresholds, steps, levels, seeds, offsets, counters)

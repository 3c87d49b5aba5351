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

Each wrapper takes CUDA tensors only, checks them, launches on the current
stream and adds one to ``LAUNCHES[name]``; ``ops.py`` sends CPU tensors to
the plain versions.  Counts come back as f32 of an exact int32 total,
which equals the reference's sum of per-leaf f32 counts below 2^24 (s =
6,573,130 for ResNet-9 is below it).  Above 2^24 the two can differ by an
f32 ulp of the count (64-128 at s ~ 1e9): the reference adds rounded f32
partial counts, the port rounds the exact total once.

``check_index_range`` holds each call inside the kernels' index types
before it launches: a row's count is an int32 (so s < 2^31), and the
dither column ``base + column`` is a uint32 (so base + s <= 2^32).
Nothing widens or splits a call that is out of range: it raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = [
    "INT32_COLUMNS", "LAUNCHES", "UINT32_COLUMNS", "check_index_range",
    "library", "reset_launches", "sparsify_ef_cuda",
    "sparsify_quantize_ef_cuda", "sparsify_quantize_ef_segmented_cuda",
    "tiles",
]

LAUNCHES = {"sparsify_ef": 0, "sparsify_quantize_ef": 0,
            "sparsify_quantize_ef_segmented": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_THREADS = 256  # kThreads of the .cu
TILE_VECS = 8  # 16-byte vectors per thread in a segmented tile
INT32_COLUMNS = 2**31  # a row's count is an int32: s must stay below
UINT32_COLUMNS = 2**32  # the dither column base + i is a uint32


def check_index_range(cols: int, base: int | None = None) -> None:
    """Raise ``ValueError`` unless a row of ``cols`` columns fits the
    kernels' index types: cols < 2^31 (the int32 per-row count) and, for
    the quantising entries (``base`` given), base + cols <= 2^32 (the
    uint32 dither column).  Shapes only: it allocates nothing."""
    cols = int(cols)
    if cols >= INT32_COLUMNS:
        raise ValueError(
            f"s = {cols:,} columns a row reach the sparsify kernels' limit "
            f"of 2^31 - 1 = {INT32_COLUMNS - 1:,}: a row's count is an "
            "int32 (ROADMAP queue 2: int64 counts)")
    if base is not None and int(base) + cols > UINT32_COLUMNS:
        raise ValueError(
            f"base {int(base):,} + s {cols:,} passes the quantising "
            f"kernels' limit of 2^32 = {UINT32_COLUMNS:,}: the dither "
            "column is a uint32")


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
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
        ctypes.c_int, _P]
    lib.sparsify_quantize_ef_segmented_launch.restype = ctypes.c_int
    return lib


@functools.cache  # unbounded: a captured graph reads these tables
def _tile_table(offsets: tuple, tile: int, device: torch.device):
    rows = [(leaf, c, min(c + tile, end))
            for leaf, (start, end) in enumerate(zip(offsets, offsets[1:]))
            for c in range(start, end, tile)]
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 3).to(device)


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
            torch.empty(x.shape[0], dtype=torch.int32, device=x.device))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def sparsify_ef_cuda(x: torch.Tensor, thresholds: torch.Tensor):
    """x (N, s) f32/bf16, thresholds (N,) f32 -> (upload, error, count f32)."""
    _check(x, thresholds=thresholds)
    check_index_range(x.shape[1])
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
    base: dither counter of column 0 -> (upload, error, count f32)."""
    _check(x, thresholds=thresholds, steps=steps, levels=levels, seeds=seeds)
    check_index_range(x.shape[1], base)
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


def sparsify_quantize_ef_segmented_cuda(x: torch.Tensor, thresholds, steps,
                                        levels, seeds, offsets):
    """x (N, s); thresholds, steps, levels (N, L) f32; seeds (N,) int32;
    offsets: the L + 1 leaf boundaries 0 = o_0 <= ... <= o_L = s (a
    sequence of ints) -> (upload, error, count (N, L) f32).  The dither
    counter is the column."""
    offsets = tuple(int(o) for o in offsets)
    _check(x, seeds=seeds)
    check_index_range(x.shape[1], 0)
    leaves = len(offsets) - 1
    if (leaves < 1 or offsets[0] != 0 or offsets[-1] != x.shape[1]
            or any(b < a for a, b in zip(offsets, offsets[1:]))):
        raise ValueError(f"offsets must rise from 0 to {x.shape[1]}, got "
                         f"{offsets[:4]}...{offsets[-2:]}")
    for name, t in (("thresholds", thresholds), ("steps", steps),
                    ("levels", levels)):
        _check_table(name, t, x, leaves)
    table = tiles(offsets, x.dtype, x.device)
    lib = library()
    up, err = torch.empty_like(x), torch.empty_like(x)
    cnt = torch.empty((x.shape[0], leaves), dtype=torch.int32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sparsify_quantize_ef_segmented_launch(
            x.data_ptr(), up.data_ptr(), err.data_ptr(), cnt.data_ptr(),
            thresholds.data_ptr(), steps.data_ptr(), levels.data_ptr(),
            seeds.data_ptr(), table.data_ptr(), table.shape[0], leaves,
            x.shape[0], x.shape[1], _DTYPES[x.dtype], stream)
    _raise_on(rc, "sparsify_quantize_ef_segmented")
    LAUNCHES["sparsify_quantize_ef_segmented"] += 1
    return up, err, cnt.to(torch.float32)

"""Chunked Mamba2 SSD scan: the CUDA kernel's wrapper.

Replaces the Pallas kernel of ``src/repro/kernels/ssd_scan.py``
(``ssd_scan``).  The kernel is ``csrc/ssd_scan.cu`` (its header says what
bounds it and how it tiles a chunk); its plain version is
``ref.py::ssd_scan_plain``.  b and c are read as (B, S, N): the
reference's broadcast over heads is not materialised.

The kernel runs in five phases (cumsum, C Bᵀ, chunk states, state
passing, chunk output); each has a plain version in ``ref.py``
(``ssd_chunk_cumsum`` ... ``ssd_chunk_out``).  The wrapper takes contiguous
f32 CUDA tensors only, checks them, allocates y, the final state and the
phases' scratch, makes the five launches on the current stream and adds
one to ``LAUNCHES["ssd_scan"]``; ``ops.py`` sends CPU tensors to the plain
version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["LAUNCHES", "library", "reset_launches", "ssd_scan_cuda"]

LAUNCHES = {"ssd_scan": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_P, MAX_N, MAX_Q = 64, 128, 1024


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's library (built on first use), its C signature set."""
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def _check(x, a, b, c, q: int) -> None:
    for name, t in (("x", x), ("a", a), ("b", b), ("c", c)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"kernel takes CUDA tensors on one device, got "
                             f"{name} on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}, strides {t.stride()}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (tuple(a.shape) != (bsz, s, h) or b.dim() != 3
            or tuple(b.shape[:2]) != (bsz, s) or c.shape != b.shape):
        raise ValueError(f"shapes x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)} do not fit")
    if not (0 < p <= MAX_P and 0 < n <= MAX_N and 0 < q <= MAX_Q and s % q == 0):
        raise ValueError(f"need P <= {MAX_P}, N <= {MAX_N}, chunk <= {MAX_Q} "
                         f"and S % chunk == 0; got P {p}, N {n}, chunk {q}, S {s}")
    if x.numel() >= 2**31:
        raise ValueError("x too large for int offsets")


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int, scratch: dict | None = None):
    """x (B,S,H,P), a (B,S,H), b/c (B,S,N), all f32; S % min(chunk, S) ==
    0 -> (y (B,S,H,P), final state (B,H,P,N)), f32.

    A dict passed as ``scratch`` receives the phases' outputs: ``acum``
    (B, nc, Q, H) f64, ``cb`` (B, nc, Q, Q) (tiles at or below the
    diagonal written) and ``states`` (B, H, nc, P, N), the state entering
    each chunk."""
    q = min(int(chunk), x.shape[1])
    _check(x, a, b, c, q)
    lib = library()
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // q
    y = torch.empty_like(x)
    st = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    acum = torch.empty((bsz, nc, q, h), dtype=torch.float64, device=x.device)
    cb = torch.empty((bsz, nc, q, q), dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), st.data_ptr(), acum.data_ptr(), cb.data_ptr(),
            states.data_ptr(), bsz, s, h, p, n, q, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    LAUNCHES["ssd_scan"] += 1
    if scratch is not None:
        scratch.update(acum=acum, cb=cb, states=states)
    return y, st

"""Flash-decoding attention: the CUDA kernel's wrapper.

Replaces the Pallas kernel of ``src/repro/kernels/decode_attn.py``
(``decode_attn``).  The kernel is ``csrc/decode_attn.cu`` (its header says
what bounds it and how it splits the cache across blocks); its plain
version is ``ref.py::decode_attn_plain``.

The wrapper takes CUDA tensors only, checks them, clamps ``length`` to the
cache, picks the split of the valid positions across blocks (``splits``),
allocates the output and the f32 workspace of partial results, launches on
the current stream and adds one to ``LAUNCHES["decode_attn"]``; ``ops.py``
sends CPU tensors to the plain version.  ``decode_attn_partials_cuda`` is
the kernel's partials entry (the TPU kernel's own (m, l, acc) outputs, in
head order), counted in ``LAUNCHES["decode_attn_partials"]``; its plain
version is ``ref.py::decode_attn_partials_plain``.  The splits of a
(batch, KV head) are merged by the last of its blocks to finish, which
takes a ticket from an int32 counter per (batch, KV head); the counters
live in one zeroed buffer per device that the kernel leaves zeroed, so
calls on one stream share it (calls on two streams at once would need
two).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["LAUNCHES", "decode_attn_cuda", "decode_attn_partials_cuda",
           "library", "reset_launches", "splits"]

LAUNCHES = {"decode_attn": 0, "decode_attn_partials": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
BLOCKS_PER_SM = 2  # blocks resident per SM (96 KB of shared memory each)
TILE = {torch.float32: 32, torch.bfloat16: 64}  # keys per pipeline tile


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's library (built on first use), its C signature set."""
    lib = build.load("decode_attn")
    for fn in (lib.decode_attn_launch, lib.decode_attn_partials_launch):
        fn.argtypes = [_P] * 6 + [_I] * 9 + [_P]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(heads: int, length: int, sms: int, tile: int = 64):
    """(nsplit, per_split): the valid positions cut into nsplit contiguous
    shares of per_split, a multiple of ``tile``, so that heads * nsplit
    blocks make at most one wave on a card of ``sms`` multiprocessors
    (``BLOCKS_PER_SM`` each); one share when heads alone fill it."""
    want = max(1, sms * BLOCKS_PER_SM // max(heads, 1))
    nsplit = max(1, min(want, -(-length // tile)))
    per_split = -(-max(length, 1) // nsplit)
    per_split = -(-per_split // tile) * tile
    return -(-max(length, 1) // per_split), per_split


_TICKETS: dict = {}  # device -> zeroed int32 ticket counters


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least n ticket counters on ``device`` (zero between launches)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _check(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"kernel takes CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not in (float32, bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, H, D) and k, v (B, S, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    kb, s, kv, kd = k.shape
    if kb != b or kd != d or kv < 1 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k.shape)}")
    g = h // kv
    if d not in (64, 128) or g > 8:
        raise ValueError(f"head dim {d} / group {g} not supported: D in "
                         "(64, 128), G <= 8")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous (one layer's cache "
                         "slice cache[l] of an (L, B, S, KV, D) cache is)")
    if s >= 2**31 // max(kv * d, 1):
        raise ValueError(f"cache of {s} positions too deep for int offsets")
    # k and v rows arrive by 16-byte copies, bf16 q by 4-byte loads
    if k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("k and v must start on a 16-byte boundary and q on "
                         "a 4-byte one (a view at an odd storage offset "
                         "does not)")


def _launch(entry: str, q, k, v, out, length: int) -> None:
    """One launch of the kernel's ``entry`` into ``out`` (the output, or
    the partials' f32 buffer), counted in ``LAUNCHES[entry]``."""
    _check(q, k, v)
    lib = library()
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    length = min(max(int(length), 0), s)
    nsplit, per_split = splits(b * kv, length, _sms(q.device.index),
                               TILE[q.dtype])
    ws = torch.empty(b * kv * nsplit * g * (d + 2) if nsplit > 1 else 1,
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        tk = _tickets(q.device, b * kv)
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"{entry}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr(), tk.data_ptr(), b, s, kv, g, d, length, per_split,
            nsplit, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[entry] += 1


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q (B, H, D), k/v (B, S, KV, D), f32 or bf16; ``length`` valid
    positions (clamped to [0, S]) -> (B, H, D) in q's dtype."""
    out = torch.empty_like(q)
    _launch("decode_attn", q, k, v, out, length)
    return out


def decode_attn_partials_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, length: int) -> tuple:
    """The same attention's partials, all f32: (m (B, H) the max of the
    scaled scores, l (B, H) the sum of exp(s - m), acc (B, H, D) the
    unnormalised output); ``length`` 0 gives m = -inf, l = 0, acc = 0."""
    b, h, d = q.shape
    part = torch.empty(b * h * (d + 2), dtype=torch.float32, device=q.device)
    _launch("decode_attn_partials", q, k, v, part, length)
    return (part[:b * h].view(b, h), part[b * h:2 * b * h].view(b, h),
            part[2 * b * h:].view(b, h, d))

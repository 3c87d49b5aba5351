"""Flash-decoding attention: the CUDA kernel's wrapper.

Replaces the Pallas kernel of ``src/repro/kernels/decode_attn.py``
(``decode_attn``).  The kernel is ``csrc/decode_attn.cu`` (its header says
what bounds it and how it splits the cache across blocks); its plain
version is ``ref.py::decode_attn_plain``.

The wrapper takes CUDA tensors only, checks them, clamps ``length`` to the
cache, picks the split of the valid positions across blocks, allocates the
output and the f32 workspace of partial results, launches on the current
stream and adds one to ``LAUNCHES["decode_attn"]``; ``ops.py`` sends CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["LAUNCHES", "decode_attn_cuda", "library", "reset_launches", "splits"]

LAUNCHES = {"decode_attn": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
BLOCKS_PER_SM = 8  # split target: enough blocks in flight to fill the card
MIN_KEYS = 64  # fewest positions worth a block of their own


def reset_launches() -> None:
    LAUNCHES["decode_attn"] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's library (built on first use), its C signature set."""
    lib = build.load("decode_attn")
    lib.decode_attn_launch.argtypes = [_P] * 5 + [_I] * 9 + [_P]
    lib.decode_attn_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(heads: int, length: int, sms: int):
    """(nsplit, per_split): the valid positions cut into nsplit contiguous
    shares of per_split, so that heads * nsplit blocks fill a card of
    ``sms`` multiprocessors."""
    want = -(-sms * BLOCKS_PER_SM // max(heads, 1))
    nsplit = max(1, min(want, -(-length // MIN_KEYS)))
    per_split = max(1, -(-length // nsplit))
    return -(-max(length, 1) // per_split), per_split


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


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q (B, H, D), k/v (B, S, KV, D), f32 or bf16; ``length`` valid
    positions (clamped to [0, S]) -> (B, H, D) in q's dtype."""
    _check(q, k, v)
    lib = library()
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    length = min(max(int(length), 0), s)
    nsplit, per_split = splits(b * kv, length, _sms(q.device.index))
    out = torch.empty_like(q)
    ws = torch.empty(b * kv * nsplit * g * (d + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr(), b, s, kv, g, d, length, per_split, nsplit,
            _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error {rc}")
    LAUNCHES["decode_attn"] += 1
    return out

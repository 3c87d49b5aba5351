"""The device a run uses, the fp32 math the reference is held to, and the
constant tensors a round reads."""
from __future__ import annotations

import functools

import torch


def resolve_device(name="cuda") -> torch.device:
    """``torch.device(name)``; raises if CUDA is asked for and absent.

    On CUDA it also turns TF32 off for matmuls and cuDNN convolutions
    (cuDNN defaults to TF32, about three decimal digits): the reference
    computes in full fp32.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device 'cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


@functools.cache  # unbounded: a captured graph reads these tensors
def _constant(values, dtype: torch.dtype, device: torch.device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype = torch.float32,
             device="cpu") -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once per (values, dtype,
    device) and shared: read it, never write it.

    A tensor made on the card from host values is a copy that waits for
    the card, and a CUDA graph cannot capture it; a round that reads its
    constants from here copies them once, in its first (eager) run.
    ``values`` is a number or a sequence of numbers.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not isinstance(values, (int, float)):
        values = tuple(values)
    return _constant(values, dtype, dev)

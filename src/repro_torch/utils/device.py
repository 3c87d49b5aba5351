"""The device a run uses, and the fp32 math the reference is held to."""
from __future__ import annotations

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

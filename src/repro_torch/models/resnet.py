"""ResNet-9 for CIFAR-10 — the paper's own image model (§VI, 6.57M params).

conv(3->w) / conv(w->2w)+pool / residual(2w) / conv(2w->4w)+pool /
conv(4w->8w)+pool / residual(8w) / global-max-pool / FC.
BatchNorm uses in-batch statistics in both train and eval (no running
stats), with the population variance, as the reference does.

Parameters keep the reference's tree: HWIO conv weights.  Images enter
``forward`` as NHWC and are permuted to NCHW inside; weights are permuted
to OIHW at each call.  All functions are functional over the params dict,
so ``torch.func.vmap(torch.func.grad(loss_fn))`` gives per-device
gradients over N-stacked params.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import ParamSpec


def _conv_bn_specs(cin, cout):
    return {
        "w": ParamSpec((3, 3, cin, cout), (None, None, None, "mlp")),
        "scale": ParamSpec((cout,), ("mlp",), init="ones"),
        "bias": ParamSpec((cout,), ("mlp",), init="zeros"),
    }


def param_specs(cfg) -> dict:
    w = cfg.d_model  # base width (64)
    return {
        "c1": _conv_bn_specs(3, w),
        "c2": _conv_bn_specs(w, 2 * w),
        "r1a": _conv_bn_specs(2 * w, 2 * w),
        "r1b": _conv_bn_specs(2 * w, 2 * w),
        "c3": _conv_bn_specs(2 * w, 4 * w),
        "c4": _conv_bn_specs(4 * w, 8 * w),
        "r2a": _conv_bn_specs(8 * w, 8 * w),
        "r2b": _conv_bn_specs(8 * w, 8 * w),
        "fc": {
            "w": ParamSpec((8 * w, cfg.vocab_size), ("mlp", None), init="small"),
            "b": ParamSpec((cfg.vocab_size,), (None,), init="zeros"),
        },
    }


def _conv_bn(p, x):
    """3x3 SAME conv (stride 1) + batch-statistics BN + ReLU on NCHW x."""
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1)
    mu = y.mean(dim=(0, 2, 3), keepdim=True)
    var = y.var(dim=(0, 2, 3), keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 1e-5)
    y = y * p["scale"][:, None, None] + p["bias"][:, None, None]
    return F.relu(y)


def forward(params, cfg, images):
    """images: (B, 32, 32, 3) NHWC float32 -> logits (B, classes)."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    x = _conv_bn(params["c1"], x)
    x = F.max_pool2d(_conv_bn(params["c2"], x), 2)
    x = x + _conv_bn(params["r1b"], _conv_bn(params["r1a"], x))
    x = F.max_pool2d(_conv_bn(params["c3"], x), 2)
    x = F.max_pool2d(_conv_bn(params["c4"], x), 2)
    x = x + _conv_bn(params["r2b"], _conv_bn(params["r2a"], x))
    x = torch.amax(x, dim=(2, 3))  # global max pool
    return x @ params["fc"]["w"] + params["fc"]["b"]


def loss_fn(params, cfg, batch):
    logp = torch.log_softmax(forward(params, cfg, batch["images"]), dim=-1)
    labels = batch["labels"].to(torch.int64)
    return -torch.gather(logp, -1, labels[:, None])[:, 0].mean()


def accuracy(params, cfg, batch):
    logits = forward(params, cfg, batch["images"])
    return (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()

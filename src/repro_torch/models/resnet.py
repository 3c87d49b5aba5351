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

Channel-parallel over a ``model_axis`` (a ``sharding.collectives.
ModelAxis``): the rules put each conv's out-channels, its BN scale and
bias, and the FC's rows on ``mlp``, so a rank holds a block of them.  Each
layer takes its input whole and computes its rank's block of the
out-channels; batch-norm statistics are per channel, so a block's are
exact alone, and the pools and the residual adds act on the blocks.  The
next layer gathers the block along the channels (``collectives.feed``).
The global max pool stays on the block, and the FC is row-parallel: one
``reduce_from``, then the whole bias (owned by model index 0).  A layer
whose width does not divide the axis is whole on every rank (the rules'
fallback) and runs whole: its input block is gathered with the gradient
sliced, its output feeds the next layer through ``copy_to``.

Over a ``batch_axis`` (``dp_client``: whole parameters, each client's
batch split over the axis's ranks) a rank holds its rows of the batch,
and each BN layer's statistics are the whole batch's, in the
reference's two passes (``jnp.mean``, then ``jnp.var``'s mean of the
squared deviations): the rank's per-channel sums of y, then of (y -
mu)^2, each added over the axis by ``collectives.all_sum`` (two
all-reduces forward and two backward a layer, of (C,) f32 a client).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import ParamSpec

# each conv's out-channels, in base widths
WIDTHS = {"c1": 1, "c2": 2, "r1a": 2, "r1b": 2, "c3": 4, "c4": 8, "r2a": 8,
          "r2b": 8}


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


def _conv_bn(p, x, batch_axis=None):
    """3x3 SAME conv (stride 1) + batch-statistics BN + ReLU on NCHW x
    (over ``batch_axis``: x the rank's rows, the statistics the whole
    batch's)."""
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1)
    if batch_axis is not None and batch_axis.size > 1:
        n = y.shape[0] * y.shape[2] * y.shape[3] * batch_axis.size

        def total(v):  # the whole batch's per-channel sum, (1, C, 1, 1)
            return C.all_sum(v.sum(dim=(0, 2, 3)), batch_axis)[None, :,
                                                                 None, None]

        mu = total(y) / n
        var = total((y - mu).square()) / n
    else:
        mu = y.mean(dim=(0, 2, 3), keepdim=True)
        var = y.var(dim=(0, 2, 3), keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 1e-5)
    y = y * p["scale"][:, None, None] + p["bias"][:, None, None]
    return F.relu(y)


def forward(params, cfg, images, model_axis=None, batch_axis=None):
    """images: (B, 32, 32, 3) NHWC -> logits (B, classes), in the
    weights' dtype (float32; float64 for a witness in f64); over
    ``batch_axis`` the rank's rows of a batch split over it."""
    x = images.to(params["c1"]["w"].dtype).permute(0, 3, 1, 2)

    def conv(name, x, block: bool):
        """The layer's out-channels (the rank's block of them, and
        whether they are one) from ``x`` (a ``block``, or whole)."""
        p = params[name]
        cut = p["scale"].shape[0] != WIDTHS[name] * cfg.d_model
        if name != "c1":  # the images need no gradient
            x = C.feed(x, model_axis, 1, block, cut)
        return _conv_bn(p, x, batch_axis), cut

    x, b = conv("c1", x, False)
    y, b = conv("c2", x, b)
    x = F.max_pool2d(y, 2)
    x = x + conv("r1b", *conv("r1a", x, b))[0]
    y, b = conv("c3", x, b)
    x = F.max_pool2d(y, 2)
    y, b = conv("c4", x, b)
    x = F.max_pool2d(y, 2)
    x = x + conv("r2b", *conv("r2a", x, b))[0]
    x = torch.amax(x, dim=(2, 3))  # global max pool
    if b:  # the FC row-parallel over the rank's channels
        return C.reduce_from(x @ params["fc"]["w"], model_axis) \
            + params["fc"]["b"]
    return x @ params["fc"]["w"] + params["fc"]["b"]


def loss_fn(params, cfg, batch, model_axis=None, batch_axis=None):
    """Mean cross-entropy; over ``batch_axis`` the mean over the rank's
    rows, with the whole batch's BN statistics."""
    logp = torch.log_softmax(forward(params, cfg, batch["images"],
                                     model_axis, batch_axis), dim=-1)
    labels = batch["labels"].to(torch.int64)
    return -torch.gather(logp, -1, labels[:, None])[:, 0].mean()


def accuracy(params, cfg, batch):
    logits = forward(params, cfg, batch["images"])
    return (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()

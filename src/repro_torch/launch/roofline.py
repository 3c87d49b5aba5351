"""Roofline terms of a step on one NVIDIA H100 (the port of the card-side
half of ``src/repro/launch/roofline.py``).

Terms (per card, seconds):
  compute    = FLOPs / peak FLOP/s                 (989 TFLOP/s bf16)
  memory     = HBM bytes / HBM bandwidth            (3.35 TB/s)
  collective = collective bytes / NVLink bandwidth  (450 GB/s each way)

FLOPs and HBM bytes are the analytic calculator's (``launch/calculator.py``,
as the reference's terms are).  The collective bytes are those of the
collectives the port's step issues, counted from ``core/distributed.py``
and, over a model axis, from ``models/layers.py`` (``step_collectives``)
with the reference's ring factors:
  all-reduce       2 (g-1)/g * result_bytes
  all-gather         (g-1)/g * result_bytes (result = gathered tensor)

The reference reads its collectives from XLA's HLO text
(``parse_collectives``) and keeps XLA's raw ``cost_analysis`` numbers
(``hlo_flops_raw``, ``hlo_bytes_raw``); the port compiles no XLA program,
so it has neither.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.distributed import CHUNK, METRIC_KEYS
from repro_torch.sharding.rules import torch_dtype

PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense on the tensor cores (NVIDIA data sheet)
HBM_BW = 3.35e12  # H100 SXM, HBM3 bytes/s (NVIDIA data sheet)
LINK_BW = 450e9  # H100 SXM, NVLink 4 bytes/s each way to the host's other cards (NVIDIA data sheet)
CARD_BYTES = 80e9  # H100 SXM device memory (NVIDIA data sheet)


def ring_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes a rank moves for one collective over a group of ``g``."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind == "all-gather":
        return (g - 1) / g * result_bytes
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def step_collectives(kind: str, num_params: int, world: int,
                     num_clients: int = 0,
                     upload_dtype: str = "float32", *, model: int = 1,
                     cfg=None, tokens: int = 0, sample: int = 65536,
                     params_per_card: int = 0) -> CollectiveStats:
    """The collectives one rank of the port's step issues, on a (world /
    model, model) mesh.

    Train, over ``data`` (``core/distributed.py::make_afl_train_step``):
    the MES aggregation's ``all_reduce`` of the rank's (s_r,) sum in
    ``upload_dtype``, one per column block of ``CHUNK``, and one
    ``all_gather`` of the round's (len(METRIC_KEYS), N/D) f32 metrics.

    Over ``model`` (``model`` > 1; ``tokens`` the rank's tokens a step):
    the tensor-parallel layers' all-reduces of (tokens, d_model)
    activations (a layer's attention and MLP outputs where they split,
    the vocab-parallel embedding), the all-gathers of the leaves a layer
    gathers (``models/layers.py::gathered_leaves``) and, in training, each
    region's gradient all-reduce and the gathered leaves' gradients ("sum"),
    with the forward counted again under a ``remat`` checkpoint; the
    round's norm and count all-reduces and its threshold sample's
    all-gather.  A world of 1 issues none."""
    from repro_torch.models.layers import gathered_leaves, head_plan
    from repro_torch.sharding.collectives import ModelAxis

    by, cnt = {}, {}

    def add(k, b, n=1):  # n collectives of b bytes each
        by[k] = by.get(k, 0.0) + (b if n == 1 else b * n)
        cnt[k] = cnt.get(k, 0) + n

    data = world // model
    s_r = params_per_card or num_params
    if kind == "train" and data > 1:
        n = num_clients or data
        by["all-reduce"] = ring_bytes("all-reduce", s_r * torch_dtype(
            upload_dtype).itemsize, data)
        cnt["all-reduce"] = math.ceil(s_r / CHUNK)
        add("all-gather", ring_bytes("all-gather", len(METRIC_KEYS) * n * 4,
                                     data))
    if model > 1 and cfg is not None:
        ab = torch_dtype(cfg.dtype).itemsize
        pb = torch_dtype(cfg.param_dtype).itemsize
        act = ring_bytes("all-reduce", tokens * cfg.d_model * ab, model)
        split = (int(head_plan(cfg, ModelAxis(None, 0, model)).split)
                 + int(cfg.d_ff % model == 0))
        vocab = int(cfg.vocab_size % model == 0)
        fwd = 1 + int(kind == "train" and cfg.remat != "none")
        gl = gathered_leaves(cfg, model)
        add("all-reduce", act, cfg.num_layers * split * fwd + vocab)
        for _, shape, grad in gl:
            b = math.prod(shape) * pb
            add("all-gather", ring_bytes("all-gather", b, model),
                cfg.num_layers * fwd)
            if kind == "train" and grad == "sum":
                add("all-reduce", ring_bytes("all-reduce", b, model),
                    cfg.num_layers)
        if vocab:  # the loss's log-sum-exps and label logits
            add("all-gather", ring_bytes("all-gather", tokens * 4 * model,
                                         model))
            add("all-reduce", ring_bytes("all-reduce", tokens * 4, model))
        if kind == "train":
            # the regions' gradient all-reduces, the unembedding's too
            add("all-reduce", act, cfg.num_layers * split + vocab)
            n = max((num_clients or data) // data, 1)
            add("all-reduce", ring_bytes("all-reduce", n * 8, model), 3)
            add("all-gather", ring_bytes("all-gather", n * sample * 4,
                                         model))
    return CollectiveStats(by, cnt)


def model_flops(num_params: int, tokens: int, active_params: int | None = None,
                train: bool = False) -> float:
    """MODEL_FLOPS = 6 N D for training (2 N D serving); MoE uses N_active."""
    mult = 6.0 if train else 2.0
    return mult * float(active_params or num_params) * float(tokens)


@dataclasses.dataclass
class Roofline:
    flops: float  # analytic, per card
    hbm_bytes: float  # analytic, per card
    coll_bytes: float  # the step's collectives, per card
    coll_detail: Dict[str, float]
    coll_counts: Dict[str, int]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float
    useful_ratio: float  # MODEL_FLOPS / analytic total FLOPs

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return dict(dataclasses.asdict(self), bound_s=self.bound_s)


def analyze(analytic, collectives: CollectiveStats, *,
            model_flops_total: float) -> Roofline:
    """The H100 roofline of a step from the calculator's ``Analytic`` and
    the step's collectives."""
    t_c = analytic.flops_per_device / PEAK_FLOPS
    t_m = analytic.hbm_bytes_per_device / HBM_BW
    t_x = collectives.total_bytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return Roofline(
        flops=analytic.flops_per_device, hbm_bytes=analytic.hbm_bytes_per_device,
        coll_bytes=collectives.total_bytes,
        coll_detail=collectives.bytes_by_kind,
        coll_counts=collectives.count_by_kind,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get),
        model_flops_total=model_flops_total,
        useful_ratio=model_flops_total / max(analytic.flops_total, 1e-9),
    )

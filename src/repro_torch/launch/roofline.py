"""Roofline terms of a step on one NVIDIA H100 (the port of the card-side
half of ``src/repro/launch/roofline.py``).

Terms (per card, seconds):
  compute    = FLOPs / peak FLOP/s                 (989 TFLOP/s bf16)
  memory     = HBM bytes / HBM bandwidth            (3.35 TB/s)
  collective = collective bytes / NVLink bandwidth  (450 GB/s each way)

FLOPs and HBM bytes are the analytic calculator's (``launch/calculator.py``,
as the reference's terms are).  The collective bytes are those of the
collectives the port's step issues, counted from ``core/distributed.py``
(``step_collectives``) with the reference's ring factors:
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
                     upload_dtype: str = "float32") -> CollectiveStats:
    """The collectives one rank of the port's step issues.

    Train (``core/distributed.py::make_afl_train_step`` over a mesh of
    ``world`` ranks): the MES aggregation's ``all_reduce`` of the (s,)
    sum in ``upload_dtype``, one per column block of ``CHUNK``, and one
    ``all_gather`` of the round's (len(METRIC_KEYS), N/P) f32 metrics into
    (len(METRIC_KEYS), N).  Serve steps run whole on one card and issue
    none; nor does a world of 1."""
    if kind != "train" or world <= 1:
        return CollectiveStats({}, {})
    n = num_clients or world
    s = num_params
    ub = torch_dtype(upload_dtype).itemsize
    reduce = ring_bytes("all-reduce", s * ub, world)
    gather = ring_bytes("all-gather", len(METRIC_KEYS) * n * 4, world)
    return CollectiveStats({"all-reduce": reduce, "all-gather": gather},
                           {"all-reduce": math.ceil(s / CHUNK),
                            "all-gather": 1})


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

"""Roofline terms of a step on one NVIDIA H100 (the port of the card-side
half of ``src/repro/launch/roofline.py``).

Terms (per card, seconds):
  compute    = FLOPs / peak FLOP/s                 (989 TFLOP/s bf16)
  memory     = HBM bytes / HBM bandwidth            (3.35 TB/s)
  collective = collective bytes / NVLink bandwidth  (450 GB/s each way)

FLOPs and HBM bytes are the analytic calculator's (``launch/calculator.py``,
as the reference's terms are).  The collective bytes are those of the
collectives the port's step issues, counted from ``core/distributed.py``
and, over a model axis, from the models' tensor-parallel layers
(``axis_collectives``, ``step_collectives``)
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


def gathers(cfg, m: int) -> tuple:
    """The leaves a rank of a model axis of ``m`` gathers before use, and
    where: (name, whole shape, the gradient's return ("sum" or "slice"),
    gathers a forward pass, site) each, the site "layer" (a transformer
    layer's attention leaves, ``models/layers.py::gathered_leaves``, and
    the MoE router where the experts split, ``models/moe.py``), "shared"
    (the hybrid's shared attention block, at each invocation), "mamba"
    (every cut leaf of a Mamba2 block whose heads do not divide,
    ``models/mamba2.py``), or the enc-dec's "enc", "dec" and "cross" (its
    encoder's, its decoder's self- and cross-attention leaves,
    ``models/encdec.py``).  The vision and trajectory models gather
    activations, not leaves: none."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.layers import gathered_leaves
    from repro_torch.sharding.collectives import ModelAxis
    from repro_torch.sharding.rules import RULES_TRAIN, logical_to_pspec

    if m == 1 or cfg.family in ("vision", "trajectory"):
        return ()
    out = []
    if cfg.family == "audio":
        return tuple((name, shape, grad, n, site)
                     for site, n in (("enc", cfg.encoder_layers),
                                     ("dec", cfg.num_layers),
                                     ("cross", cfg.num_layers))
                     for name, shape, grad in gathered_leaves(cfg, m))
    if cfg.num_heads:
        hyb = cfg.family == "hybrid"
        out += [(name, shape, grad,
                 _hybrid_invocations(cfg) if hyb else cfg.num_layers,
                 "shared" if hyb else "layer")
                for name, shape, grad in gathered_leaves(cfg, m)]
    if cfg.is_moe and cfg.num_experts % m == 0:
        out.append(("router", (cfg.d_model, cfg.num_experts), "slice",
                    cfg.num_layers, "layer"))
    if cfg.family in ("ssm", "hybrid") and not M2.ssm_split(
            cfg, ModelAxis(None, 0, m)):
        for name, sp in sorted(M2.mamba_specs(cfg).items()):
            if logical_to_pspec(sp.dims, sp.shape, RULES_TRAIN,
                                {"model": m}):
                out.append((name, sp.shape, "slice", cfg.num_layers, "mamba"))
    return tuple(out)


def _hybrid_invocations(cfg) -> int:
    """The hybrid's shared attention block's invocations a forward."""
    from repro_torch.models.hybrid import segments

    return len(segments(cfg)) - 1


def axis_collectives(kind: str, cfg, m: int, tokens: int,
                     clients: int = 1, batch: int = 0, seqs: int = 0) -> list:
    """The collectives over a model axis of ``m`` that one rank's step of
    ``kind`` issues through the model (``sharding/collectives.py``; each
    under the clients' ``vmap`` is one call): (kind, result bytes,
    count) each.  ``tokens``: the rank's tokens a step (all its
    ``clients``; the vision and trajectory models' samples); ``batch``:
    the sequences whose logits a serve step gathers (``tokens`` by
    default); ``seqs``: the rank's sequences, whose encoder frames the
    enc-dec's encoder runs.  Forward: a split region's all-reduce
    (attention, MLP, MoE layer, Mamba2 block and its norm's sum of
    squares), the gathers (``gathers``), the vocab-parallel embedding's
    all-reduce, and in serving the logits' gather, in training the loss's
    gather and all-reduce; under a ``remat`` checkpoint a layer's forward
    twice; a decode over a cache cut on its slots, each attention's merge
    (``_slot_merges``).  Backward (training): each ``copy_to``'s
    all-reduce (a region's input, the whole leaves a rank's own work
    reads, the MoE gate weights, the norm's sum of squares) and each
    "sum" gather's.  The
    vision and trajectory models' are counted by running them on the meta
    device (``_traced_collectives``)."""
    if m == 1:
        return []
    if cfg.family in ("vision", "trajectory"):
        return _traced_collectives(cfg, m, tokens, clients)
    if cfg.family == "audio":
        return _audio_collectives(kind, cfg, m, tokens, clients, batch, seqs)
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import head_plan
    from repro_torch.sharding.collectives import ModelAxis

    train = kind == "train"
    ab = torch_dtype(cfg.dtype).itemsize
    pb = torch_dtype(cfg.param_dtype).itemsize
    axis = ModelAxis(None, 0, m)
    act = tokens * cfg.d_model * ab
    nl = cfg.num_layers
    ev = []

    # the layers' own forward and backward collectives
    if cfg.family in ("ssm", "hybrid"):
        mfwd = 1 + int(train and cfg.remat == "full")
        if M2.ssm_split(cfg, axis):
            _add(ev, "all-reduce", act, nl * mfwd)  # wo's partial sums
            _add(ev, "all-reduce", tokens * 4, nl * mfwd)  # the norm's squares
            if train:
                _add(ev, "all-reduce", act, nl)  # x's copy_to
                _add(ev, "all-reduce", tokens * 4, nl)  # the squares' copy_to
                specs = M2.mamba_specs(cfg)
                for name in M2.WHOLE:  # each whole leaf's copy_to
                    _add(ev, "all-reduce",
                        clients * math.prod(specs[name].shape) * pb, nl)
    if cfg.num_heads:
        n_attn = nl if cfg.family != "hybrid" else _hybrid_invocations(cfg)
        afwd = 1 + int(train and cfg.remat != "none"
                       and cfg.family != "hybrid")
        if head_plan(cfg, axis).split:
            _add(ev, "all-reduce", act, n_attn * afwd)
            if train:
                _add(ev, "all-reduce", act, n_attn)
        _slot_merges(ev, kind, cfg, m, tokens, n_attn)
        if cfg.family in ("dense", "vlm") and cfg.d_ff % m == 0:
            _add(ev, "all-reduce", act, nl * afwd)
            if train:
                _add(ev, "all-reduce", act, nl)
    if cfg.is_moe:
        f = cfg.moe_d_ff or cfg.d_ff
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        routed = e % m == 0 or f % m == 0
        shared = cfg.num_shared_experts and cfg.num_shared_experts * f % m == 0
        fwd = 1 + int(train and cfg.remat != "none")
        if routed or shared:
            _add(ev, "all-reduce", act, nl * fwd)  # the layer's one reduce_from
            if train:
                _add(ev, "all-reduce", act, nl)  # x's copy_to
        if train and routed:
            per = tokens // clients
            g = max(min(MOE.GROUP, per), 1)
            rows = -(-per // g) * g
            _add(ev, "all-reduce", clients * rows * k * 4, nl)  # gate weights
            if e % m and cfg.expert_dtype == "int8":
                _add(ev, "all-reduce", clients * e * 4, 3 * nl)  # the scales
        if train and shared:
            _add(ev, "all-reduce", clients * cfg.d_model * pb, nl)  # shared gate
    for _, shape, grad, n, site in gathers(cfg, m):
        fwd = {"layer": 1 + int(train and cfg.remat != "none"), "shared": 1,
               "mamba": 1 + int(train and cfg.remat == "full")}[site]
        b = clients * math.prod(shape) * pb
        _add(ev, "all-gather", b, n * fwd)
        if train and grad == "sum":
            _add(ev, "all-reduce", b, n)
    _vocab_ends(ev, train, cfg, m, act, tokens,
                (batch or tokens) * cfg.vocab_size * ab)
    return ev


def _add(ev: list, k: str, b: float, n: int) -> None:
    if n:
        ev.append((k, b, n))


def _slot_merges(ev: list, kind: str, cfg, m: int, tokens: int,
                 n: int) -> None:
    """A decode's collectives over a cache whose slots are cut over the
    model axis (``models/layers.py::slot_cut``), for each of its ``n``
    attentions: the merge's all-gather of every rank's (B, H, D + 2) f32
    partials (``collectives.merge_partials``) and, where the rank runs
    its block of the q heads (``layers.q_rows``), q's all-gather before
    it; ``tokens`` the rank's sequences."""
    from repro_torch.models.layers import q_rows, slot_cut
    from repro_torch.sharding.collectives import ModelAxis

    axis = ModelAxis(None, 0, m)
    if kind != "decode" or slot_cut(cfg, axis) is None:
        return
    h, d = cfg.num_heads, cfg.resolved_head_dim
    if q_rows(cfg, axis) is not None:
        ab = torch_dtype(cfg.dtype).itemsize
        _add(ev, "all-gather", tokens * h * d * ab, n)
    _add(ev, "all-gather", m * tokens * h * (d + 2) * 4, n)


def _vocab_ends(ev: list, train: bool, cfg, m: int, act: float,
                tokens: int, logits: float) -> None:
    """The vocab-parallel embedding's and loss's (or logits') collectives
    where the vocabulary divides over ``m``."""
    if cfg.vocab_size % m:
        return
    _add(ev, "all-reduce", act, 1)  # the embedding
    if train:
        _add(ev, "all-gather", tokens * 4 * m, 1)  # the blocks' lse
        _add(ev, "all-reduce", tokens * 4, 1)  # the label logits
        _add(ev, "all-reduce", act, 1)  # the unembedding's copy_to
    else:
        _add(ev, "all-gather", logits, 1)


def _audio_collectives(kind: str, cfg, m: int, tokens: int, clients: int,
                       batch: int, seqs: int) -> list:
    """``axis_collectives`` of the enc-dec (``models/encdec.py``): each
    attention's, each GELU MLP's and the vocabulary's, the encoder output's
    one ``copy_to`` into the cross-attentions; a decode step runs no
    encoder, and its cross-attention reads the cache (no k, v leaves);
    over caches cut on their slots both attentions merge a layer."""
    from repro_torch.models.layers import KV_KEYS, head_plan
    from repro_torch.sharding.collectives import ModelAxis

    train = kind == "train"
    ab = torch_dtype(cfg.dtype).itemsize
    pb = torch_dtype(cfg.param_dtype).itemsize
    fwd = 1 + int(train and cfg.remat == "full")  # remat: "full" only
    act = tokens * cfg.d_model * ab
    act_enc = seqs * cfg.encoder_seq * cfg.d_model * ab
    split = head_plan(cfg, ModelAxis(None, 0, m)).split
    mlp = cfg.d_ff % m == 0
    sites = [("dec", act), ("cross", act)]
    if kind != "decode":
        sites.insert(0, ("enc", act_enc))
    ev = []
    for site, a in sites:
        n = cfg.encoder_layers if site == "enc" else cfg.num_layers
        if split:
            _add(ev, "all-reduce", a, n * fwd)  # attn_out's
            if train:  # the queries' (and self k, v's) input copy_to
                _add(ev, "all-reduce", a, n)
        if mlp and site != "cross":
            _add(ev, "all-reduce", a, n * fwd)
            if train:
                _add(ev, "all-reduce", a, n)
    if split and train:  # the encoder output into the cross-attentions
        _add(ev, "all-reduce", act_enc, 1)
    _slot_merges(ev, kind, cfg, m, tokens, 2 * cfg.num_layers)
    for name, shape, grad, n, site in gathers(cfg, m):
        if kind == "decode" and (site == "enc" or (site == "cross"
                                                   and name in KV_KEYS)):
            continue
        b = clients * math.prod(shape) * pb
        _add(ev, "all-gather", b, n * fwd)
        if train and grad == "sum":
            _add(ev, "all-reduce", b, n)
    _vocab_ends(ev, train, cfg, m, act, tokens,
                (batch or tokens) * cfg.vocab_size * ab)
    return ev


def _traced_collectives(cfg, m: int, samples: int, clients: int) -> list:
    """The vision and trajectory models' collectives a training step,
    counted from the model itself: one client's loss and its gradient run
    on the meta device, on the blocks of model index 0, under a
    ``ModelAxis`` that counts what it would send (a meta tensor is counted
    and not sent, ``sharding/collectives.py``).  Under the clients'
    ``vmap`` each is one call of all ``clients``' ``samples``; a gather's
    bytes are its result's."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import meta_params
    from repro_torch.models.registry import build_model, demo_batch
    from repro_torch.sharding.collectives import ModelAxis
    from repro_torch.sharding.rules import RULES_TRAIN_CLIENT
    from repro_torch.utils.tree import tree_flatten

    model = build_model(cfg)
    params = meta_params(model, model.blocks(
        RULES_TRAIN_CLIENT, {"data": 1, "model": m}, {"data": 0, "model": 0}))
    leaves = [l.requires_grad_() for l in tree_flatten(params)[1]]
    per = samples // clients
    batch = {k: torch.empty((per,) + v.shape[1:],
                            dtype=torch.from_numpy(v).dtype, device="meta")
             for k, v in demo_batch(cfg, 1, 1, np.random.default_rng(0)).items()}
    axis = ModelAxis(None, 0, m)
    torch.autograd.grad(model.loss_fn(params, cfg, batch, model_axis=axis),
                        leaves)
    return [(k, b * clients * (m if k == "all-gather" else 1) / n, n)
            for k, (n, b) in axis.counts.items()]


def data_collectives(cfg, shape, data: int, model: int = 1) -> list:
    """The collectives over a serve step's ``data`` axis of ``data`` ranks
    (``launch/steps.py``; ``shape`` an ``InputShape`` of kind prefill or
    decode): (kind, result bytes, count) each.  Where ``RULES_SERVE``
    puts the batch on ``data``: each MoE layer's expert counts, all-
    gathered (``collectives.counts_before``) where a dispatch group holds
    tokens of two ranks (``models/moe.py::Span``), the (groups, E) f32
    counts of the whole batch.  Where it puts a decode cache's slots there
    (a batch that does not divide: long_500k at batch 1, say): each
    attention's merge
    (``collectives.merge_softmax``), one all-gather of the rank's
    (B, H_rank, D + 2) f32 partials (after the model axis's merge where
    the slots are cut there too).  None on a data axis of 1."""
    from repro_torch.launch.steps import cache_max_seq, resolve_cfg
    from repro_torch.models import moe as MOE
    from repro_torch.models.hybrid import segments
    from repro_torch.models.layers import head_plan
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.collectives import ModelAxis

    cfg = resolve_cfg(cfg, shape)
    sizes = {"data": data, "model": model}
    if data == 1 or cfg.family not in ("dense", "moe", "vlm", "ssm",
                                       "hybrid", "audio"):
        return []
    b = shape.global_batch
    decode = shape.kind == "decode"
    seq = cache_max_seq(cfg, shape) if decode else shape.seq_len
    split = R.serve_split(b, seq or None, sizes)
    ev = []
    if split == "batch" and cfg.is_moe:
        sp = MOE.Span.of(b * (1 if decode else shape.seq_len) // data,
                         ModelAxis(None, 0, data))
        if sp.spans:
            _add(ev, "all-gather", data * sp.groups * cfg.num_experts * 4,
                 cfg.num_layers)
    if decode and split == "seq":
        plan = head_plan(cfg, ModelAxis(None, 0, model))
        heads = cfg.num_heads // model if plan.split else cfg.num_heads
        n = (len(segments(cfg)) - 1 if cfg.family == "hybrid"
             else cfg.num_layers)
        _add(ev, "all-gather",
             data * b * heads * (cfg.resolved_head_dim + 2) * 4, n)
    return ev


def dp_collectives(cfg, m: int, tokens: int, clients: int) -> list:
    """The collectives over ``model`` of a ``dp_client`` training client's
    loss whose batch is split over the axis (``core/afl.py::
    device_grads``' ``batch_axis``; ``tokens`` the rank's tokens of a
    client, ``clients`` the rank's clients, all of them one collective
    under ``vmap``): (kind, result bytes, count) each.  Each MoE layer
    adds its load-balance loss's sums over the ranks
    (``collectives.all_sum`` of (clients, 2E) f32: an all-reduce forward
    and one backward) and, where a dispatch group spans ranks
    (``moe.Span``), all-gathers the (groups, E) f32 expert counts
    (``collectives.counts_before``); a checkpointed layer
    (``cfg.remat``) runs its forward's again in the backward.  Each
    ResNet-9 batch-norm layer adds its two sums (``resnet._conv_bn``:
    the mean's and the variance's, (clients, C) f32), each an all-reduce
    forward and one backward.  Other families' losses are means over
    their samples: none."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.resnet import WIDTHS
    from repro_torch.sharding.collectives import ModelAxis

    ev = []
    if cfg.is_moe:
        n = cfg.num_layers
        fwd = 1 + int(cfg.remat != "none")
        _add(ev, "all-reduce", clients * 2 * cfg.num_experts * 4,
             n * (fwd + 1))
        sp = MOE.Span.of(tokens, ModelAxis(None, 0, m))
        if sp.spans:
            _add(ev, "all-gather",
                 clients * m * sp.groups * cfg.num_experts * 4, n * fwd)
    elif cfg.family == "vision":
        for w in WIDTHS.values():
            _add(ev, "all-reduce", clients * w * cfg.d_model * 4, 4)
    return ev


def step_collectives(kind: str, num_params: int, world: int,
                     num_clients: int = 0,
                     upload_dtype: str = "float32", *, model: int = 1,
                     cfg=None, tokens: int = 0, sample: int = 65536,
                     params_per_card: int = 0,
                     batch: int = 0, seqs: int = 0,
                     codec=None, leaves: int = 0,
                     shape=None, dp_rows: int = 0) -> CollectiveStats:
    """The collectives one rank of the port's step issues, on a (world /
    model, model) mesh.

    Train, over ``data`` (``core/distributed.py::make_afl_train_step``):
    the MES aggregation's ``all_reduce`` of the rank's (s_r,) sum in
    ``upload_dtype``, one per column block of ``CHUNK``, and one
    ``all_gather`` of the round's (len(METRIC_KEYS), N/D) f32 metrics.

    Over ``model`` (``model`` > 1; ``tokens`` the rank's tokens a step,
    ``batch`` a serve step's sequences, ``seqs`` the rank's sequences, all
    three as ``axis_collectives`` reads them): the model's
    (``axis_collectives``) and, in training, the round's norm and count
    all-reduces and its threshold sample's all-gather; with ``codec`` (a
    ``compression`` codec on the rank's blocks of a model of ``leaves``
    leaves) the two norms' and the codec's own
    (``Compressor.model_collectives``).  ``dp_rows``: a ``dp_client``
    round (the parameters whole on every rank, ``params_per_card`` the
    whole model's), a client's rows: where they divide ``model`` the
    round splits them over it, and adds the gradient's all-reduce over
    ``model`` in f32, one per column block of ``CHUNK``, and the loss's
    (``dp_collectives``, ``tokens`` the rank's of a client) in place of
    the tensor-parallel model's; the round's norms, count and sample are
    as above, and a codec runs on whole rows with none of its own.  A
    serve step's ``shape`` (an
    ``InputShape``) over a data axis above 1 adds ``data_collectives``
    (``tokens`` and ``batch`` then the rank's).  A world of 1 issues
    none."""
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
        n = max((num_clients or data) // data, 1)
        if dp_rows and dp_rows % model == 0:
            c = math.ceil(s_r / CHUNK)
            add("all-reduce", ring_bytes("all-reduce", n * s_r * 4, model) / c,
                c)
            for k, b, c in dp_collectives(cfg, model, tokens, n):
                add(k, ring_bytes(k, b, model), c)
        elif not dp_rows:
            for k, b, c in axis_collectives(kind, cfg, model, tokens, n,
                                            batch, seqs):
                add(k, ring_bytes(k, b, model), c)
        if kind == "train" and codec is None:
            add("all-reduce", ring_bytes("all-reduce", n * 8, model), 3)
            add("all-gather", ring_bytes("all-gather", n * sample * 4,
                                         model))
        elif kind == "train":
            add("all-reduce", ring_bytes("all-reduce", n * 4, model), 2)
            for k, b in ([] if dp_rows else codec.model_collectives(n,
                                                                    leaves)):
                add(k, ring_bytes(k, b, model))
    if kind != "train" and shape is not None and cfg is not None:
        for k, b, c in data_collectives(cfg, shape, data, model):
            add(k, ring_bytes(k, b, data), c)
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

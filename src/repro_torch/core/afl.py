"""Algorithm 1 — the AFL training process (simulation mode).

``afl_round`` advances the whole federation by one round: all N devices
compute stochastic gradients (one vmapped call), the contacted subset
uploads sparsified cumulative gradients with error feedback, the MES
aggregates, and staleness / virtual-energy-queue bookkeeping advances.
The upload policy (who sends what, at which k and p) is pluggable — MADS
and every §VI-B baseline are policies over the same engine.

Per-device state lives in flat (N, s) buffers (leaves in flatten order,
``model.layout`` maps them), so the sparsify + error-feedback pass is one
fused kernel launch per round over the whole federation.

Seed batching (``experiments/batch.py``) folds G independent federations
into the rows: the per-device buffers are (G N, s), the global models
(G, s); the gradients and the aggregation work group by group, everything
else (thresholds, the kernel launch, the codecs) over all G N rows.  A
single federation is the case G = 1.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compression import quant as Q
from repro_torch.compression.base import Compressor
from repro_torch.core import mads as M
from repro_torch.core import sparsify as SP
from repro_torch.core.mads import MadsController
from repro_torch.utils.fmath import div


@dataclasses.dataclass
class AflState:
    w: torch.Tensor  # (s,) global model, flat; (G, s) for G seed groups
    w_n: torch.Tensor  # (N, s) per-device models ((G N, s) under groups)
    g_n: torch.Tensor  # (N, s) cumulative gradients (eta-scaled)
    e_n: torch.Tensor  # (N, s) error memory
    kappa: torch.Tensor  # (N,) int32 last global-model reception round
    q: torch.Tensor  # (N,) virtual energy queues
    energy: torch.Tensor  # (N,) cumulative energy spent
    # round index r: an int, or (the whole-run engine, whose captured
    # round advances it on the card) a 0-dim int32 tensor
    rnd: int | torch.Tensor
    gen: torch.Generator  # draws the stochastic codecs' dither seeds


@dataclasses.dataclass(frozen=True)
class StalenessWeight:
    """The FedAsync ``alpha * s(delta_tau)`` staleness-discount family.

    * ``constant``: ``s = 1``            (the paper's rule at ``alpha``)
    * ``hinge``:    ``s = 1`` while ``delta_tau <= hinge_b``, then
                    ``1 / (hinge_a * (delta_tau - hinge_b))``
    * ``poly``:     ``s = (delta_tau + 1) ** -poly_a``

    The default (constant at alpha = 1) is the identity and skips the
    multiply.
    """

    family: str = "constant"  # constant | hinge | poly
    alpha: float = 1.0
    hinge_a: float = 10.0
    hinge_b: float = 4.0
    poly_a: float = 0.5

    FAMILIES = ("constant", "hinge", "poly")

    @property
    def is_identity(self) -> bool:
        return self.family == "constant" and self.alpha == 1.0

    def s(self, delta_tau):
        dt = torch.as_tensor(delta_tau, dtype=torch.float32)
        if self.family == "constant":
            return torch.ones_like(dt)
        if self.family == "hinge":
            return torch.where(
                dt <= self.hinge_b, 1.0,
                div(1.0, self.hinge_a * torch.clamp(dt - self.hinge_b, min=1e-9)))
        if self.family == "poly":
            return (dt + 1.0) ** (-self.poly_a)
        raise ValueError(
            f"unknown staleness family {self.family!r}; "
            f"known: {self.FAMILIES}")

    def weight(self, delta_tau):
        """``alpha * s(delta_tau)`` — the aggregation mixing weight."""
        return self.alpha * self.s(delta_tau)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Engine flags + (k, p) selection strategy."""

    name: str = "mads"
    controller: MadsController | None = None
    sparsify: bool = True  # False -> all-or-nothing full upload
    error_feedback: bool = True
    local_updates: bool = True  # SGD during inter-contact (False: SFL)
    train_every_round: bool = True  # False: gradient only at contact (SFL)
    energy_capped: bool = False  # hard stop when budget exhausted (AFL/AFL-Spar)
    fixed_power: float = 0.0  # >0: transmit at this power (non-MADS baselines)
    # None -> top-k at ctl.u-bit values; a compression codec replaces the
    # sparsify/quantize stage and spends tau*A(p) bits itself
    compressor: Compressor | None = None
    # the alpha * s(delta_tau) mixing weight, shared by the engines and the
    # streaming ingest server (serve/aggregate.py)
    staleness: StalenessWeight = StalenessWeight()
    # True -> afl_round also returns the round's dense (N, s) uploads under
    # metrics["upload"] and their quantisation steps under
    # metrics["upload_step"], for the serve parity checks (the wire format
    # and the fused ingest take the same uploads); the engines leave it off
    expose_uploads: bool = False

    def select(self, ctl: MadsController, zeta, theta, x_norm2, q, tau, h2):
        if self.controller is not None and self.fixed_power <= 0:
            return self.controller.select(zeta, theta, x_norm2, q, tau, h2)
        # fixed-power policies: k fills the contact window at power p_fix
        p = torch.full_like(tau, self.fixed_power) * zeta
        k = M.mads_k(p, tau, h2, ctl.s, ctl.u, ctl.bandwidth, ctl.noise_w_hz) * zeta
        if not self.sparsify:
            # full upload or nothing: feasible iff s fits in tau * A
            feasible = k >= ctl.s
            k = torch.where(feasible, float(ctl.s), 0.0)
            bits = SP.bits_for_k(k, ctl.s, ctl.u)
            a = M.rate_bps(p, h2, ctl.bandwidth, ctl.noise_w_hz)
            energy = torch.where(
                feasible, div(p * bits, torch.clamp(a, min=1e-9)), 0.0)
            return k, p * feasible, energy
        energy = p * tau
        return k, p, energy


def compress_uploads(comp: Compressor, g_n, e_n, budget_bits, seeds, layout,
                     placement=None):
    """One codec pass over the federation: (upload, e_after, cstats).

    ``seeds`` are the (N,) int32 dither seeds (``afl_round`` draws them
    from the state's generator; tests pass the reference's).
    ``placement``: g_n and e_n are a model-axis rank's blocks
    (``core/distributed.py::Placement``; ``compression/base.py``).
    """
    return comp.compress(g_n, budget_bits, e_n, seeds, layout, placement)


def afl_init(model, fl, seed: int, device="cpu", params=None) -> AflState:
    """Round-0 state; ``params`` (a tree of tensors) overrides the seeded
    initialisation (tests pass the reference's weights)."""
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed), device)
    w = model.layout.flatten(params).to(device)
    n, s = fl.num_devices, w.numel()
    return AflState(
        w=w,
        w_n=w.expand(n, s).clone(),
        g_n=torch.zeros(n, s, dtype=w.dtype, device=device),
        e_n=torch.zeros(n, s, dtype=w.dtype, device=device),
        kappa=torch.zeros(n, dtype=torch.int32, device=device),
        q=torch.zeros(n, dtype=torch.float32, device=device),
        energy=torch.zeros(n, dtype=torch.float32, device=device),
        rnd=0,
        gen=torch.Generator().manual_seed(seed + 0x5EED),
    )


def device_grads(model, w_n, batch, *, layout=None, model_axis=None,
                 batch_axis=None):
    """Per-device gradients (N, s) of the loss at the stacked models w_n.

    ``layout``: w_n's (a rank's blocks, ``Model.block_layout``; the
    model's by default); ``model_axis``: the tensor-parallel axis the loss
    runs over (``sharding/collectives.py``); ``batch_axis``: the axis each
    client's batch is split over, ``batch`` this rank's rows of it (the
    parameters whole): the loss's batch-wide quantities are the whole
    batch's, and the gradient is this rank's part of the whole batch's,
    which the caller sums over the axis (``core/distributed.py``)."""
    layout = layout or model.layout
    kw = {} if model_axis is None else {"model_axis": model_axis}
    if batch_axis is not None:
        kw["batch_axis"] = batch_axis

    def loss(p, b):
        return model.loss_fn(p, model.cfg, b, **kw)

    grads = torch.func.vmap(torch.func.grad(loss))(layout.unflatten(w_n), batch)
    return layout.flatten(grads, lead=1)


def sq_norms(x, layout):
    """Per-row squared L2 norm, summed leaf by leaf in flatten order."""
    return sum(l.to(torch.float32).square().sum(dim=tuple(range(1, l.dim())))
               for l in layout.leaves(x))


def _cat_groups(parts: list) -> torch.Tensor:
    """The per-group results of a round as one tensor along dim 0: the
    one part itself (no copy) for a single federation."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def afl_round(state: AflState, batch, zeta, tau, h2, energy_budget,
              *, model, fl, policy: Policy,
              seeds=None) -> tuple[AflState, dict]:
    """One round r of Algorithm 1.

    batch: stacked per-device minibatches (leading N); zeta (N,) 0/1;
    tau (N,) contact durations; h2 (N,) channel gains; energy_budget (N,)
    E_n^con — all tensors on the state's device.  ``seeds``: the codecs'
    (N,) int32 dither seeds (by default drawn from ``state.gen``; the
    whole-run engine draws a run's seeds before it starts).

    A state whose global model is (G, s) holds G federations of N =
    ``fl.num_devices`` devices each, in consecutive row blocks: every
    per-device input then has G N rows, and each group aggregates into
    its own global model.
    """
    n = fl.num_devices
    groups = state.w.numel() // state.w_n.shape[-1]
    eta = fl.learning_rate
    layout = model.layout
    ctl = policy.controller or MadsController(s=model.num_params())
    r = state.rnd + 1
    theta = (r - state.kappa).to(torch.float32)

    # --- local stochastic gradients (vmapped over each group's devices) -----
    # group by group, in the single federation's shapes: a seed's gradients
    # then round as in its own run (a batched matmul or convolution over
    # G N rows may pick other kernels)
    grads = _cat_groups([device_grads(
        model, state.w_n[g * n:(g + 1) * n],
        {k: v[g * n:(g + 1) * n] for k, v in batch.items()})
        for g in range(groups)])
    if not policy.train_every_round:
        grads = grads * zeta[:, None].to(grads.dtype)
    g_new = state.g_n + eta * grads

    # --- upload decision (MADS or baseline policy) --------------------------
    x = state.e_n + g_new
    x_norm2 = sq_norms(x, layout)
    zf = zeta.to(torch.float32)
    k, p, energy = policy.select(ctl, zf, theta, x_norm2, state.q, tau, h2)
    ok = zf > 0
    if policy.energy_capped:
        ok = ok & (state.energy + energy <= energy_budget)
    k = k * ok
    energy = energy * ok
    okf = ok.to(torch.float32)

    # --- compression with error feedback -----------------------------------
    if policy.compressor is not None:
        # codec path: the budget is the realised contact capacity tau*A(p)
        rate = M.rate_bps(p, h2, ctl.bandwidth, ctl.noise_w_hz)
        budget_bits = tau * rate * okf
        if seeds is None:
            if groups > 1:
                raise ValueError("seed groups take their dither seeds "
                                 "(seeds=), one generator cannot give them")
            seeds = Q.draw_seeds(state.gen, n, x.device)
        upload, e_after, cstats = compress_uploads(
            policy.compressor, g_new, state.e_n, budget_bits, seeds, layout)
        k_actual = cstats["k"]
        bits = cstats["bits"] * okf
        b_used = cstats["b"] * okf
    else:
        # top-k at fixed ctl.u-bit values (paper §III-D): one fused
        # sparsify_ef launch for the whole federation
        upload, e_after, k_actual = SP.sparsify_tree(
            x, layout, k, method=fl.sparsifier, sample=fl.sample_size)
        if ctl.u < 32:  # quantized wire format: EF absorbs the residual too
            upload_q = SP.quantize_values(upload, layout, ctl.u)
            e_after = e_after + (upload - upload_q)
            upload = upload_q
        bits = SP.bits_for_k(k_actual, ctl.s, ctl.u) * okf
        b_used = torch.full_like(k_actual, float(ctl.u)) * okf
    if not policy.error_feedback:
        e_after = torch.zeros_like(e_after)

    # --- MES aggregation: w <- w - (1/N) sum a s(theta) zeta S(x_n) ---------
    mix = okf if policy.staleness.is_identity \
        else okf * policy.staleness.weight(theta)
    up32 = upload.to(torch.float32)
    # one product per group, each the single federation's: (G, s)
    agg = _cat_groups([(mix[g * n:(g + 1) * n] @ up32[g * n:(g + 1) * n])[None]
                       for g in range(groups)])
    w = state.w.view(groups, -1)
    w_new = w - div(agg, float(n)).to(w.dtype)

    # --- device-side state transitions --------------------------------------
    w_local = state.w_n - eta * grads if policy.local_updates else state.w_n
    okc = ok[:, None]
    w_n_new = torch.where(okc.view(groups, n, 1), w_new[:, None, :],
                          w_local.view(groups, n, -1)).view_as(w_local)
    e_n_new = torch.where(okc, e_after, state.e_n)
    g_n_new = torch.where(okc, torch.zeros((), dtype=g_new.dtype,
                                           device=g_new.device), g_new)
    kappa_new = torch.where(ok, r, state.kappa)
    q_new = ctl.queue_update(state.q, energy, energy_budget, fl.rounds)

    metrics = {
        "k": k_actual * okf,
        "k_target": k,
        "success": (k_actual > 0).to(torch.float32) * okf,
        "power": p * okf,
        "energy": energy,
        "theta": theta,
        "uploads": okf,
        "x_norm2": x_norm2,
        "e_norm2": sq_norms(e_n_new, layout),
        "queue": q_new,
        "bits": bits,  # realised upload payload (<= tau*A budget; eq. 7c)
        "b": b_used,  # value bit-width on the wire (u, or the codec's b*)
    }
    if policy.expose_uploads:
        # the payloads the MES just applied, and the step a wire encoder
        # needs to turn them back into grid codes (1.0 = raw floats)
        metrics["upload"] = upload
        metrics["upload_step"] = (
            cstats["step"] if policy.compressor is not None
            else torch.ones_like(okf))
    new_state = AflState(
        w=w_new.view_as(state.w), w_n=w_n_new, g_n=g_n_new, e_n=e_n_new, kappa=kappa_new,
        q=q_new, energy=state.energy + energy, rnd=r, gen=state.gen,
    )
    return new_state, metrics

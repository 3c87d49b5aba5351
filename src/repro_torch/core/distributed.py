"""The distributed AFL round over a client mesh (the port of
``src/repro/core/distributed.py``).

The reference's step is one pjit program whose client-stacked state is
sharded over the mesh's ``data`` axis.  Here each rank of a
``launch.mesh.ClientMesh`` (a ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU) holds its own N/P clients' rows:

* the client buffers ``w_n``, ``g_n``, ``e_n`` are flat (N/P, s) in
  ``DistConfig.state_dtype``, leaves in flatten order (``model.layout``),
  and ``kappa``, ``q``, ``energy`` are the rank's (N/P,) rows; the global
  model ``w`` is (s,) in the model's param dtype, the same on every rank;
* a round takes the GLOBAL batch and (N,) contact inputs, as the
  reference's step, and uses the rank's rows of them;
* thresholds are per client row, so the upload stage needs nothing from
  other ranks; the MES aggregation is the rank's ``mix @ upload`` in
  ``upload_dtype`` plus one ``all_reduce(SUM)``, then ``/ N`` and the cast,
  so every rank ends the round holding the same ``w``;
* the round's (N/P,) metrics are gathered into the reference's (N,) dict
  (one ``all_gather``), so telemetry records the same state on every rank.

Without a mesh the step is the single-host round, with no collective.
The fixed-u upload is ``core/sparsify.py::sparsify_tree`` at the sampled
threshold (the ``sparsify_ef`` kernel on the card), a codec goes through
``core/afl.py::compress_uploads`` (``sparsify_quantize_ef``), and the
gradients are ``core/afl.py::device_grads`` (one vmapped call over the
rank's clients), so at f32 the step equals ``afl_round`` bit for bit.

Memory at a model's full width: each pass over (N/P, s) that computes in
``accum_dtype`` or ``upload_dtype`` runs ``CHUNK`` columns at a time, so
no f32 copy of a bf16 client buffer is made.  ``donate=True`` writes the
new state into the old state's buffers (the port's counterpart of
``jax.jit(step, donate_argnums=0)``): the caller must not read the old
state after the call.

``abstract_state`` gives meta tensors (shapes and dtypes, no memory).  A
``model`` axis (tensor-parallel parameters, the reference's
``state_shardings``) is not ported: ``make_client_mesh(model=)`` raises.
``ingest_shardings`` is the serve path's split of a packed upload batch
over a mesh (``serve/server.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.compression import quant as Q
from repro_torch.compression.base import Compressor
from repro_torch.core import mads as M
from repro_torch.core import sparsify as SP
from repro_torch.core.afl import compress_uploads, device_grads, sq_norms
from repro_torch.core.mads import MadsController
from repro_torch.launch.mesh import ClientMesh, mesh_num_clients
from repro_torch.sharding.rules import torch_dtype
from repro_torch.utils.device import resolve_device
from repro_torch.utils.fmath import div

CHUNK = 1 << 26  # columns a pass computes in f32 at a time (512 MB at N = 2)
METRIC_KEYS = ("k", "success", "power", "energy", "theta", "uploads",
               "x_norm2", "e_norm2", "bits", "b")


@dataclasses.dataclass
class DistAflState:
    w: torch.Tensor  # (s,) global model, flat, the model's param dtype
    w_n: torch.Tensor  # (N/P, s) client models, state_dtype
    g_n: torch.Tensor  # (N/P, s) cumulative gradients (eta-scaled)
    e_n: torch.Tensor  # (N/P, s) error memory
    kappa: torch.Tensor  # (N/P,) int32
    q: torch.Tensor  # (N/P,) f32
    energy: torch.Tensor  # (N/P,) f32
    rnd: int
    # the reference's ``ckey``: draws the codecs' (N,) dither seeds, seeded
    # seed + 0x5EED as afl_init's, so both engines draw the same seeds
    gen: torch.Generator


@dataclasses.dataclass(frozen=True)
class DistConfig:
    num_clients: int
    learning_rate: float = 0.01
    rounds: int = 1000
    sample_size: int = 65536
    value_bits: int = 32
    state_dtype: str = "bfloat16"  # dtype of w_n/g_n/e_n client states
    upload_dtype: str = "float32"  # accumulation dtype of the MES reduce
    accum_dtype: str = "float32"  # local g_n/w_n update arithmetic


def _rows(dcfg: DistConfig, mesh: ClientMesh | None) -> slice:
    return (slice(0, dcfg.num_clients) if mesh is None
            else mesh.rows(dcfg.num_clients))


def _device(mesh: ClientMesh | None, device) -> torch.device:
    """The mesh's device, else ``device`` (the card by default)."""
    if mesh is not None:
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        return mesh.device
    return resolve_device("cuda" if device is None else device)


def _columns(s: int) -> list:
    return [slice(c, min(c + CHUNK, s)) for c in range(0, s, CHUNK)]


def client_state_shardings(state: DistAflState,
                           mesh: ClientMesh) -> DistAflState:
    """Each field's part on this rank: ``None`` for a field every rank
    holds whole (``w``, ``rnd``, ``gen``), the rank's ``slice`` of the
    client axis for the client-stacked ones (the reference's P("data"))."""
    cl = mesh.rows(state.w_n.shape[0] * mesh.world_size)
    return DistAflState(w=None, w_n=cl, g_n=cl, e_n=cl, kappa=cl, q=cl,
                        energy=cl, rnd=None, gen=None)


def scenario_shardings(mesh: ClientMesh, num_clients: int) -> dict:
    """The rank's part of the device-resident scenario arrays: the
    (rounds, N) schedule's columns and an (N,) state's rows."""
    cl = mesh.rows(num_clients)
    return {"schedule": (slice(None), cl), "state": cl}


def telemetry_shardings(telemetry, mesh: ClientMesh, num_clients: int):
    """The rank's part of a telemetry state, as the reference splits it:
    ``None`` (replicated) for registry counters, histograms and probes,
    the rank's row ``slice`` for a ``TelemetrySuite``'s per-device table.
    Every rank records the gathered (N,) metrics, so each holds the whole
    table; these slices are the rows it computed."""
    from repro_torch.telemetry import TelemetrySuite

    if telemetry is None:
        return None
    state = telemetry.init_state("meta")
    rep = lambda tree: {k: (rep(v) if isinstance(v, dict) else None)  # noqa: E731
                        for k, v in tree.items()}
    out = rep(state)
    if isinstance(telemetry, TelemetrySuite) and telemetry.device is not None:
        cl = mesh.rows(num_clients)
        out["device"] = {f: (cl if v.dim() else None)
                         for f, v in state["device"].items()}
    return out


def abstract_state(model, dcfg: DistConfig,
                   mesh: ClientMesh | None = None) -> DistAflState:
    """The state's shapes and dtypes as meta tensors (no memory): the
    rank's rows under ``mesh``, all N without."""
    s = model.num_params()
    n = _rows(dcfg, mesh).stop - _rows(dcfg, mesh).start
    sdt = torch_dtype(dcfg.state_dtype)
    meta = dict(device="meta")
    cl = lambda: torch.empty(n, s, dtype=sdt, **meta)  # noqa: E731
    return DistAflState(
        w=torch.empty(s, dtype=torch_dtype(model.cfg.param_dtype), **meta),
        w_n=cl(), g_n=cl(), e_n=cl(),
        kappa=torch.empty(n, dtype=torch.int32, **meta),
        q=torch.empty(n, dtype=torch.float32, **meta),
        energy=torch.empty(n, dtype=torch.float32, **meta),
        rnd=0, gen=torch.Generator())


def init_state(model, dcfg: DistConfig, seed: int = 0, *,
               mesh: ClientMesh | None = None, device=None,
               params=None) -> DistAflState:
    """Round-0 state of the rank's clients.  ``params`` (a tree of
    tensors) overrides the seeded initialisation (tests pass the
    reference's weights); the seeded one draws on the state's device."""
    dev = _device(mesh, device)
    rows = _rows(dcfg, mesh)
    n = rows.stop - rows.start
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    w = model.layout.flatten(params).to(dev)
    del params
    s = w.numel()
    sdt = torch_dtype(dcfg.state_dtype)
    w_n = torch.empty(n, s, dtype=sdt, device=dev)
    w_n.copy_(w[None].expand(n, s))
    return DistAflState(
        w=w, w_n=w_n,
        g_n=torch.zeros(n, s, dtype=sdt, device=dev),
        e_n=torch.zeros(n, s, dtype=sdt, device=dev),
        kappa=torch.zeros(n, dtype=torch.int32, device=dev),
        q=torch.zeros(n, dtype=torch.float32, device=dev),
        energy=torch.zeros(n, dtype=torch.float32, device=dev),
        rnd=0,
        gen=torch.Generator().manual_seed(seed + 0x5EED),
    )


def _split_clients(batch: dict, n: int, rows: slice) -> dict:
    """(B, ...) -> the rank's (N/P, B/N, ...) on every leaf."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {k} of {x.shape[0]} rows does not split "
                             f"over {n} clients")
        out[k] = x.reshape(n, x.shape[0] // n, *x.shape[1:])[rows]
    return out


def _gather(metrics: dict, mesh: ClientMesh | None) -> dict:
    """The rank's (N/P,) metrics as the federation's (N,), in one
    ``all_gather``."""
    if mesh is None:
        return metrics
    local = torch.stack([metrics[k] for k in METRIC_KEYS])
    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    dist.all_gather(parts, local, group=mesh.group)
    full = torch.cat(parts, dim=1)
    return {k: full[i] for i, k in enumerate(METRIC_KEYS)}


def make_afl_train_step(model, cfg, dcfg: DistConfig,
                        controller: MadsController,
                        compressor: Compressor | None = None,
                        telemetry=None, staleness=None, *,
                        mesh: ClientMesh | None = None, donate: bool = False):
    """The distributed AFL round: ``step(state, batch, zeta, tau, h2,
    budgets[, tstate], seeds=None)``.

    ``batch`` is the global batch (B, ...), split evenly over the N
    clients; zeta, tau, h2 and budgets are (N,) on the state's device.
    ``compressor``: a codec spending ``tau * A(p)`` with error feedback
    (through ``compress_uploads``, as ``afl_round``); None runs the fixed-u
    sampled-threshold upload.  ``seeds``: the (N,) int32 dither seeds (by
    default drawn from ``state.gen``).  ``telemetry``: a registry or suite;
    the step then takes and returns its state.  ``staleness``: the
    ``alpha * s(delta_tau)`` mixing weight.  ``mesh``: the client mesh
    (None: one process, no collective).  ``donate``: write the new state
    into the old one's buffers.
    """
    if cfg is not None and cfg != model.cfg:
        model = dataclasses.replace(model, cfg=cfg)
    n = dcfg.num_clients
    rows = _rows(dcfg, mesh)
    eta = dcfg.learning_rate
    sw = None if (staleness is None or staleness.is_identity) else staleness
    at = torch_dtype(dcfg.accum_dtype)
    sdt = torch_dtype(dcfg.state_dtype)
    udt = torch_dtype(dcfg.upload_dtype)
    layout = model.layout

    def step(state: DistAflState, batch, zeta, tau, h2, budgets,
             tstate=None, *, seeds=None):
        r = state.rnd + 1
        theta = (r - state.kappa).to(torch.float32)
        grads = device_grads(model, state.w_n,
                             _split_clients(batch, n, rows))
        s = grads.shape[1]
        cols = _columns(s)

        g_new = state.g_n if donate else torch.empty_like(state.g_n)
        for c in cols:
            g_new[:, c] = (state.g_n[:, c].to(at)
                           + eta * grads[:, c].to(at)).to(sdt)
        x = state.e_n + g_new
        x_norm2 = sq_norms(x, layout)

        zf = zeta[rows].to(torch.float32)
        tau_l, h2_l = tau[rows], h2[rows]
        k, p, energy = controller.select(zf, theta, x_norm2, state.q, tau_l,
                                         h2_l)
        ok = zf > 0
        okf = ok.to(torch.float32)
        k = k * okf
        energy = energy * okf

        if compressor is not None:
            del x
            rate = M.rate_bps(p, h2_l, controller.bandwidth,
                              controller.noise_w_hz)
            budget_bits = tau_l * rate * okf
            if seeds is None:
                seeds = Q.draw_seeds(state.gen, n, g_new.device)
            upload, e_after, cstats = compress_uploads(
                compressor, g_new, state.e_n, budget_bits, seeds[rows],
                layout)
            k_actual = cstats["k"]
            bits = cstats["bits"] * okf
            b_used = cstats["b"] * okf
        else:
            upload, e_after, k_actual = SP.sparsify_tree(
                x, layout, k, method="sampled", sample=dcfg.sample_size)
            del x
            bits = SP.bits_for_k(k_actual, controller.s, controller.u) * okf
            b_used = torch.full_like(k_actual, float(controller.u)) * okf

        # MES aggregation: the rank's contraction of its clients, then one
        # all-reduce of the (s,) sum, column block by column block
        mix = okf if sw is None else okf * sw.weight(theta)
        mixu = mix.to(udt)
        w_new = state.w if donate else torch.empty_like(state.w)
        for c in cols:
            agg = mixu @ upload[:, c].to(udt)
            if mesh is not None:
                dist.all_reduce(agg, group=mesh.group)
            w_new[c] = (state.w[c].to(udt) - div(agg, float(n))).to(w_new.dtype)
        del upload

        okc = ok[:, None]
        w_n_new = state.w_n if donate else torch.empty_like(state.w_n)
        for c in cols:
            local = (state.w_n[:, c].to(at) - eta * grads[:, c].to(at)).to(sdt)
            w_n_new[:, c] = torch.where(okc, w_new[c].to(sdt)[None], local)
        del grads
        e_n_new = torch.where(okc, e_after, state.e_n,
                              out=state.e_n if donate else None)
        del e_after
        g_new.masked_fill_(okc, 0.0)
        kappa_new = torch.where(ok, r, state.kappa)
        q_new = controller.queue_update(state.q, energy, budgets[rows],
                                        dcfg.rounds)

        metrics = _gather({
            "k": k_actual * okf,
            "success": (k_actual > 0).to(torch.float32) * okf,
            "power": p * okf,
            "energy": energy,
            "theta": theta,
            "uploads": okf,
            "x_norm2": x_norm2,
            "e_norm2": sq_norms(e_n_new, layout),
            "bits": bits,  # realised payload (<= tau*A budget; eq. 7c)
            "b": b_used,  # value bit-width on the wire (u, or the codec's b*)
        }, mesh)
        metrics["upload_bits"] = metrics["bits"]  # the reference's alias
        new_state = DistAflState(
            w=w_new, w_n=w_n_new, g_n=g_new, e_n=e_n_new, kappa=kappa_new,
            q=q_new, energy=state.energy + energy, rnd=r, gen=state.gen)
        if telemetry is not None:
            from repro_torch.telemetry import record_round

            return new_state, metrics, record_round(telemetry, tstate,
                                                    metrics, tau)
        return new_state, metrics

    return step


def run_afl_rounds(step, state: DistAflState, provider, batch_fn, budgets,
                   rounds: int | None = None, telemetry=None, tstate=None):
    """Drive a distributed step from a ``ScenarioProvider`` (anything
    yielding per-round (zeta, tau, h2)); ``batch_fn(r)`` gives round r's
    global batch.  Budgets go to the device once.  Returns (state,
    history[, tstate]); with ``telemetry`` each round's heterogeneity
    losses (``provider.aux_round``) are folded in too."""
    from repro_torch.telemetry import record_het

    dev = state.w.device
    budgets = torch.as_tensor(budgets, dtype=torch.float32).to(dev)
    if telemetry is not None and tstate is None:
        tstate = telemetry.init_state(dev)
    aux_round = getattr(provider, "aux_round", lambda r: None)

    def on(v):
        return torch.as_tensor(v).to(device=dev, dtype=torch.float32)

    history = []
    for r, (zeta, tau, h2) in enumerate(provider):
        if rounds is not None and r >= rounds:
            break
        args = (state, batch_fn(r), on(zeta), on(tau), on(h2), budgets)
        if telemetry is not None:
            state, m, tstate = step(*args, tstate)
            aux = aux_round(r)
            tstate = record_het(telemetry, tstate, None if aux is None else
                                {k: on(v) for k, v in aux.items()})
        else:
            state, m = step(*args)
        history.append(m)
    if telemetry is not None:
        return state, history, tstate
    return state, history


@dataclasses.dataclass(frozen=True)
class IngestSharding:
    """How the fused ingest splits over a mesh (the reference's
    ``ingest_shardings``: the packed batch's leading axis over ``data``,
    the global model replicated): rank r packs, decodes and scatters rows
    [r B/P, (r + 1) B/P) of each batch into its partial weighted sum, and
    one ``all_reduce(SUM)`` over ``group`` adds the partial sums before
    the staleness-weighted update, which every rank applies to its own
    copy of ``w``."""

    group: object
    rank: int
    world_size: int

    def rows(self, batch: int) -> slice:
        """The rank's rows of a batch of ``batch`` uploads."""
        if batch % self.world_size:
            raise ValueError(f"batch={batch} not divisible by mesh size "
                             f"{self.world_size}")
        per = batch // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


def ingest_shardings(mesh: ClientMesh) -> IngestSharding:
    """The serve path's fused ingest split over ``mesh``."""
    return IngestSharding(mesh.group, mesh.rank, mesh.world_size)


def make_afl_train_system(model, cfg, mesh: ClientMesh | None = None,
                          dcfg: DistConfig | None = None,
                          controller: MadsController | None = None,
                          compressor: Compressor | None = None,
                          telemetry=None, staleness=None, *,
                          donate: bool = False) -> dict:
    """The step and the state's layout over the mesh, the reference's
    bundle: ``step``, ``dcfg``, ``controller``, ``compressor``,
    ``telemetry``, the rank's ``state_shardings`` / ``scalar_sharding`` /
    ``telemetry_sharding``, and ``abstract_state()`` / ``init_state(seed,
    params=None)``.  Without a mesh, N defaults to one client."""
    dcfg = dcfg or DistConfig(
        num_clients=1 if mesh is None else mesh_num_clients(mesh))
    controller = controller or MadsController(s=model.num_params())
    step = make_afl_train_step(model, cfg, dcfg, controller,
                               compressor=compressor, telemetry=telemetry,
                               staleness=staleness, mesh=mesh, donate=donate)
    rows = _rows(dcfg, mesh)
    return {
        "step": step,
        "dcfg": dcfg,
        "controller": controller,
        "compressor": compressor,
        "telemetry": telemetry,
        "state_shardings": DistAflState(
            w=None, w_n=rows, g_n=rows, e_n=rows, kappa=rows, q=rows,
            energy=rows, rnd=None, gen=None),
        "scalar_sharding": None,
        "telemetry_sharding": (None if mesh is None else telemetry_shardings(
            telemetry, mesh, dcfg.num_clients)),
        "abstract_state": lambda: abstract_state(model, dcfg, mesh),
        "init_state": lambda seed=0, params=None: init_state(
            model, dcfg, seed, mesh=mesh, params=params),
    }

"""The distributed AFL round over a client mesh (the port of
``src/repro/core/distributed.py``).

The reference's step is one pjit program whose client-stacked state is
sharded over the mesh's ``data`` axis.  Here each rank of a
``launch.mesh.ClientMesh`` (a ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU) holds its own N/D clients' rows (D the size of
the mesh's data axis):

* the client buffers ``w_n``, ``g_n``, ``e_n`` are flat (N/D, s) in
  ``DistConfig.state_dtype``, leaves in flatten order (``model.layout``),
  and ``kappa``, ``q``, ``energy`` are the rank's (N/D,) rows; the global
  model ``w`` is (s,) in the model's param dtype, the same on every rank
  of a data group (over a model axis, s is the rank's blocks', below);
* a round takes the GLOBAL batch and (N,) contact inputs, as the
  reference's step, and uses the rank's rows of them;
* thresholds are per client row, so the upload stage needs nothing from
  other ranks; the MES aggregation is the rank's ``mix @ upload`` in
  ``upload_dtype`` plus one ``all_reduce(SUM)``, then ``/ N`` and the cast,
  so every rank ends the round holding the same ``w``;
* the round's (N/D,) metrics are gathered into the reference's (N,) dict
  (one ``all_gather``), so telemetry records the same state on every rank.

Without a mesh the step is the single-host round, with no collective.
The fixed-u upload is ``core/sparsify.py::sparsify_tree`` at the sampled
threshold (the ``sparsify_ef`` kernel on the card), a codec goes through
``core/afl.py::compress_uploads`` (``sparsify_quantize_ef``), and the
gradients are ``core/afl.py::device_grads`` (one vmapped call over the
rank's clients), so at f32 the step equals ``afl_round`` bit for bit.

Memory at a model's full width: each pass over (N/D, s) that computes in
``accum_dtype`` or ``upload_dtype`` runs ``CHUNK`` columns at a time, so
no f32 copy of a bf16 client buffer is made.  ``donate=True`` writes the
new state into the old state's buffers (the port's counterpart of
``jax.jit(step, donate_argnums=0)``): the caller must not read the old
state after the call.

``abstract_state`` gives meta tensors (shapes and dtypes, no memory).

The ``model`` axis (a (data, model) mesh, ``make_client_mesh(model=M)``;
every family).  ``placement`` applies the rules
(``RULES_TRAIN`` with the client axis on ``data``, the reference's
``state_shardings``) leaf by leaf: each rank's flat buffers, ``w`` (s_r,)
and ``w_n`` / ``g_n`` / ``e_n`` (N/D, s_r), concatenate its blocks in
flatten order, and the round runs on them:

* the gradient on the blocks, the loss tensor-parallel over the rank's
  ``model`` group (``models/layers.py``, ``moe.py``, ``mamba2.py``,
  ``hybrid.py``, ``encdec.py``; ResNet-9 and LaneGCN channel-parallel,
  ``resnet.py``, ``lanegcn.py``); a whole leaf that a rank's own part of
  the work reads
  (Mamba2's ``wB`` / ``wC`` / ``conv_B`` / ``conv_C``, the MoE shared
  ``gate``) enters through ``copy_to``, so its gradient is the sum over
  the ranks, the same on each, as the replicated leaves' (norms, a
  gathered router) is;
* ``x_norm2`` and ``e_norm2`` as partial sums over the leaves the rank
  owns (its blocks; a leaf every rank holds whole is owned by model index
  0), all-reduced over ``model``;
* the sampled threshold from the reference's per-leaf strided sample:
  each rank takes the sampled coordinates that fall in its blocks, the
  parts are all-gathered over ``model``, and as the threshold is read off
  the sorted sample it is bit-equal to the unsharded one given the same x;
* ``sparsify_ef`` on the rank's flat blocks, the int64 counts (less those
  of leaves it does not own) all-reduced over ``model``;
* a codec on the rank's blocks through its ``Placement``
  (``compression/base.py``): each leaf's whole strided sample (exact
  mode: the owned magnitudes) gathered over ``model``, the amax a MAX and
  the count the owned leaves' all-reduced over ``model`` before the
  budget gate, and ``sparsify_quantize_ef`` under the blocks' counter
  map, so each element draws the dither of its whole-model coordinate;
  given the same x, budget and seeds each rank's payload and error are
  world 1's on its blocks, bit for bit (the seeds are the same on every
  rank of a data index: the same ``state.gen``);
* the aggregation over ``data`` only, the metrics gathered over ``data``.

Under ``RULES_TRAIN_DP`` (``launch/steps.py``'s ``dp_client``) the
parameters stay whole, each client's batch whose rows divide the model
axis is split over ``model`` (rank m its m-th chunk of the client's
rows), and the gradient is all-reduced over ``model`` (one a column
block of ``CHUNK``) and divided by M.  The loss runs with the model axis
as its ``batch_axis``, so that what it computes over the whole batch
stays the whole batch's: an MoE's routing, capacity, slots and
load-balance loss (``models/moe.py``), ResNet-9's batch-norm statistics
(``models/resnet.py``), through ``collectives.all_sum`` (all-reduce
both ways: each rank's loss reads the sums, so their gradient reaches
every rank's rows) and ``counts_before``.  A batch whose rows do not
divide runs whole on every rank (the rules leave it unsharded), with no
gradient all-reduce.  A codec there runs on the whole rows on each rank
with no ``model`` collective.  With a model axis
of 1 the blocks are the whole leaves and the round is the one above; a
codec there runs on the whole rows, as without a mesh.
``ingest_shardings`` is the serve path's split of a packed upload batch
over a mesh (``serve/server.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from repro_torch.compression import quant as Q
from repro_torch.compression.base import Compressor
from repro_torch.core import mads as M
from repro_torch.core import sparsify as SP
from repro_torch.core.afl import compress_uploads, device_grads
from repro_torch.core.mads import MadsController
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (ClientMesh, mesh_num_clients,
                                     require_model_axis)
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import torch_dtype
from repro_torch.utils.device import resolve_device
from repro_torch.utils.fmath import div
from repro_torch.utils.tree import TreeLayout, tree_flatten, tree_unflatten

CHUNK = 1 << 26  # columns a pass computes in f32 at a time (512 MB at N = 2)
METRIC_KEYS = ("k", "success", "power", "energy", "theta", "uploads",
               "x_norm2", "e_norm2", "bits", "b")


@dataclasses.dataclass
class DistAflState:
    w: torch.Tensor  # (s,) global model, flat, the model's param dtype
    w_n: torch.Tensor  # (N/D, s) client models, state_dtype
    g_n: torch.Tensor  # (N/D, s) cumulative gradients (eta-scaled)
    e_n: torch.Tensor  # (N/D, s) error memory
    kappa: torch.Tensor  # (N/D,) int32
    q: torch.Tensor  # (N/D,) f32
    energy: torch.Tensor  # (N/D,) f32
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


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """A rank's part of the model under the rules: each leaf's per-dim
    ``blocks`` (slices of the whole leaf), their flat ``layout``, whether
    it ``owned`` each leaf's values (``placement``), its ``model_axis``,
    ``dp`` (whole parameters, each client's batch split over ``model``),
    the whole model's ``full`` layout, and ``peers``: every model index's
    (blocks, owned), in model-index order (the widths of what the ranks
    gather)."""

    blocks: tuple
    layout: TreeLayout
    owned: tuple
    model_axis: object
    dp: bool
    full: TreeLayout
    peers: tuple

    @functools.cached_property
    def counters(self) -> tuple:
        """The blocks' dither counter map (``core/sparsify.py::
        block_counters``)."""
        return SP.block_counters(self.full, self.blocks, self.owned)


def placement(model, mesh: ClientMesh | None, rules=None) -> Placement:
    """The rank's ``Placement`` under ``rules`` (``RULES_TRAIN`` with the
    client axis on (pod, data) by default).  A leaf is owned where the
    rank holds a block of it, or where every rank holds it whole and the
    rank is model index 0."""
    rules = rules or R.RULES_TRAIN_CLIENT
    sizes = {"data": 1, "model": 1} if mesh is None else mesh.axis_sizes
    if sizes["model"] > 1:
        require_model_axis(model.cfg.family, sizes["model"])
    coords = {"data": 0, "model": 0} if mesh is None else mesh.coords
    specs = tree_flatten(model.param_pspecs(rules, sizes))[1]

    def of(m):
        blocks = tree_flatten(model.blocks(rules, sizes, dict(coords,
                                                               model=m)))[1]
        owned = [m == 0 or any(e is not None for e in sp) for sp in specs]
        return blocks, owned

    peers = tuple(of(m) for m in range(sizes["model"]))
    blocks, owned = peers[coords["model"]]
    dp = sizes["model"] > 1 and any(
        cand and "model" in cand for cand in rules.get("batch", []))
    return Placement(
        blocks=tuple(blocks),
        layout=TreeLayout(model.layout.paths, tuple(
            tuple(b.stop - b.start for b in bl) for bl in blocks)),
        owned=tuple(owned),
        model_axis=None if mesh is None else mesh.model_axis(),
        dp=dp, full=model.layout, peers=peers)


def state_shardings(model, mesh, dcfg: DistConfig, rules=None) -> DistAflState:
    """The state's placement under ``rules`` (the reference's
    ``state_shardings``): ``w`` by the rules leaf by leaf, the client
    stacks with ``client`` prepended, the rest replicated (spec ())."""
    rules = rules or R.RULES_TRAIN_CLIENT
    axes = model.param_axes()
    shapes = R.shapes_tree(model.specs)
    paths, leaves = tree_flatten(shapes)
    cl_shapes = tree_unflatten(paths, [
        torch.empty((dcfg.num_clients,) + tuple(t.shape), dtype=t.dtype,
                    device="meta") for t in leaves])
    w_sh = R.sharding_tree(axes, shapes, rules, mesh)
    cl_sh = R.sharding_tree(R.prepend_axis(axes, "client"), cl_shapes, rules,
                            mesh)
    rep = R.TreeSharding((), R.axis_sizes(mesh))
    return DistAflState(w=w_sh, w_n=cl_sh, g_n=cl_sh, e_n=cl_sh, kappa=rep,
                        q=rep, energy=rep, rnd=rep, gen=rep)


def owned_sq_norms(x, pl: Placement) -> torch.Tensor:
    """Per-row squared L2 norm of the rank's owned leaves, summed leaf by
    leaf in flatten order and all-reduced over ``model`` (with one rank,
    ``core/afl.py::sq_norms``)."""
    out = sum(l.to(torch.float32).square().sum(dim=tuple(range(1, l.dim())))
              for l, own in zip(pl.layout.leaves(x), pl.owned) if own)
    if isinstance(out, int):  # no owned leaf
        out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    return C.all_reduce_(out, pl.model_axis)


def block_threshold(x, model, pl: Placement, k, sample: int) -> torch.Tensor:
    """``core/sparsify.py::tree_threshold``'s sampled threshold from the
    rank's blocks: every model index's part of the sample, gathered."""
    part = SP.gather_block_abs(x, pl, SP.leaf_samples(pl.full, sample),
                               joined=True)[0]
    return SP.threshold_from_sample(part, model.layout.size, k)


def block_sparsify(x, model, pl: Placement, k, sample: int):
    """(upload, error, k_actual) of the rank's blocks at the sampled
    threshold, through the ``sparsify_ef`` kernel; the count of the
    coordinates that pass in the whole model."""
    t = block_threshold(x, model, pl, k, sample)
    upload, error, count = ops.sparsify_ef(x, t.contiguous())
    if pl.model_axis is None:
        return upload, error, count
    count = SP.owned_count(x, t, pl.layout, pl.owned, count)
    return upload, error, C.all_reduce_(count, pl.model_axis).to(
        torch.float32)


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
    cl = mesh.rows(state.w_n.shape[0] * mesh.data_size)
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
                   mesh: ClientMesh | None = None, rules=None) -> DistAflState:
    """The state's shapes and dtypes as meta tensors (no memory): the
    rank's rows and blocks under ``mesh``, all N without."""
    s = placement(model, mesh, rules).layout.size
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
               params=None, rules=None) -> DistAflState:
    """Round-0 state of the rank's clients, on its blocks.  ``params`` (a
    tree of tensors, whole or the rank's blocks) overrides the seeded
    initialisation (tests pass the reference's weights); the seeded one
    draws on the state's device and keeps the rank's blocks only."""
    from repro_torch.models.registry import local_params

    dev = _device(mesh, device)
    rows = _rows(dcfg, mesh)
    n = rows.stop - rows.start
    pl = placement(model, mesh, rules)
    blocks = tree_unflatten(model.layout.paths, list(pl.blocks))
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed), dev,
                            blocks=blocks)
    elif TreeLayout.of(params).shapes != pl.layout.shapes:  # whole leaves
        params = local_params(model, params, blocks)
    w = pl.layout.flatten(params).to(dev)
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
    """(B, ...) -> the rank's (N/D, B/N, ...) on every leaf."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {k} of {x.shape[0]} rows does not split "
                             f"over {n} clients")
        out[k] = x.reshape(n, x.shape[0] // n, *x.shape[1:])[rows]
    return out


def _gather(metrics: dict, mesh: ClientMesh | None) -> dict:
    """The rank's (N/D,) metrics as the federation's (N,), in one
    ``all_gather`` over ``data``."""
    if mesh is None:
        return metrics
    local = torch.stack([metrics[k] for k in METRIC_KEYS])
    parts = [torch.empty_like(local) for _ in range(mesh.data_size)]
    dist.all_gather(parts, local, group=mesh.data)
    full = torch.cat(parts, dim=1)
    return {k: full[i] for i, k in enumerate(METRIC_KEYS)}


def make_afl_train_step(model, cfg, dcfg: DistConfig,
                        controller: MadsController,
                        compressor: Compressor | None = None,
                        telemetry=None, staleness=None, *,
                        mesh: ClientMesh | None = None, donate: bool = False,
                        rules=None):
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
    into the old one's buffers.  ``rules``: the parameters' placement over
    the mesh's model axis (``placement``).
    """
    if cfg is not None and cfg != model.cfg:
        model = dataclasses.replace(model, cfg=cfg)
    n = dcfg.num_clients
    rows = _rows(dcfg, mesh)
    pl = placement(model, mesh, rules)
    ma = pl.model_axis
    # the codec's view of the rank's row: its blocks over a model axis,
    # whole rows at a model axis of 1 or under dp_client (the same x on
    # every rank)
    cpl = pl if (ma is not None and not pl.dp) else None
    if cpl is not None and compressor is not None:
        _ = cpl.counters  # a layout the counter map cannot take fails here
    eta = dcfg.learning_rate
    sw = None if (staleness is None or staleness.is_identity) else staleness
    at = torch_dtype(dcfg.accum_dtype)
    sdt = torch_dtype(dcfg.state_dtype)
    udt = torch_dtype(dcfg.upload_dtype)
    layout = pl.layout

    def grads_of(w_n, batch):
        """The rank's clients' gradients on its blocks."""
        cl = _split_clients(batch, n, rows)
        if not pl.dp:
            return device_grads(model, w_n, cl, layout=layout, model_axis=ma)
        # dp_client: each client's batch split over model, the loss's
        # batch-wide quantities over the axis, the gradient all-reduced; a
        # batch that does not divide runs whole on every rank (the rules
        # leave it unsharded)
        rows_per = next(iter(cl.values())).shape[1]
        if rows_per % ma.size:
            return device_grads(model, w_n, cl, layout=layout)
        part = {k: v.chunk(ma.size, dim=1)[ma.rank] for k, v in cl.items()}
        g = device_grads(model, w_n, part, layout=layout, batch_axis=ma)
        for c in _columns(g.shape[1]):
            acc = g[:, c].to(torch.float32)
            g[:, c] = div(C.all_reduce_(acc, ma), float(ma.size)).to(g.dtype)
        return g

    def step(state: DistAflState, batch, zeta, tau, h2, budgets,
             tstate=None, *, seeds=None):
        r = state.rnd + 1
        theta = (r - state.kappa).to(torch.float32)
        grads = grads_of(state.w_n, batch)
        s = grads.shape[1]
        cols = _columns(s)

        g_new = state.g_n if donate else torch.empty_like(state.g_n)
        for c in cols:
            g_new[:, c] = (state.g_n[:, c].to(at)
                           + eta * grads[:, c].to(at)).to(sdt)
        x = state.e_n + g_new
        x_norm2 = owned_sq_norms(x, pl)

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
                layout, cpl)
            k_actual = cstats["k"]
            bits = cstats["bits"] * okf
            b_used = cstats["b"] * okf
        else:
            upload, e_after, k_actual = block_sparsify(x, model, pl, k,
                                                       dcfg.sample_size)
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
                dist.all_reduce(agg, group=mesh.data)
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
            "e_norm2": owned_sq_norms(e_n_new, pl),
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
                          donate: bool = False, rules=None) -> dict:
    """The step and the state's layout over the mesh, the reference's
    bundle: ``step``, ``dcfg``, ``controller``, ``compressor``,
    ``telemetry``, the rank's ``state_shardings`` (its row slices) /
    ``scalar_sharding`` / ``telemetry_sharding``, ``state_specs`` (the
    rules' specs, ``state_shardings``), ``placement``, and
    ``abstract_state()`` / ``init_state(seed, params=None)``.  Without a
    mesh, N defaults to one client."""
    dcfg = dcfg or DistConfig(
        num_clients=1 if mesh is None else mesh_num_clients(mesh))
    controller = controller or MadsController(s=model.num_params())
    step = make_afl_train_step(model, cfg, dcfg, controller,
                               compressor=compressor, telemetry=telemetry,
                               staleness=staleness, mesh=mesh, donate=donate,
                               rules=rules)
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
        "state_specs": state_shardings(
            model, {"data": 1, "model": 1} if mesh is None
            else mesh.axis_sizes, dcfg, rules),
        "placement": placement(model, mesh, rules),
        "abstract_state": lambda: abstract_state(model, dcfg, mesh, rules),
        "init_state": lambda seed=0, params=None: init_state(
            model, dcfg, seed, mesh=mesh, params=params, rules=rules),
    }

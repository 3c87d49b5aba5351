"""The meshes: a ``torch.distributed`` process group over the federation's
client axis, an experiment's seed axis or an ingest batch (the port of
``src/repro/launch/mesh.py``'s ``make_client_mesh`` and ``make_seed_mesh``,
with ``core/distributed.py::mesh_num_clients``).

The reference's mesh is one program over many TPU devices, with ``data``
(clients) and ``model`` (tensor-parallel parameters) axes.  Here there is
one process per card: a ``ClientMesh`` is the process group, this
process's rank and the group's size, and the device the rank runs on.  A
(data, model) mesh of D x M ranks places rank r at (r // M, r % M),
row-major as the reference's ``Mesh(devs.reshape(data, model))``: its
``model`` group is the M consecutive ranks of its row, its ``data`` group
the D ranks that share its model index, and rank r holds clients
[d N/D, (d + 1) N/D) of its data index d.  The model axis is ported for
every family: dense, VLM, MoE, ssm, hybrid, audio (Whisper) and the
paper's vision (ResNet-9) and trajectory (LaneGCN) models, channel-
parallel.  A serve step splits its batch over ``data`` (or, where the
batch does not divide, its cache's slots) through ``data_axis``.  The
seed mesh is a ``ClientMesh`` whose rows are seeds
(``experiments/batch.py``); the ingest server splits each packed batch
over a ``ClientMesh`` made by ``make_mesh`` (``serve/server.py``).

A single-rank group is made in-process on a file store in a temporary
directory, with no launcher.  A multi-rank group comes from the
environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) or from an explicit ``store`` with
``rank`` and ``world_size``.  The card means NCCL, the CPU gloo; a card
that is asked for and absent raises, and nothing carries on on the CPU.

The reference's ``make_production_mesh``, ``make_test_mesh`` and
``force_host_device_count`` shape one program's device array (a TPU pod,
simulated host devices); with one process per card they have no meaning,
and there are none here.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device

TIMEOUT = datetime.timedelta(seconds=300)  # a collective waiting longer fails
# the families with a model axis: every family
MODEL_AXIS_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio",
                       "vision", "trajectory")


def require_model_axis(family: str, model: int) -> None:
    """Raise ``ValueError`` for a model axis of ``model`` > 1 on a family
    outside ``MODEL_AXIS_FAMILIES``, which are all the known ones."""
    if model > 1 and family not in MODEL_AXIS_FAMILIES:
        raise ValueError(f"unknown family {family!r}")


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """One rank's view of the client mesh: the whole group, and for a
    model axis of ``model`` > 1 its ``model`` and ``data`` groups."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    owns_group: bool = False  # made the default group: ``close`` ends it
    model: int = 1
    model_group: object = None  # None: the model axis is 1
    data_group: object = None  # None: the whole group
    _axis: object = dataclasses.field(default=None, init=False, repr=False)
    _data_axis: object = dataclasses.field(default=None, init=False,
                                           repr=False)

    @property
    def data_size(self) -> int:
        return self.world_size // self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def axis_sizes(self) -> dict:
        """The (data, model) axes' sizes, the rules' view of the mesh."""
        return {"data": self.data_size, "model": self.model}

    @property
    def coords(self) -> dict:
        return {"data": self.data_rank, "model": self.model_rank}

    @property
    def data(self):
        """The group of the ranks that share this rank's model index."""
        return self.group if self.data_group is None else self.data_group

    def model_axis(self):
        """This rank's ``sharding.collectives.ModelAxis`` (None for a model
        axis of 1): one a mesh, so that its ``counts`` are the run's."""
        from repro_torch.sharding.collectives import ModelAxis

        if self.model == 1:
            return None
        if self._axis is None:
            self._axis = ModelAxis(self.model_group, self.model_rank,
                                   self.model)
        return self._axis

    def data_axis(self):
        """This rank's view of the ``data`` axis for serving, a
        ``sharding.collectives.ModelAxis`` over ``data_group`` (None for a
        data axis of 1): the rank's batch rows or cache slots, whose
        collectives it counts."""
        from repro_torch.sharding.collectives import ModelAxis

        if self.data_size == 1:
            return None
        if self._data_axis is None:
            self._data_axis = ModelAxis(self.data, self.data_rank,
                                        self.data_size)
        return self._data_axis

    def rows(self, num_clients: int) -> slice:
        """The rank's clients: rows [d N/D, (d + 1) N/D) of the client
        axis, d its index on ``data`` (of D)."""
        if num_clients % self.data_size:
            raise ValueError(
                f"{num_clients} clients do not split evenly over "
                f"{self.data_size} ranks of the data axis")
        per = num_clients // self.data_size
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def close(self) -> None:
        """End the process group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def mesh_num_clients(mesh: ClientMesh) -> int:
    """Clients the mesh's data axis carries at one client a rank (the
    reference's ``data`` x ``pod`` size)."""
    return mesh.data_size


def _launched() -> bool:
    """Whether ``torchrun`` (or the like) set this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def local_device(device="cuda") -> torch.device:
    """The device this process runs on: for "cuda", card ``LOCAL_RANK``
    (else the rank mod the card count) once a group exists, else the
    current card; "cpu" as it is."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dist.is_initialized():
        r = dist.get_rank()
        return torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", r % torch.cuda.device_count())))
    return torch.device("cuda", int(os.environ.get(
        "LOCAL_RANK", torch.cuda.current_device())))


def make_mesh(*, device="cuda", store=None, rank: int | None = None,
              world_size: int | None = None) -> ClientMesh:
    """The whole default process group as a mesh: the group already made
    in this process, else one made from ``store``/``rank``/``world_size``,
    else from the ``torchrun`` environment, else a single rank on a file
    store.  ``device`` "cuda" (the default) runs the rank on card
    ``LOCAL_RANK`` (else rank mod the card count) over NCCL; "cpu" over
    gloo."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no mesh on device {dev}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owns = False
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not {backend} for device {dev}")
    else:
        if store is not None:
            if rank is None or world_size is None:
                raise ValueError("an explicit store needs rank and world_size")
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world_size, timeout=TIMEOUT)
        elif _launched():
            dist.init_process_group(backend, init_method="env://",
                                    timeout=TIMEOUT)
        else:
            path = os.path.join(tempfile.mkdtemp(prefix="client_mesh_"),
                                "store")
            dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                    rank=0, world_size=1, timeout=TIMEOUT)
        owns = True
    dev = local_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return ClientMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                      world_size=dist.get_world_size(), device=dev,
                      owns_group=owns)


def make_client_mesh(num_clients: int, *, device="cuda", model: int = 1,
                     family: str | None = None, store=None,
                     rank: int | None = None,
                     world_size: int | None = None) -> ClientMesh:
    """The client mesh for a federation of ``num_clients``: ``make_mesh``'s
    group as a (data, model) mesh of (P / ``model``, ``model``), whose
    rank at data index d holds clients [d N/D, (d + 1) N/D).  A model axis
    above 1 needs the model's ``family``, a known one
    (``require_model_axis``).  Raises ``ValueError`` for an unknown family,
    when the ranks do not divide into rows of ``model`` or when
    ``num_clients`` does not split evenly over ``data``.
    """
    if model < 1:
        raise ValueError(f"a model axis of {model}")
    if model > 1:
        if family is None:
            raise ValueError("a model axis needs the model's family")
        require_model_axis(family, model)
    mesh = make_mesh(device=device, store=store, rank=rank,
                     world_size=world_size)
    try:
        if mesh.world_size % model:
            raise ValueError(f"{mesh.world_size} ranks do not divide into "
                             f"rows of a model axis of {model}")
        if model > 1:
            mesh = _with_model_axis(mesh, model)
        mesh.rows(num_clients)
    except ValueError:
        mesh.close()
        raise
    return mesh


def _with_model_axis(mesh: ClientMesh, model: int) -> ClientMesh:
    """``mesh`` as (P / model, model): every rank makes every group, in
    one order (``new_group`` is collective)."""
    p = mesh.world_size
    rows = [dist.new_group(list(range(d * model, (d + 1) * model)))
            for d in range(p // model)]
    cols = [dist.new_group(list(range(m, p, model))) for m in range(model)]
    return dataclasses.replace(mesh, model=model,
                               model_group=rows[mesh.rank // model],
                               data_group=cols[mesh.rank % model])


def make_seed_mesh(num_seeds: int, *, device="cuda", store=None,
                   rank: int | None = None,
                   world_size: int | None = None) -> ClientMesh | None:
    """The seed mesh for ``num_seeds`` seeds (the reference's
    ``make_seed_mesh``): the first U ranks of ``make_mesh``'s group, U the
    largest rank count that divides S, rank r of them running seeds
    [r S/U, (r + 1) S/U).  None where it has no seed axis: with U = 1
    (one usable rank, as the reference returns None on a single device;
    the group this call made is closed), and on the ranks past U, which
    then run every seed themselves and write nothing that rank 0 writes
    (``launch/sweep.py``)."""
    mesh = make_mesh(device=device, store=store, rank=rank,
                     world_size=world_size)
    use = max(k for k in range(1, mesh.world_size + 1) if num_seeds % k == 0)
    if use <= 1:
        mesh.close()
        return None
    if use == mesh.world_size:
        return mesh
    group = dist.new_group(list(range(use)))  # every rank takes part
    if mesh.rank >= use:
        return None
    return dataclasses.replace(mesh, group=group, world_size=use)

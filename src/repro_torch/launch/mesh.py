"""The client mesh: a ``torch.distributed`` process group over the
federation's client axis (the port of ``src/repro/launch/mesh.py``'s
``make_client_mesh``, with ``core/distributed.py::mesh_num_clients``).

The reference's mesh is one program over many TPU devices, with ``data``
(clients) and ``model`` (tensor-parallel parameters) axes.  Here there is
one process per card: a ``ClientMesh`` is the process group, this
process's rank and the group's size, and the device the rank runs on.  The
``data`` axis is the group (rank r holds clients [r N/P, (r + 1) N/P));
a ``model`` axis larger than 1 is not ported (ROADMAP queue 1 item 5c)
and raises.

A single-rank group is made in-process on a file store in a temporary
directory, with no launcher.  A multi-rank group comes from the
environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) or from an explicit ``store`` with
``rank`` and ``world_size``.  The card means NCCL, the CPU gloo; a card
that is asked for and absent raises, and nothing carries on on the CPU.

The reference's ``make_production_mesh``, ``make_test_mesh`` and
``force_host_device_count`` shape one program's device array (a TPU pod,
simulated host devices); with one process per card they have no meaning,
and there are none here.  ``make_seed_mesh`` waits for the seed mesh
(ROADMAP queue 1 item 5b).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device

MODEL_AXIS_ITEM = "ROADMAP queue 1 item 5c"
TIMEOUT = datetime.timedelta(seconds=300)  # a collective waiting longer fails


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """One rank's view of the client mesh."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    owns_group: bool = False  # made the default group: ``close`` ends it

    def rows(self, num_clients: int) -> slice:
        """The rank's clients: rows [r N/P, (r + 1) N/P) of the client
        axis."""
        if num_clients % self.world_size:
            raise ValueError(
                f"{num_clients} clients do not split evenly over "
                f"{self.world_size} ranks")
        per = num_clients // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def close(self) -> None:
        """End the process group if this mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def mesh_num_clients(mesh: ClientMesh) -> int:
    """Clients the mesh's data axis carries at one client a rank (the
    reference's ``data`` x ``pod`` size)."""
    return mesh.world_size


def _launched() -> bool:
    """Whether ``torchrun`` (or the like) set this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def make_client_mesh(num_clients: int, *, device="cuda", model: int = 1,
                     store=None, rank: int | None = None,
                     world_size: int | None = None) -> ClientMesh:
    """The client mesh for a federation of ``num_clients``.

    The group is the default process group: the one already made in this
    process, else one made from ``store``/``rank``/``world_size``, else
    from the ``torchrun`` environment, else a single rank on a file store.
    ``device`` "cuda" (the default) runs the rank on card ``LOCAL_RANK``
    (else rank mod the card count) over NCCL; "cpu" over gloo.  Raises
    ``ValueError`` when ``num_clients`` does not split evenly over the
    ranks and ``NotImplementedError`` for ``model`` > 1.
    """
    if model != 1:
        raise NotImplementedError(
            f"a model axis of {model}: tensor-parallel parameter sharding "
            f"is not ported ({MODEL_AXIS_ITEM})")
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no client mesh on device {dev}")
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
    r, p = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", r % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    mesh = ClientMesh(group=dist.group.WORLD, rank=r, world_size=p,
                      device=dev, owns_group=owns)
    try:
        mesh.rows(num_clients)
    except ValueError:
        mesh.close()
        raise
    return mesh

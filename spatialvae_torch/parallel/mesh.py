"""Rank meshes over ``torch.distributed`` — counterpart of
``spatialvae_tpu/parallel/mesh.py``.

The JAX package runs one controller over a mesh of devices, whose
collectives GSPMD and ``shard_map`` emit; the port runs one process (a
rank) per device and makes each collective explicit.  A ``Mesh`` is the
world's ranks laid out as a (data, model) grid, rank r at (r // model, r %
model), as ``np.asarray(devices).reshape(data, model)`` places device r:

- axis 'data': data parallelism, each data index a block of every global
  batch's rows; gradients and metrics are averaged over the axis;
- axis 'model': the fused int8 loss kernel's pixel axis (the spatial-VAE
  analogue of sequence parallelism, ``parallel/pixel.py``): each model
  index a contiguous slice of the pixels; the loss and the gradient
  partials are summed over the axis.

Each rank owns a process group per axis it belongs to (``Mesh.axis``).
The backend is chosen once and named: ``nccl`` where each rank has a card
of its own, ``gloo`` on the CPU or where the caller names it (ranks that
share one card: NCCL refuses two ranks on one device).  Nothing switches it
after a failure.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from spatialvae_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1

    @staticmethod
    def auto(n_ranks: Optional[int] = None, model: int = 1) -> "MeshConfig":
        """(n // model, model) over ``n_ranks`` ranks (default: the world's
        size)."""
        n = n_ranks or dist.get_world_size()
        if model < 1 or n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        return MeshConfig(data=n // model, model=model)


@dataclass(frozen=True)
class Axis:
    """One mesh axis as a rank sees it: its process group, its size and
    this rank's index along it."""

    name: str
    group: object
    size: int
    index: int


class Mesh:
    """The world's ranks as a (data, model) grid, seen from one rank:
    ``shape`` ({"data": d, "model": m}, as the JAX ``Mesh.shape``), this
    rank's coordinates, the device it computes on and its two axis
    groups."""

    def __init__(self, cfg: MeshConfig, rank: int, backend: str,
                 device: torch.device, data_group, model_group):
        self.cfg = cfg
        self.rank = rank
        self.backend = backend
        self.device = torch.device(device)
        self.data_index, self.model_index = divmod(rank, cfg.model)
        self._groups = {"data": data_group, "model": model_group}

    @property
    def shape(self) -> dict:
        return {"data": self.cfg.data, "model": self.cfg.model}

    @property
    def size(self) -> int:
        return self.cfg.data * self.cfg.model

    def axis(self, name: str) -> Axis:
        index = self.data_index if name == "data" else self.model_index
        return Axis(name, self._groups[name], self.shape[name], index)

    def describe(self) -> str:
        """The CLIs' ``# mesh:`` line."""
        return (f"# mesh: {self.shape}, {self.size} ranks, backend "
                f"{self.backend}, rank {self.rank} at (data "
                f"{self.data_index}, model {self.model_index}) on "
                f"{self.device}")


def choose_backend(device, backend: Optional[str] = None) -> str:
    """``backend`` when the caller names one, else ``nccl`` for a card and
    ``gloo`` for the CPU."""
    if backend is not None:
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(rank: int, world_size: int, init_method: str, device,
               backend: Optional[str] = None) -> str:
    """Join the world (``torch.distributed.init_process_group``) as
    ``rank`` of ``world_size`` at ``init_method`` (``tcp://host:port`` or
    ``file://path``); returns the backend, chosen once (``choose_backend``).
    With NCCL the rank's card becomes the current device."""
    backend = choose_backend(device, backend)
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def rank_device(device=None, local_rank: Optional[int] = None
                ) -> torch.device:
    """The device a rank computes on: ``device`` when the caller names one
    (the CPU only so), else a card, whatever the backend: card
    ``local_rank`` when given, else the current one.  Without a card it
    raises (``resolve_device``): a rank never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    return torch.device("cuda", torch.cuda.current_device()
                        if local_rank is None else local_rank)


def create_mesh(cfg: MeshConfig, device=None) -> Mesh:
    """The (data, model) mesh over the initialised world, whose size must be
    data * model.  Every rank calls it (each axis group is created by all
    ranks, in the same order); ``device`` is this rank's (default: the
    current card, under either backend; the CPU only when named)."""
    device = rank_device(device)
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised world "
                           "(init_world or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if cfg.data * cfg.model != world:
        raise ValueError(f"mesh {cfg} needs {cfg.data * cfg.model} ranks, "
                         f"the world has {world}")
    backend = dist.get_backend()
    data_group = model_group = None
    # the data axis: the ranks of one model index; the model axis: those
    # of one data index
    for m in range(cfg.model):
        g = dist.new_group([d * cfg.model + m for d in range(cfg.data)])
        if rank % cfg.model == m:
            data_group = g
    for d in range(cfg.data):
        g = dist.new_group([d * cfg.model + m for m in range(cfg.model)])
        if rank // cfg.model == d:
            model_group = g
    return Mesh(cfg, rank, backend, device, data_group, model_group)


def multihost_rank(num_processes: int, process_id: int,
                   local_ranks: int = 1, local_rank: int = 0) -> int:
    """Host ``process_id`` of ``num_processes`` runs ``local_ranks`` ranks
    (one per local card), so the world has num_processes * local_ranks
    ranks and its ``local_rank``-th is process_id * local_ranks +
    local_rank (JAX's process is a host, holding all of its devices)."""
    if not (0 <= process_id < num_processes and
            0 <= local_rank < local_ranks):
        raise ValueError(f"process {process_id} of {num_processes}, local "
                         f"rank {local_rank} of {local_ranks}")
    return process_id * local_ranks + local_rank


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, local_ranks: int = 1,
                         local_rank: int = 0, device=None,
                         backend: Optional[str] = None) -> int:
    """Join a multi-host world as ``multihost_rank``'s rank; the
    coordinator is host 0's ``host:port``.  ``device`` defaults to card
    ``local_rank`` (``rank_device``; the CPU only when named).  Returns
    the global rank."""
    rank = multihost_rank(num_processes, process_id, local_ranks,
                          local_rank)
    init_world(rank, num_processes * local_ranks,
               f"tcp://{coordinator_address}",
               rank_device(device, local_rank), backend)
    return rank


def primary() -> bool:
    """Whether this process writes a run's outputs: always outside a
    world, else rank 0 alone."""
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def env_world() -> Optional[dict]:
    """The world a launcher (torchrun) put in the environment: rank,
    world_size, local_rank and the init method, or None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    return {"rank": int(os.environ["RANK"]),
            "world_size": int(os.environ["WORLD_SIZE"]),
            "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
            "init_method": f"tcp://{addr}:{port}"}

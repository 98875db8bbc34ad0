"""The device mesh of a multi-rank run: the counterpart of the JAX package's
``launch/mesh.py::make_host_mesh``.

A run of D x P ranks is a ("data", "model") mesh.  The rank at coordinates
(i, j) is ``i * P + j``, as ``jax.make_mesh`` lays out devices.  The P ranks
that share a data index form an EP group: they exchange tokens, and each
holds E / P experts of every MoE layer (rank j the experts
[j E/P, (j+1) E/P), as ``P(ep_axis, None, None)`` cuts them; under expert
placement a rank also receives the weights of its slots' other experts
with ``all_to_all_v``, an exchange of blocks of variable size).  The D ranks
that share a model index form a data-parallel group: they hold the same
experts.

The collective backend is chosen here and nowhere else (``init_world``):
NCCL when every rank has a card of its own, gloo otherwise (the CPU, or
several ranks sharing one card).  The choice is printed, and a run never
switches from one backend to the other.

``make_production_mesh`` (the JAX package's 256-chip shape) is not ported:
``make_host_mesh((16, 16))`` raises unless the world has 256 ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")


def parse_mesh(text: str) -> Optional[tuple]:
    """``"local"`` -> None (one peer, no process group); ``"DxP"`` -> (D, P).
    ``"1x1"`` is the one-peer path too."""
    if text == "local":
        return None
    try:
        shape = tuple(int(v) for v in text.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh takes 'local' or DxP (e.g. 1x2), got {text!r}")
    return None if shape == (1, 1) else shape


def backend_for(device: torch.device, local_world: int) -> str:
    """NCCL when every rank on this host has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_world(rank: int, world: int, init_method: str, device, *,
               local_rank: Optional[int] = None,
               local_world: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device: ``cuda:local_rank``
    under NCCL, the given device under gloo (the CPU, or one card that all
    ranks share)."""
    device = torch.device(device)
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    backend = backend_for(device, local_world)
    if backend == "nccl":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if rank == 0:
        shared = ("" if backend == "nccl" else
                  f", {local_world} ranks sharing {device.type}")
        print(f"process group: {backend} backend, {world} ranks{shared}",
              flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return device


def init_world_from_env(device) -> torch.device:
    """``init_world`` for a rank started by ``torchrun`` (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE and the store's address in the
    environment)."""
    env = os.environ
    return init_world(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://", device,
                      local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
                      local_world=int(env.get("LOCAL_WORLD_SIZE",
                                              env["WORLD_SIZE"])))


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (D, P) mesh and its process groups."""
    shape: tuple               # (D, P)
    coords: tuple              # this rank's (i, j)
    ep_group: object           # the P ranks of data index i
    dp_group: object           # the D ranks of model index j
    axis_names: tuple = AXES

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def peers(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def rank(self) -> int:
        return self.coords[0] * self.shape[1] + self.coords[1]

    def local_experts(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an (E, ...) expert weight (a view)."""
        e_local = w.shape[0] // self.peers
        j = self.coords[1]
        return w[j * e_local:(j + 1) * e_local]

    # -- collectives ---------------------------------------------------------
    def _group(self, over: str):
        return {"world": (None, self.size), "ep": (self.ep_group, self.peers),
                "dp": (self.dp_group, self.data)}[over]

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Exchange dim 0's P equal blocks over the EP group: block p goes to
        peer p, and the block peer p holds for this rank arrives as block p."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.ep_group)
        return out

    def all_to_all_v(self, t: torch.Tensor, send_splits: list,
                     recv_splits: list) -> torch.Tensor:
        """Exchange blocks of variable size over the EP group: dim 0 of
        ``t`` is P blocks in peer order, block p (``send_splits[p]`` rows)
        going to peer p; the result holds, in peer order, the
        ``recv_splits[p]`` rows peer p sent this rank.  Every peer must
        pass splits that agree (what p sends here is what this rank
        expects from p)."""
        t = t.contiguous()
        out = t.new_empty((sum(recv_splits),) + tuple(t.shape[1:]))
        dist.all_to_all_single(out, t, output_split_sizes=list(recv_splits),
                               input_split_sizes=list(send_splits),
                               group=self.ep_group)
        return out

    def all_reduce_(self, t: torch.Tensor, over: str = "world") -> torch.Tensor:
        """Sum ``t`` in place over the world, the EP group ("ep") or the
        data-parallel group ("dp"); a group of one rank is skipped."""
        group, n = self._group(over)
        if n > 1:
            dist.all_reduce(t, group=group)
        return t

    def barrier(self) -> None:
        dist.barrier()


def make_host_mesh(shape=(2, 2), axes=AXES) -> Mesh:
    """The (D, P) mesh over the initialised world, whose size must be D * P.
    Every rank builds every group, in the same order."""
    if tuple(axes) != AXES:
        raise ValueError(f"the port's mesh has axes {AXES}, got {tuple(axes)}")
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(launch/mesh.py::init_world)")
    D, P = shape
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != D * P:
        raise RuntimeError(f"mesh {tuple(shape)} needs {D * P} ranks, the world "
                           f"has {world}")
    ep = [dist.new_group([i * P + j for j in range(P)]) for i in range(D)]
    dp = [dist.new_group([i * P + j for i in range(D)]) for j in range(P)]
    i, j = divmod(rank, P)
    return Mesh(shape=(D, P), coords=(i, j), ep_group=ep[i], dp_group=dp[j])

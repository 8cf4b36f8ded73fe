"""Device mesh over torch.distributed (port of `tachikoma_tpu/parallel/mesh.py`).

The JAX package's mesh is a `jax.sharding.Mesh` of devices with named axes;
here it is the ranks of a torch.distributed process group laid out on the
same named axes, each axis line a subgroup (`new_group`), each rank
computing on its own `device`.

Axis conventions used across the framework:
  dp — data parallel (batch)
  tp — tensor parallel (channels / model dims; int32 partial sums all-reduce)
  pp — pipeline stages
  sp — sequence parallel (attention ring)
  ep — expert parallel (moe.py)

Backend rule: "nccl" with one GPU per rank; "gloo" when ranks share one
card, and on the CPU.  NCCL refuses two ranks on one GPU ("Duplicate GPU
detected").  The backend is the caller's argument, never chosen by catching
a failure.  Gloo's collectives on CUDA tensors differ between torch
versions, so with gloo a CUDA tensor goes to the host explicitly, through
the collective and back (`Collective`): that copy is the transport, and is
counted; the computation never leaves the card.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.executor import resolve_device

BACKENDS = ("gloo", "nccl")


class Collective:
    """The collectives of one axis line: an int32 SUM all-reduce, an
    all-gather along a dimension and the ring's send/recv.  `stats` (shared
    by the mesh's lines) counts per kind the calls, the bytes this rank puts
    on the wire, the bytes it copies between the card and the host, and the
    host seconds inside the collective (for a host-staged one, from the
    moment the card is idle)."""

    def __init__(self, group, ranks: list[int], backend: str, stats):
        self.group = group
        self.ranks = ranks          # global ranks, in axis order
        self.size = len(ranks)
        self.index = ranks.index(dist.get_rank())
        self.backend = backend
        self.stats = stats

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether `t` goes through a host copy: gloo and a CUDA tensor."""
        return self.backend == "gloo" and t.is_cuda

    def _start(self, t: torch.Tensor) -> float:
        """The host clock; for a host-staged tensor, once the card has
        finished the work `t` waits on (NCCL stays asynchronous)."""
        if self._staged(t):
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def _count(self, kind: str, nbytes: int, host_bytes: int, t0: float) -> None:
        s = self.stats[kind]
        s["calls"] += 1
        s["bytes"] += nbytes
        s["host_bytes"] += host_bytes
        s["seconds"] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM over the line of an int32 tensor (two's-complement
        wraparound, as the int32 accumulators it combines)."""
        if t.dtype != torch.int32:
            raise TypeError(f"all_reduce: int32 partial sums only, got {t.dtype}")
        t0, staged = self._start(t), self._staged(t)
        wire = t.cpu() if staged else t.contiguous()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
        self._count("all_reduce", t.nbytes, 2 * t.nbytes if staged else 0, t0)
        return wire.to(t.device) if staged else wire

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The line's equal-shape pieces concatenated along `dim` in axis
        order."""
        t0, staged = self._start(t), self._staged(t)
        wire = t.cpu() if staged else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts, dim)
        self._count("all_gather", t.nbytes, t.nbytes + out.nbytes if staged else 0, t0)
        return out.to(t.device) if staged else out

    def ring_shift(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor sent to the next index on the line and replaced by the
        previous index's: one step of a ring rotation (batch_isend_irecv)."""
        t0, staged = self._start(tensors[0]), self._staged(tensors[0])
        wires = [t.cpu() if staged else t.contiguous() for t in tensors]
        got = [torch.empty_like(w) for w in wires]
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        ops = [dist.P2POp(dist.isend, w, nxt, self.group) for w in wires]
        ops += [dist.P2POp(dist.irecv, r, prv, self.group) for r in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        nbytes = sum(t.nbytes for t in tensors)
        self._count("send_recv", nbytes, 2 * nbytes if staged else 0, t0)
        return [r.to(t.device) for r, t in zip(got, tensors)] if staged else got


class Mesh:
    """The ranks of the default process group laid out on named axes.

    Built by `simple_mesh` / `Topology.make_mesh` on every rank of the world
    (each subgroup is created by every rank).  A rank past the mesh's size
    holds a mesh it is not a member of (`member` False) and takes no part in
    its collectives."""

    def __init__(self, axes: dict[str, int], backend: str, device: torch.device,
                 lines: dict[str, Collective], coords: dict[str, int] | None, stats):
        self.axes = dict(axes)
        self.axis_names = tuple(axes)
        self.backend = backend
        self.device = device
        self.lines = lines
        self.coords = coords
        self.stats = stats

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0) if self.coords else 0

    def collective(self, axis: str) -> Collective:
        return self.lines[axis]

    def reset_stats(self) -> None:
        self.stats.clear()

    def stats_snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.stats.items()}


@dataclass(frozen=True)
class Topology:
    """Declarative mesh spec; realize with .make_mesh()."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.pp * self.sp

    def make_mesh(self, *, backend: str, device="cuda") -> Mesh:
        return simple_mesh({"dp": self.dp, "tp": self.tp, "pp": self.pp, "sp": self.sp},
                           backend=backend, device=device)


def simple_mesh(axes: dict[str, int] | None = None, *, backend: str, device="cuda") -> Mesh:
    """A mesh with exactly the named axes, e.g. {'dp': 2, 'tp': 4}, over the
    first ranks of the default process group (all of them by default, on
    'dp'); every rank of the group calls it.  `backend` names the subgroups'
    backend ("gloo" or "nccl"), `device` this rank's compute device ("cuda"
    by default: with no card it raises)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = resolve_device(device, "simple_mesh")
    if not dist.is_initialized():
        raise RuntimeError("simple_mesh: no default process group (parallel/gather.py "
                           "init_distributed, or torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    axes = dict(axes or {"dp": world})
    n = int(np.prod(list(axes.values())))
    if world < n:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    grid = np.arange(n).reshape(tuple(axes.values()))
    stats = defaultdict(lambda: {"calls": 0, "bytes": 0, "host_bytes": 0, "seconds": 0.0})
    lines = {}
    for i, axis in enumerate(axes):
        for line in np.moveaxis(grid, i, -1).reshape(-1, axes[axis]):
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                lines[axis] = Collective(group, ranks, backend, stats)
    coords = None
    if rank < n:
        coords = {a: int(c) for a, c in zip(axes, np.unravel_index(rank, grid.shape))}
    return Mesh(axes, backend, dev, lines, coords, stats)

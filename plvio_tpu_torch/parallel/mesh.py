"""The shard mesh: the port's counterpart of a 1-D `jax.sharding.Mesh`
under `jax.shard_map`.

A `Mesh` is a list of shards, each placed on a device; one device may
hold several shards (`Mesh([cuda:0] * 2)` is two shards on one card, as
the JAX tests' virtual CPU mesh is eight shards in one process).  One
process drives all of its shards in turn (a single controller), so a
sharded solver keeps one list entry per local shard where the JAX body
holds one block per device, and calls the mesh where the JAX body calls a
collective:

- `psum(parts)`: the sum of the shards' partials, added in shard order on
  the first local device; with a process group, then `all_reduce(SUM)`
  across the processes.  Every process gets the same bits, since every
  later decision (the LM accept, the early exit) reads them.
- `ppermute(xs, shift)`: shard d receives shard (d - shift) mod D's
  value, the halo exchange of the chained solvers.  Local shards shift in
  memory; across processes `send` / `recv` carry it (under gloo through
  host memory: its send / recv abort on a CUDA tensor, where its
  all_reduce takes one).
- `axis_index(i)`: the global index of local shard i; `size` is D.

With a `torch.distributed` group of more than one process, the shards are
numbered process-major: every process passes its own devices, all
processes the same number of them, and process r holds shards r * n ..
r * n + n - 1.

`default_mesh(device)` is the production rule of the JAX mapper
(plvio_tpu/models/local_mapping.py:140-157) on the caller's device type,
as JAX takes the devices of its own backend: PLVIO_DIST=1 forces the
sharded back end (one shard per visible card where `device` is a card,
one shard on `device` otherwise), PLVIO_DIST=0 forbids it, and otherwise
it is on when `device` is a card and more than one card is visible (one
shard per card).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

from ..cuda import resolve_device


class Mesh:
    """D shards on a list of devices (see the module docstring)."""

    def __init__(self, devices: Sequence, group=None):
        if len(devices) == 0:
            raise ValueError("a mesh holds at least one shard")
        self.devices: List[torch.device] = [resolve_device(d)
                                            for d in devices]
        self.group = group
        self.n_local = len(self.devices)
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.size = self.world * self.n_local
        self.offset = self.rank * self.n_local

    def __repr__(self) -> str:
        return (f"Mesh({self.size} shards, process {self.rank} of "
                f"{self.world}: {[str(d) for d in self.devices]})")

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def axis_index(self, i: int) -> int:
        """The global shard index of local shard i."""
        return self.offset + i

    def local_of(self, g: int) -> Optional[int]:
        """Local index of global shard g, None where another process
        holds it."""
        i = g - self.offset
        return i if 0 <= i < self.n_local else None

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the local shards' partials, in shard order on the
        first local device (partials on other devices are copied there
        first); with a group, then all_reduce(SUM) across processes."""
        if len(parts) != self.n_local:
            raise ValueError(f"psum: {len(parts)} partials for "
                             f"{self.n_local} local shards")
        acc = parts[0].to(self.first).clone()
        for p in parts[1:]:
            acc = acc + p.to(self.first)
        if self.world > 1:
            acc = self._all_reduce(acc)
        return acc

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed in place across the group's processes (gloo and NCCL
        both reduce a CUDA tensor where it lies)."""
        import torch.distributed as dist
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x on every local shard's device (one copy per device)."""
        copies = {}
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = x if x.device == dev else x.to(dev)
            out.append(copies[dev])
        return out

    def ppermute(self, xs: Sequence[torch.Tensor],
                 shift: int) -> List[torch.Tensor]:
        """out[d] = xs[(d - shift) mod D] for every local shard d (the
        JAX perm [(s, (s + shift) % D)])."""
        D = self.size
        out: List[Optional[torch.Tensor]] = [None] * self.n_local
        sends, recvs = [], []
        for i in range(self.n_local):
            g = self.axis_index(i)
            src = (g - shift) % D
            j = self.local_of(src)
            if j is not None:
                out[i] = xs[j].to(self.devices[i]).clone()
            else:
                recvs.append((i, src))
            dst = (g + shift) % D
            if self.local_of(dst) is None:
                sends.append((i, dst))
        if sends or recvs:
            import torch.distributed as dist
            # gloo's send / recv abort the process on a CUDA tensor, so
            # its halos go through host memory; NCCL's stay on the card
            host = dist.get_backend(self.group) != "nccl"
            ops = []
            for i, dst in sends:
                t = xs[i].detach().contiguous()
                ops.append(dist.P2POp(dist.isend, t.cpu() if host else t,
                                      dst // self.n_local, self.group))
            got = []
            for i, src in recvs:
                t = torch.empty(xs[i].shape, dtype=xs[i].dtype,
                                device="cpu" if host else self.devices[i])
                got.append((i, t))
                ops.append(dist.P2POp(dist.irecv, t,
                                      src // self.n_local, self.group))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for i, t in got:
                out[i] = t.to(self.devices[i])
        return out


def default_mesh(device) -> Optional[Mesh]:
    """The mesh of the production rule (module docstring), or None where
    the single-device window kernel runs."""
    flag = os.environ.get("PLVIO_DIST", "")
    if flag == "0":
        return None
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards > 1:
        return Mesh([torch.device("cuda", i) for i in range(n_cards)])
    if flag == "1":
        return Mesh([dev])
    return None

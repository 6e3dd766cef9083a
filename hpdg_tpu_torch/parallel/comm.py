"""The shard group: the port's counterpart of ``shard_map``, ``ppermute``
and ``psum``.

The reference runs every shard of a device grid as one SPMD program
inside ``jax.shard_map``; its only communication is ``ppermute`` of
fixed-size halo buffers between grid neighbours and the psums XLA emits
for global reductions.  A :class:`ShardGroup` holds the ``ndev`` shards
of such a grid as ``n_ranks`` ranks of ``L`` consecutive shards each:

* **one process** (``n_ranks == 1``, ``L == ndev``) keeps every shard on
  one device.  Sharded vectors keep the reference's global layout
  ``[ndev * m, ...]`` (shard ``s`` owns rows ``s*m .. s*m+m-1``), and a
  shard body runs batched over a leading shard axis;
* **many ranks** run through ``torch.distributed``: NCCL with one card
  per rank, or gloo on the CPU.  A rank's vectors hold the rows of its
  own ``L`` shards only.

``ppermute`` keeps the reference's semantics exactly: pairs are given per
device-grid axis, and a shard that no pair targets receives zeros.  Pairs
whose ends are both local are a device-side copy; the others go through
``batch_isend_irecv`` between the two ranks, straight from device memory
(a CUDA group must use NCCL: nothing is staged through the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hpdg_tpu_torch import device as dev


class ShardGroup:
    """``ndev`` shards over ``n_ranks`` ranks of ``L`` shards each.

    ``ShardGroup(ndev, device)`` is the one-process group;
    :meth:`from_process_group` joins an initialized
    ``torch.distributed`` group.  ``device=None`` is the card."""

    def __init__(self, ndev: int, device=None, process_group=None):
        self.ndev = int(ndev)
        if self.ndev < 1:
            raise ValueError(f"a shard group needs at least one shard, "
                             f"got {ndev}")
        self.device = dev.resolve(device)
        self.pg = process_group
        if process_group is None:
            self.n_ranks, self.rank = 1, 0
        else:
            import torch.distributed as dist
            self.n_ranks = dist.get_world_size(process_group)
            self.rank = dist.get_rank(process_group)
            backend = str(dist.get_backend(process_group)).lower()
            if self.device.type == "cuda" and backend != "nccl":
                raise RuntimeError(
                    f"a CUDA shard group needs the NCCL backend, the "
                    f"process group runs {backend!r}")
            if self.device.type != "cuda" and backend == "nccl":
                raise RuntimeError("an NCCL process group needs "
                                   "device='cuda'")
        if self.ndev % self.n_ranks:
            raise ValueError(f"{self.ndev} shards do not divide over "
                             f"{self.n_ranks} ranks")
        self.L = self.ndev // self.n_ranks
        self._plans = {}

    @classmethod
    def from_process_group(cls, ndev: int, device=None, process_group=None):
        """The group of the initialized ``torch.distributed`` world (or
        ``process_group``): each rank holds ``ndev // world_size``
        consecutive shards."""
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized")
        return cls(ndev, device=device,
                   process_group=process_group or dist.group.WORLD)

    # ---- layout ----------------------------------------------------------
    @property
    def distributed(self) -> bool:
        return self.pg is not None

    @property
    def shards(self) -> range:
        """Global ids of this rank's shards."""
        return range(self.rank * self.L, (self.rank + 1) * self.L)

    def local_rows(self, a, m: int):
        """This rank's rows of a global ``[ndev * m, ...]`` array."""
        return a[self.rank * self.L * m:(self.rank + 1) * self.L * m]

    # ---- communication -----------------------------------------------------
    def grid_pairs(self, axis: int, perm, grid=None) -> tuple:
        """Global shard pairs ``(src, dst)`` of ``perm`` (pairs of
        coordinates along device-grid ``axis``) on ``grid`` (C order;
        default the 1-axis grid ``(ndev,)``)."""
        grid = tuple(grid) if grid is not None else (self.ndev,)
        if int(np.prod(grid)) != self.ndev:
            raise ValueError(f"device grid {grid} does not hold "
                             f"{self.ndev} shards")
        out = []
        for i, j in perm:
            for s in range(self.ndev):
                c = list(np.unravel_index(s, grid))
                if c[axis] != i:
                    continue
                c[axis] = j
                out.append((s, int(np.ravel_multi_index(c, grid))))
        return tuple(out)

    def _plan(self, pairs: tuple):
        plan = self._plans.get(pairs)
        if plan is not None:
            return plan
        lo, hi = self.shards.start, self.shards.stop
        dsts = [d for _, d in pairs]
        if len(set(dsts)) != len(dsts):
            raise ValueError("ppermute pairs target a shard twice")
        I = lambda v: torch.as_tensor(v, dtype=torch.long,  # noqa: E731, E741
                                      device=self.device)
        loc = [(s - lo, d - lo) for s, d in pairs
               if lo <= s < hi and lo <= d < hi]
        sends, recvs = {}, {}
        for s, d in pairs:
            rs, rd = s // self.L, d // self.L
            if rs == self.rank and rd != self.rank:
                sends.setdefault(rd, []).append(s - lo)
            elif rd == self.rank and rs != self.rank:
                recvs.setdefault(rs, []).append(d - lo)
        plan = (I([a for a, _ in loc]), I([b for _, b in loc]),
                {q: I(v) for q, v in sorted(sends.items())},
                {q: I(v) for q, v in sorted(recvs.items())})
        self._plans[pairs] = plan
        return plan

    def ppermute(self, buf: torch.Tensor, axis: int, perm,
                 grid=None) -> torch.Tensor:
        """``buf[L, ...]`` (one block per local shard) -> the blocks
        received along ``perm`` on grid ``axis``; zeros where no pair
        targets a shard."""
        return self.permute(buf, self.grid_pairs(axis, perm, grid))

    def permute(self, buf: torch.Tensor, pairs: tuple) -> torch.Tensor:
        """:meth:`ppermute` with global shard pairs ``(src, dst)``."""
        src, dst, sends, recvs = self._plan(tuple(pairs))
        out = torch.zeros_like(buf)
        if len(src):
            out[dst] = buf[src]
        if sends or recvs:
            import torch.distributed as dist
            ops, landing = [], []
            for q, idx in sends.items():
                ops.append(dist.P2POp(dist.isend, buf[idx].contiguous(),
                                      self._global_rank(q), self.pg))
            for q, idx in recvs.items():
                t = torch.empty((len(idx),) + tuple(buf.shape[1:]),
                                dtype=buf.dtype, device=buf.device)
                ops.append(dist.P2POp(dist.irecv, t, self._global_rank(q),
                                      self.pg))
                landing.append((idx, t))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for idx, t in landing:
                out[idx] = t
        return out

    def _global_rank(self, q: int) -> int:
        import torch.distributed as dist
        if self.pg is dist.group.WORLD:
            return q
        return dist.get_global_rank(self.pg, q)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of a rank-local partial over all ranks (the local sum over
        a one-process group's shards is already global)."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        t = t.clone()
        dist.all_reduce(t, group=self.pg)
        return t

    def all_rows(self, a: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in shard order: the global ``[ndev * m,
        ...]`` array from this rank's ``[L * m, ...]``."""
        if not self.distributed:
            return a
        import torch.distributed as dist
        parts = [torch.empty_like(a) for _ in range(self.n_ranks)]
        dist.all_gather(parts, a.contiguous(), group=self.pg)
        return torch.cat(parts)


@dataclass(frozen=True)
class Sharding:
    """The layout of one sharded array: ``rows`` rows per shard of
    ``group`` (the counterpart of a ``NamedSharding`` on axis 0)."""

    group: ShardGroup
    rows: int


def resolve_group(group, ndev: int | None = None) -> ShardGroup:
    """``group`` itself, or the one-process group a builder uses when
    given none: ``ndev`` shards (default one per visible card) on the
    card.  A given group must hold ``ndev`` shards when ``ndev`` is
    set."""
    if group is None:
        return ShardGroup(ndev or max(torch.cuda.device_count(), 1))
    if ndev is not None and group.ndev != ndev:
        raise ValueError(f"need {ndev} shards, the group holds "
                         f"{group.ndev}")
    return group


def safe_div(a, d):
    """``a / d`` where ``d != 0``, else 0 (converged fixed-count Krylov
    iterations become no-ops instead of NaNs)."""
    return torch.where(d.abs() > 0, a / torch.where(d == 0, 1.0, d),
                       torch.zeros_like(a))

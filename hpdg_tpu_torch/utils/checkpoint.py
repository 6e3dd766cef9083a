"""Solver-state checkpointing.

Port of ``hpdg_tpu.utils.checkpoint``: a bucketed coefficient dict is
written with ``torch.save`` (keys stringified) beside a JSON file of the
host-side metadata needed to rebuild the problem (degree map, mesh
cells, iteration counter), and read back with ``torch.load`` onto a
chosen device, bit for bit.

Sharded vectors (``parallel.hp.HPSharded`` layouts) are written with
their shard group: each rank writes one file per shard it holds
(``state.shard<s>.pt``, that shard's rows), and a restore into
``shardings`` (``{p: parallel.comm.Sharding}``, e.g.
``HPSharded.shardings``) reads only the files of the rank's own shards.
A checkpoint written without a group restores into shardings by slicing
each rank's rows out of the global array.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from hpdg_tpu_torch import device as dev


def _int_keys(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            out[int(k)] = v
        except ValueError:
            out[k] = v
    return out


def save_sharded(path, x: dict, meta: dict | None = None, group=None):
    """Checkpoint a bucketed vector dict and JSON-able metadata into the
    directory ``path`` (keys of ``x`` may be ints, stored stringified).
    ``group``: the shard group ``x`` is laid out on; each rank then
    writes one file per shard it holds."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    if group is None:
        torch.save({str(k): v.detach() for k, v in x.items()},
                   path / "state.pt")
    else:
        for i, s in enumerate(group.shards):
            part = {}
            for k, v in x.items():
                m = v.shape[0] // group.L
                part[str(k)] = v.detach()[i * m:(i + 1) * m].clone()
            torch.save(part, path / f"state.shard{s}.pt")
    if meta is not None and (group is None or group.rank == 0):
        (path / "meta.json").write_text(json.dumps(meta))
    if group is not None and group.distributed:
        import torch.distributed as dist
        dist.barrier(group=group.pg)


def load_sharded(path, shardings: dict | None = None, device=None):
    """Restore a checkpoint written by :func:`save_sharded` onto
    ``device``, or, with ``shardings`` (``{p: Sharding}``), into this
    rank's rows of that layout on the group's device.  Returns ``(x,
    meta)`` (``meta`` None if none was written)."""
    path = Path(path).absolute()
    if shardings is not None:
        x = _restore_sharded(path, shardings)
    else:
        x = _int_keys(torch.load(path / "state.pt", weights_only=True,
                                 map_location=dev.resolve(device)))
    mf = path / "meta.json"
    meta = json.loads(mf.read_text()) if mf.exists() else None
    return x, meta


def _restore_sharded(path: Path, shardings: dict) -> dict:
    group = next(iter(shardings.values())).group
    where = group.device
    if (path / "state.pt").exists():
        full = torch.load(path / "state.pt", weights_only=True,
                          map_location=where)
        return {k: group.local_rows(full[str(k)], sh.rows).clone()
                for k, sh in shardings.items()}
    parts = [torch.load(path / f"state.shard{s}.pt", weights_only=True,
                        map_location=where) for s in group.shards]
    out = {}
    for k, sh in shardings.items():
        rows = [part[str(k)] for part in parts]
        if any(r.shape[0] != sh.rows for r in rows):
            raise ValueError(f"bucket {k}: checkpoint shards hold "
                             f"{[r.shape[0] for r in rows]} rows, the "
                             f"layout {sh.rows}")
        out[k] = torch.cat(rows)
    return out


def save_solver_state(path, x: dict, degrees, iteration: int = 0,
                      cells=None, extra: dict | None = None):
    """Checkpoint a solver iterate with the metadata needed to resume:
    degree map, mesh cells, iteration counter."""
    meta = {"iteration": int(iteration),
            "degrees": np.asarray(degrees).tolist(),
            "cells": list(cells) if cells is not None else None}
    if extra:
        meta.update(extra)
    save_sharded(path, x, meta)


class SolverCheckpointManager:
    """Rotating checkpoints for long iterative or adaptive runs: a step
    is saved when it is a multiple of ``save_every`` and later than the
    latest saved one; the last ``max_to_keep`` survive (one directory
    per step under ``path``)."""

    def __init__(self, path, max_to_keep: int = 3, save_every: int = 1):
        self.path = Path(path).absolute()
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        self.path.mkdir(parents=True, exist_ok=True)

    def steps(self) -> list:
        return sorted(int(p.name) for p in self.path.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, x: dict) -> bool:
        latest = self.latest_step()
        if step % self.save_every or (latest is not None and step <= latest):
            return False
        save_sharded(self.path / str(step), x)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.path / str(old))
        return True

    def restore(self, step: int | None = None,
                shardings: dict | None = None, device=None) -> dict:
        step = self.latest_step() if step is None else step
        return load_sharded(self.path / str(step), shardings=shardings,
                            device=device)[0]

    def close(self):
        """Nothing is written in the background: saving is synchronous."""

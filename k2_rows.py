#!/usr/bin/env python3
"""K2's rows: the block SpMV kernel (``hpdg_tpu_torch/csrc/block_spmv.cu``)
on one NVIDIA card at the buckets of configs 4 and 5 and of 3D
elasticity with wide blocks, held against another checkout's K2, its
plain version and one BSR product.

Run from the root of a checkout, on a card:

    python3 k2_rows.py [--parent DIR] [--groups G,...] [--obstacle-call]
                       [--json FILE]

``--parent DIR``: a checkout (or ``git archive``) of another commit,
whose K2 (``hpdg_tpu_torch/csrc/block_spmv.cu``) is built beside this
one's and called through that checkout's own wrapper
(``hpdg_tpu_torch/ops/block_spmv.py``), so that both event times hold
their wrapper's host work.  ``--obstacle-call``: then one call of
config 5's verified solve (``solve_obstacle_verified``, ``n_runs=1``,
as the bench's cell calls it) after a first, under the profiler: its
device ms and launches by K2 kernel, and the call's device ms (the
window and its rows are the bench's: ``bench_torch.measure.traced``);
with ``--parent``, in the order parent, this, this, parent, the
parent's calls launching every product through the parent's K2.

The matrices: config 5's f32 hierarchy (128^2 p=3, ``bench.py:775-817``:
16 x 16 blocks at p=3, 4 x 4 at p=1 on four meshes) and its A64;
config 4's f32 hierarchy (24^3 p=2 elasticity, ``bench.py:698-772``:
81 x 81 at p=2, 24 x 24 at p=1 on two meshes) and its A64; 3D SIPG
Poisson at p=1 on 32^3 (8 x 8 f32 blocks, 7 to a row); 3D
elasticity on 2^3 elements at p=4/5 in a checkerboard (each bucket of
375, 648, 375 x 648 and 648 x 375 alone) and on 4^3 at p=4, f32 and
f64.  For each: this K2's output bitwise against the parent's (every
dtype) and, for the narrow f32 buckets, against ``block_spmv.emulate``;
against the plain version (1e-5 of max|y| in f32, 1e-12 in f64); CUDA
event ms per apply (median of 30) in the order parent, this, this,
parent; profiler device ms per apply of each; the plain version's and
the BSR product's event ms; the bound (``chip_smoke.k2_bound``); K2's
launch geometry (``chip_smoke.k2_row`` and its lines, then a line
``K2-parent``).  With ``--json``, writes them all.  Exits 1 where this
K2's output differs from the parent's, and raises where it fails a
check of ``k2_row``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parent_wrapper(root: Path):
    """The other checkout's K2 wrapper module (``ops/block_spmv.py``),
    loaded under another name and built from that checkout's source."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "parent_block_spmv", root / "hpdg_tpu_torch" / "ops" / "block_spmv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = root / "hpdg_tpu_torch" / "csrc" / "block_spmv.cu"
    mod._lib = None
    mod.build()
    return mod


def parent_matvec(mod, M, x: dict) -> dict:
    """``blockmatrix.matvec`` through the parent's wrapper and kernel."""
    out = {}
    for (pr, pc) in M.pattern.entries:
        vals = M.values[(pr, pc)]
        out[pr] = mod.launch(vals, x[pc], M.spmv_table((pr, pc), vals.device),
                             out.get(pr))
    return out


def config5(dev):
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.solvers.multigrid import setup_hierarchy
    chain = [hm.structured((16, 16), lower=(-1, -1), upper=(1, 1))]
    while chain[-1].n_elements < 128 * 128:
        chain.append(hm.refine(chain[-1]))
    basis = DGBasis(chain[-1], np.full(chain[-1].n_elements, 3, np.int32))
    A64 = api.laplace(basis, penalty=2.0, dirichlet=True, device=dev)
    A32 = bm.BlockSparseMatrix(
        A64.pattern, A64.dim,
        {k: v.float() for k, v in A64.values.items()}, A64.block_shape)
    data = setup_hierarchy(basis, A32, meshes=chain, dtype=torch.float32)
    return [(f"config 5 level {b.mesh.n_elements}e/p{b.bucket_degrees[0]}",
             M) for b, M in zip(data.bases, data.matrices)][::-1] + [
        ("config 5 A64", A64)]


def config4(dev):
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import assemble_elasticity, build_plan
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.solvers.multigrid import setup_hierarchy
    mc = hm.structured((12, 12, 12))
    mf = hm.refine(mc)
    basis = DGBasis(mf, np.full(mf.n_elements, 2, dtype=np.int32))
    A64 = assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                              dirichlet=True, plan=build_plan(basis),
                              device=dev)
    A32 = bm.BlockSparseMatrix(
        A64.pattern, A64.dim,
        {k: v.float() for k, v in A64.values.items()}, A64.block_shape)
    data = setup_hierarchy(basis, A32, meshes=[mc, mf], dtype=torch.float32)
    return [(f"config 4 level {b.mesh.n_elements}e/p{b.bucket_degrees[0]}",
             M) for b, M in zip(data.bases, data.matrices)][::-1] + [
        ("config 4 A64", A64)]


def poisson3d_p1(dev):
    """3D SIPG Poisson at p=1 on 32^3 (f32, 8 x 8 blocks, 7 to a row:
    the narrow kernel's longer batch)."""
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import assemble_laplace
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    m = hm.structured((32, 32, 32))
    A = assemble_laplace(DGBasis(m, np.ones(m.n_elements, np.int32)),
                         penalty=3.0, dirichlet=True, dtype=torch.float32,
                         device=dev)
    return [("poisson3d 32^3 p=1", A)]


def elasticity_wide(dev):
    """Phase 3b's 2^3 p=4/5 buckets one by one, and 4^3 at p=4."""
    import chip_smoke as cs
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.assemble import assemble_elasticity
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    out = []
    for cells, degrees in (((2, 2, 2), [5, 4, 4, 5, 4, 5, 5, 4]),
                           ((4, 4, 4), [4] * 64)):
        basis = DGBasis(hm.structured(cells),
                        np.asarray(degrees, dtype=np.int32))
        A64 = assemble_elasticity(basis, mu=1.0, lam=1.0, penalty=4.0,
                                  dirichlet=True, device=dev)
        for dtype in (torch.float32, torch.float64):
            A = bm.BlockSparseMatrix(
                A64.pattern, A64.dim,
                {k: v.to(dtype) for k, v in A64.values.items()},
                A64.block_shape)
            for key in sorted(A.pattern.entries):
                br, bc = A.values[key].shape[1:]
                out.append((f"elasticity {cells[0]}^3 bucket {key} "
                            f"{br}x{bc}", cs.one_bucket(A, key)))
    return out


def obstacle_call(dev, wrapper=None, tag: str = "this",
                  n2: int = 128) -> dict:
    """K2's kernels in one traced call of config 5's verified solve, its
    products launched through ``wrapper`` (another checkout's K2 module)
    where one is given."""
    from bench_torch import measure
    from hpdg_tpu_torch import mesh as hm
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    from hpdg_tpu_torch.basis.dgbasis import DGBasis
    from hpdg_tpu_torch.blocks import api
    from hpdg_tpu_torch.solvers.tnnmg import solve_obstacle_verified
    chain = [hm.structured((16, 16), lower=(-1, -1), upper=(1, 1))]
    while chain[-1].n_elements < n2 * n2:
        chain.append(hm.refine(chain[-1]))
    basis = DGBasis(chain[-1], np.full(chain[-1].n_elements, 3, np.int32))
    A64 = api.laplace(basis, penalty=2.0, dirichlet=True, device=dev)
    b64 = api.l2_functional(basis, lambda x: -8.0 + 0.0 * x[..., 0],
                            device=dev)
    lo, up = api.constant_bounds(basis, lower=-0.2, device=dev)

    def call():
        return solve_obstacle_verified(
            A64, b64, basis, lo, up, tol=1e-8, maxiter=40, stall_window=3,
            meshes=chain, n_runs=1, max_outer=30)[1]

    # the bench's window: a first call in the warm-up step, then one
    own = bm.block_spmv
    bm.block_spmv = wrapper or own
    try:
        rows, _, info = measure.traced(call, call)
    finally:
        bm.block_spmv = own
    by_name, total = {}, 0.0
    for r in rows:
        if not r.device:
            continue
        ms = (r.end_ns - r.start_ns) / 1e6
        total += ms
        if measure.K2_KERNEL in r.name:
            t, n = by_name.get(r.name, (0.0, 0))
            by_name[r.name] = (t + ms, n + 1)
    run = info["runs"][0]
    out = dict(device_ms=total, k2={k: dict(ms=t, launches=n)
                                    for k, (t, n) in by_name.items()},
               k2_ms=sum(t for t, _ in by_name.values()),
               k2_launches=sum(n for _, n in by_name.values()),
               tnnmg_iterations=run["tnnmg_iterations"],
               outers=len(run["steps"]), steps=sum(run["steps"]),
               verified=run["verified"])
    print(f"obstacle call ({tag}): device {total:.1f} ms; K2 "
          f"{out['k2_ms']:.2f} ms in {out['k2_launches']} launches; {out['tnnmg_iterations']} "
          f"TNNMG iterations, {out['outers']} outers, {out['steps']} steps, "
          f"verified {out['verified']}", flush=True)
    for k, v in sorted(out["k2"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"obstacle call ({tag}) K2 {k[:100]}: {v['ms']:.2f} ms in "
              f"{v['launches']} launches", flush=True)
    return out


def row(tag, M, wrapper, dev, gen) -> dict:
    """``chip_smoke.k2_row`` of M (this K2: its checks, times, bound,
    plain and library times), and with the parent's ``wrapper`` its
    output bitwise against this K2's and its event and device ms, the
    event times taken in the order parent, this, this, parent."""
    import chip_smoke as cs
    from hpdg_tpu_torch.linalg import blockmatrix as bm
    dtype = next(iter(M.values.values())).dtype
    x = {p: torch.randn((n, M.bc(p)), generator=gen, dtype=dtype,
                        device=dev)
         for p, n in M.pattern.col_sizes.items()}
    if wrapper is None:
        return cs.k2_row(tag, M, gen, plain_profile=False, x=x)
    parent = lambda: parent_matvec(wrapper, M, x)  # noqa: E731
    ms_parent = [float(np.median(cs.event_times(parent, 30)))]
    r = cs.k2_row(tag, M, gen, plain_profile=False, x=x)
    r["ms_this"] = [r["ms"], float(np.median(cs.event_times(
        lambda: bm.matvec(M, x), 30)))]
    r["ms_parent"] = ms_parent + [float(np.median(cs.event_times(parent,
                                                               30)))]
    r["device_ms_parent"] = cs.k2_profile(parent,
                                          len(M.values))["device_ms"]
    yk, yq = bm.matvec(M, x), parent()
    torch.cuda.synchronize()
    r["bitwise_parent"] = all(torch.equal(yq[p], yk[p]) for p in yk)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    print(f"K2-parent {tag} {r['dtype'][6:]}: events ms this "
          f"{[round(v, 4) for v in r['ms_this']]} parent "
          f"{[round(v, 4) for v in r['ms_parent']]}; device ms this "
          f"{fmt(r['device_ms'])} parent {fmt(r['device_ms_parent'])}; "
          f"bitwise equal {r['bitwise_parent']}", flush=True)
    return r


GROUPS = dict(config5=config5, config4=config4, poisson3d_p1=poisson3d_p1,
              elasticity_wide=elasticity_wide)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout's root")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="the matrices, of " + ", ".join(GROUPS))
    ap.add_argument("--obstacle-call", action="store_true",
                    help="K2 by kernel in one traced call of config 5")
    ap.add_argument("--json", type=Path, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_rows: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from hpdg_tpu_torch.ops import block_spmv
    card = cs.smi()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    block_spmv.build()
    parent = parent_wrapper(args.parent) if args.parent else None
    gen = torch.Generator(device=dev).manual_seed(2020)
    rows, bad = [], []
    for build in (GROUPS[g] for g in args.groups.split(",") if g):
        t0 = time.perf_counter()
        mats = build(dev)
        torch.cuda.synchronize()
        print(f"{build.__name__}: built in {time.perf_counter() - t0:.2f} s",
              flush=True)
        for tag, M in mats:
            r = row(tag, M, parent, dev, gen)
            rows.append(r)
            if not r.get("bitwise_parent", True):
                bad.append(tag)
        del mats
        torch.cuda.empty_cache()
    call = None
    if args.obstacle_call:  # parent, this, this, parent where both run
        order = ("parent", "this", "this", "parent") if parent else ("this",)
        call = {k: [] for k in set(order)}
        for k in order:
            call[k].append(obstacle_call(dev, parent if k == "parent" else None,
                                         k))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(card=card, rows=rows,
                                             obstacle_call=call)))
    print(f"k2_rows: {len(rows)} rows, {len(bad)} failed {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Unstructured (non-lattice) hex import + continuous Q_k solve.

Port of ``examples/unstructured_cg.py``.  Builds an annulus ring of
trapezoidal cells (CYCLIC connectivity that no lattice ordering can
express), imports it through ``geometry.from_cell_vertices`` (face
matching and BFS parametric frames), then solves Poisson on it twice:

1. in the continuous Gauss-Lobatto Q_k space (``basis.cgbasis`` +
   ``assemble.cg``: matrix-free gather -> sum-factorized bulk apply ->
   scatter, a plain CG iteration), and
2. in the DG-Q_k SIPG space (the usual pipeline, MG-preconditioned CG),

and reports both solutions' agreement at the shared GL nodes.

    python -m hpdg_tpu_torch.examples.unstructured_cg [--nseg 16] [--k 2] \
        [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hpdg_tpu_torch import device as dev
from hpdg_tpu_torch.assemble.cg import cg_l2_functional, cg_laplace_operator
from hpdg_tpu_torch.basis.cgbasis import cg_basis
from hpdg_tpu_torch.basis.dgbasis import DGBasis
from hpdg_tpu_torch.blocks import api
from hpdg_tpu_torch.linalg import blockmatrix as bm, blockvector as bv
from hpdg_tpu_torch.mesh.geometry import from_cell_vertices
from hpdg_tpu_torch.utils import parse_cli


def annulus(nseg=16, r0=1.0, r1=2.0):
    """Points and hex cells (VTK numbering) of an extruded annulus ring
    of ``nseg`` trapezoids, one layer thick."""
    th = np.linspace(0.0, 2 * np.pi, nseg, endpoint=False)
    inner = np.stack([r0 * np.cos(th), r0 * np.sin(th)], axis=-1)
    outer = np.stack([r1 * np.cos(th), r1 * np.sin(th)], axis=-1)
    ring = np.concatenate([inner, outer])
    pts = np.concatenate([np.concatenate(
        [ring, np.full((2 * nseg, 1), z)], axis=1) for z in (0.0, 1.0)])
    cells = []
    up = 2 * nseg
    for i in range(nseg):
        j = (i + 1) % nseg
        base = [i, nseg + i, nseg + j, j]
        cells.append(base + [v + up for v in base])
    return pts, np.asarray(cells)


def cg_solve(op, b: torch.Tensor, tol: float = 1e-10, maxiter: int = 400):
    """Plain conjugate gradients on a flat vector; returns ``(x,
    iterations, relative residual)``."""
    x = torch.zeros_like(b)
    r = b - op(x)
    pdir = r
    rs = torch.dot(r, r)
    nb = float(torch.linalg.norm(b))
    for it in range(maxiter):
        Ap = op(pdir)
        a = rs / torch.dot(pdir, Ap)
        x = x + a * pdir
        r = r - a * Ap
        rs2 = torch.dot(r, r)
        if float(torch.sqrt(rs2)) < tol * nb:
            break
        pdir = r + (rs2 / rs) * pdir
        rs = rs2
    return x, it + 1, float(torch.sqrt(rs2)) / nb


def run(nseg: int = 16, k: int = 2, device=None) -> dict:
    """Both solves; returns the mesh, the CG and DG results and the
    nodal ``agreement`` max|u_cg - u_dg| / max|u_dg|."""
    device = dev.resolve(device)
    pts, cells = annulus(nseg)
    m = from_cell_vertices(pts, cells)
    print(f"imported annulus ring: {m.n_elements} hexes, "
          f"{len(m.faces)} interior faces (cyclic), "
          f"{len(m.bfaces)} boundary faces, "
          f"{'Q1 corners' if m.corners is not None else 'affine'}")

    f = lambda x: torch.exp(-((x[..., 0] - 1.5) ** 2  # noqa: E731
                              + x[..., 1] ** 2) * 2.0)

    # --- continuous Q_k solve (matrix-free CG iteration) ---
    cg = cg_basis(m, k, device=device)
    print(f"CG-Q{k} space: {cg.n_dofs} dofs, per-entity counts "
          f"{np.bincount(cg.entity_dim).tolist()}")
    op = cg_laplace_operator(cg, dirichlet=True)
    b = cg_l2_functional(cg, f, dirichlet=True)
    x, its, rel = cg_solve(op, b)
    print(f"CG solve: {its} iterations, rel residual {rel:.2e}")

    # --- DG-Q_k SIPG solve on the same mesh ---
    basis = DGBasis(m, np.full(m.n_elements, k))
    A = api.laplace(basis, penalty=6.0, dirichlet=True, device=device)
    bd = api.l2_functional(basis, f, device=device)
    xd, info = api.solve_linear(basis, A, bd, tol=1e-10, maxiter=200,
                                method="cg+mg")
    rd = float(bv.norm(bv.sub(bd, bm.matvec(A, xd))))
    print(f"DG solve: {info['iterations']} PCG iterations, rel residual "
          f"{rd / float(bv.norm(bd)):.2e}")

    # --- agreement at the shared GL nodes ---
    u_cg_local = cg.gather(x).cpu().numpy()        # (n, (k+1)^dim)
    u_dg = xd[k].cpu().numpy()
    agree = np.abs(u_cg_local - u_dg).max() / max(np.abs(u_dg).max(), 1e-30)
    print(f"CG vs DG nodal agreement: max |u_cg - u_dg| / max|u_dg| = "
          f"{agree:.2e} (methods differ at the discretization "
          "error scale, as expected)")
    return dict(mesh=m, cg=cg, x_cg=x, cg_iterations=its, cg_residual=rel,
                basis=basis, x_dg=xd, dg_info=info, agreement=agree)


def main(argv=None):
    cfg = parse_cli(argv, help_text=__doc__)
    return run(cfg.get_path("nseg", 16), cfg.get_path("k", 2),
               cfg.get_path("device"))


if __name__ == "__main__":
    main()

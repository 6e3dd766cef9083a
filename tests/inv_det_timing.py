"""Host time of the curved elasticity geometry tables with the cofactor
inverse ``mesh.geometry.inv_det`` against LAPACK's ``np.linalg.inv`` and
``np.linalg.det``, on the mesh of ``chip_smoke.py`` phase 16b (13b's
quarter hollow cylinder on n^3, p=2): ``pullback_factors`` at the bulk
quadrature points, and the whole ``elasticity_geom_tables``.  Prints
the best of ``reps`` host times for each route and the largest relative
difference of their tables.  Imports only the port (no JAX), so it runs
on any host with numpy and torch.

    python tests/inv_det_timing.py [n] [reps]
"""

import sys
import time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from hpdg_tpu_torch import mesh as hm  # noqa: E402
from hpdg_tpu_torch.basis import tensor  # noqa: E402
from hpdg_tpu_torch.basis.dgbasis import DGBasis  # noqa: E402
from hpdg_tpu_torch.examples.meshes import cylinder_quarter  # noqa: E402
from hpdg_tpu_torch.matrixfree.elasticity import (  # noqa: E402
    elasticity_geom_tables)
from hpdg_tpu_torch.mesh import geometry as geo  # noqa: E402

ROUTES = {"cofactor": geo.inv_det,
          "lapack": lambda J: (np.linalg.inv(J), np.linalg.det(J))}


def quarter_cylinder(n: int):
    """13b's mesh: ``isoparametric`` on (n/4)^3, refined twice, its
    corners put in C-lattice order on the n^3 lattice."""
    mf = geo.isoparametric(hm.structured((n // 4,) * 3), cylinder_quarter)
    for _ in range(2):
        mf = hm.refine(mf)
    cells = (n,) * 3
    ic = np.rint(mf.lower * n).astype(np.int64)
    order = np.argsort(np.ravel_multi_index(ic.T, cells), kind="stable")
    return replace(hm.structured(cells), corners=mf.corners[order])


def best(fn, reps):
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        val = fn()
        out.append(time.perf_counter() - t)
    return min(out), val


def flat(tables):
    bulk = [a for v in tables["bulk"].values() for a in v]
    rest = [a for g in tables["face"] + tables["bnd"] for a in g]
    return [np.asarray(a) for a in bulk + rest]


def main(n: int = 24, reps: int = 2):
    p = 2
    gm = quarter_cylinder(n)
    basis = DGBasis(gm, np.full(gm.n_elements, p))
    vt = tensor.volume_tables(p, 3, p + 2)
    elems = np.arange(gm.n_elements)
    xpq = (gm.lower[:, None, :]
           + vt["points"][None, :, :] * gm.extent[:, None, :])
    got = {}
    for name, route in ROUTES.items():
        geo.inv_det = route
        try:
            t_pb, _ = best(lambda: geo.pullback_factors(gm, elems, xpq), reps)
            t_tab, tab = best(lambda: elasticity_geom_tables(
                basis, penalty=4.0, dirichlet=True), reps)
        finally:
            geo.inv_det = ROUTES["cofactor"]
        got[name] = flat(tab)
        print(f"{name}: pullback_factors at {xpq.shape[0] * xpq.shape[1]} "
              f"bulk points {t_pb:.3f} s; elasticity_geom_tables "
              f"{t_tab:.3f} s (best of {reps})", flush=True)
    diff = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
               for a, b in zip(got["cofactor"], got["lapack"]))
    print(f"n={n} p={p}: {gm.n_elements} elements; tables differ by "
          f"{diff:.3e} of their max", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))

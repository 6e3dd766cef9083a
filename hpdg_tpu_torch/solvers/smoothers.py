"""Block-Jacobi smoothing and preconditioning.

Port of the block-Jacobi part of ``hpdg_tpu.solvers.smoothers``: the
inverses of all diagonal blocks are precomputed once per bucket with a
batched ``torch.linalg.inv`` on the blocks' device, in their dtype (the
reference inverts on the host only because f64 LU did not compile on
every TPU generation).  The colored, lexicographic and l1 smoothers
wait for ROADMAP queue 1, item 12; Chebyshev for item 10.
"""

from __future__ import annotations

import torch

from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.linalg.blockmatrix import (BlockSparseMatrix,
                                               extract_diagonal, matvec)


def inverse_diagonal_blocks(A) -> dict:
    """p -> [n_p, bs, bs] inverses of the diagonal blocks of ``A``: a
    ``BlockSparseMatrix``, or its diagonal blocks ``{p: [n_p, bs, bs]}``
    as ``matrixfree.sipg_diagonal_blocks`` returns them."""
    D = extract_diagonal(A) if isinstance(A, BlockSparseMatrix) else A
    return {p: torch.linalg.inv(d) for p, d in D.items()}


def apply_blockdiag(Dinv: dict, x: dict) -> dict:
    return {p: torch.bmm(Dinv[p], x[p].unsqueeze(-1)).squeeze(-1)
            for p in x}


def block_jacobi_preconditioner(A):
    """r -> Dinv r (for PCG); ``A`` as for
    :func:`inverse_diagonal_blocks`."""
    Dinv = inverse_diagonal_blocks(A)
    return lambda r: apply_blockdiag(Dinv, r)


def block_jacobi_step(A: BlockSparseMatrix, omega: float = 1.0):
    """Damped block-Jacobi iteration step: x += omega * Dinv (b - A x)."""
    Dinv = inverse_diagonal_blocks(A)

    def step(x, b):
        r = bv.sub(b, matvec(A, x))
        return bv.axpy(omega, apply_blockdiag(Dinv, r), x)

    return step

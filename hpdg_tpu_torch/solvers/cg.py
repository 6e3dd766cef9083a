"""Preconditioned conjugate gradients on bucketed block vectors.

Port of ``hpdg_tpu.solvers.cg.pcg``.  The reference runs one
``lax.while_loop``; here the stopping rule lives on the device too: the
iteration count ``k`` and the residual history stay in device tensors,
and an ``active = (k < maxiter) & (residuals[k] > target)`` flag masks
every update, so an iteration past the stop changes nothing (a NaN
residual stops the loop, as in the reference).  One body serves three
contexts (``solvers.graphs``):

* on a card, a block of :data:`PCG_BLOCK` iterations is captured once
  per call and replayed, the host reading the flag between replays (the
  capture's warm-up is the first block);
* on CPU tensors the same blocks run eagerly;
* under a caller's own capture all ``maxiter`` iterations are recorded
  into the caller's graph with no host read, as the reference's
  ``while_loop`` runs inside a jitted caller.

The contract is the reference's: the history has length
``maxiter + 1``, padded with the final value, and the loop stops at the
first ``k`` with ``residuals[k] <= target``.  ``loop_solve`` drives an
iteration step (a multigrid cycle) with the reference's energy-norm
stopping rule, the step and the norm captured once per call.
"""

from __future__ import annotations

import torch

from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.solvers.graphs import DeviceLoop, capturing

# iterations per captured block on a card: the host reads the loop's
# flag once per block, and a block runs at most PCG_BLOCK - 1 frozen
# iterations past the stop
PCG_BLOCK = 8


def _at(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``v[k]`` for a device index ``k`` (no host read)."""
    return v.gather(0, k.reshape(1)).reshape(())


def pcg(matvec_fn, b: dict, x0: dict | None = None, precond=None,
        tol: float = 1e-8, maxiter: int = 500, rtol: bool = True):
    """Solve A x = b with (preconditioned) CG.

    ``matvec_fn`` / ``precond``: callables dict -> dict that neither read
    the host nor copy host memory to the card (a card captures them).
    Returns ``(x, info)`` with ``info = {"iterations", "residuals"}``
    where ``residuals[k] = ||b - A x_k||_2`` as tracked by the recursion
    (a float64 CPU tensor of length ``maxiter + 1``, padded with the
    final value after convergence).  Called under a caller's CUDA graph
    capture, ``iterations`` and ``residuals`` are device tensors that
    each replay of the caller's graph rewrites.
    """
    M = precond or (lambda r: r)
    x = bv.zeros_like(b) if x0 is None else x0
    r = bv.sub(b, matvec_fn(x))
    z = M(r)
    rz = bv.dot(r, z)
    nb = bv.norm(b).double()
    device = nb.device
    target = tol * torch.where(nb > 0, nb, 1.0) if rtol \
        else torch.full_like(nb, tol)
    # one spare slot: iteration k writes residuals[k + 1] even when frozen
    hist = torch.full((maxiter + 2,), torch.inf, dtype=torch.float64,
                      device=device)
    hist[0] = bv.norm(r)
    k = torch.zeros((), dtype=torch.long, device=device)

    def active(k, hist):
        return (k < maxiter) & (_at(hist, k) > target)

    def body(state):
        x, r, z, p, rz, k, hist = state
        on = active(k, hist)
        Ap = matvec_fn(p)
        alpha = rz / bv.dot(p, Ap)
        x_n = bv.axpy(alpha, p, x)
        r_n = bv.axpy(-alpha, Ap, r)
        z_n = M(r_n)
        rz_n = bv.dot(r_n, z_n)
        p_n = bv.axpy(rz_n / rz, p, z_n)
        nr = torch.where(on, bv.norm(r_n).double(), _at(hist, k + 1))
        hist_n = hist.index_copy(0, (k + 1).reshape(1), nr.reshape(1))
        k_n = k + on.long()

        def keep(new, old):
            return {q: torch.where(on, new[q], old[q]) for q in old}

        return ((keep(x_n, x), keep(r_n, r), keep(z_n, z), keep(p_n, p),
                 torch.where(on, rz_n, rz), k_n, hist_n),
                active(k_n, hist_n))

    state = (x, r, z, z, rz, k, hist)
    if capturing(device):
        loop = DeviceLoop(body, state)
        x, _, _, _, _, k, hist = loop.repeat(maxiter)
        hist = hist[:maxiter + 1]
        pad = torch.arange(maxiter + 1, device=device) > k
        return x, {"iterations": k,
                   "residuals": torch.where(pad, _at(hist, k), hist)}
    loop = DeviceLoop(body, state, block=PCG_BLOCK)
    on = active(k, hist)
    while bool(on):  # the block's one device -> host read
        on = loop.step()
    x, _, _, _, _, k, hist = loop.state
    k = int(k)
    hist = hist[:maxiter + 1].cpu()
    hist[k + 1:] = hist[k]
    return x, {"iterations": k, "residuals": hist}


def loop_solve(step_fn, x0: dict, b: dict, matvec_fn=None, tol: float = 1e-8,
               maxiter: int = 100, norm_fn=None):
    """dune-solvers ``LoopSolver`` analog: iterate ``x_{k+1} =
    step_fn(x_k, b)`` until the norm of the correction drops below
    ``tol``.  ``norm_fn(correction)`` defaults to the energy norm
    ``sqrt(|c^T A c|)`` if ``matvec_fn`` is given, else the 2-norm.  The
    step and the norm of its correction are one body over a static
    iterate, captured once per call on a card and replayed per step;
    the host reads the norm after every step, as the reference does.
    Returns ``(x, info)`` with ``info = {"iterations", "history"}``."""
    if norm_fn is None:
        if matvec_fn is not None:
            norm_fn = lambda c: torch.sqrt(torch.abs(  # noqa: E731
                bv.dot(c, matvec_fn(c))))
        else:
            norm_fn = bv.norm

    def body(x):
        xn = step_fn(x, b)
        return xn, norm_fn(bv.sub(xn, x))

    loop = DeviceLoop(body, x0)
    history = []
    for _ in range(maxiter):
        err = float(loop.step())  # the step's one device -> host read
        history.append(err)
        if err < tol:
            break
    return loop.state, {"iterations": len(history), "history": history}

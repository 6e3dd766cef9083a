"""Mixed-precision iterative refinement around f32 multigrid chains.

Keeps the contract of ``hpdg_tpu.solvers.refine.onchip_refinement_solve``
on a card with native f64.  Per step:

1. the anchored residual ``r = b - A x`` in f64 on the device;
2. its norm comes to the host (one ``.item()``: the step's barrier) and
   enters the history;
3. if ``||r|| <= tol ||b||`` the loop stops;
4. otherwise ``chain_k`` f32 V-cycles from zero solve ``A c = r/||r||``;
5. ``x += ||r|| c`` in f64.

One f64 residual on the host verifies the downloaded answer at the end.
The TPU's double-f32 pairs, exact-split residuals, int16 download codec
and fused while-loop are not needed here (ROADMAP "Not ported").
"""

from __future__ import annotations

import time

import torch

from hpdg_tpu_torch.linalg import blockvector as bv


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def refinement_solve(step, residual, b64: dict, *, chain_k: int = 2,
                     tol: float = 1e-8, max_steps: int = 10,
                     host_residual=None):
    """Solve A x = b to a VERIFIED f64-relative ``tol``.

    step:          one V-cycle ``step(x, b) -> x`` on f32 bucket dicts
    residual:      ``x64 -> b - A x64`` on f64 bucket dicts, on the
                   device of ``b64``
    b64:           f64 rhs bucket dict (on the solve's device)
    host_residual: ``x64 -> r64`` on CPU f64 bucket dicts for the final
                   verification; without it ``verified`` stays False and
                   ``rel_residual`` is the last anchored value

    Returns ``(x64, info)``: ``history`` (anchored relative residuals,
    one per step), ``steps``, ``cycles`` (V-cycles run), ``seconds``
    (loop + download + verification), ``seconds_loop``, ``verified``,
    ``rel_residual`` and ``runs`` (this run's seconds and residual, the
    reference's per-run record).
    """
    keys = sorted(b64)
    device = b64[keys[0]].device
    nb = float(bv.norm(b64))
    if host_residual is not None:
        b_host = {k: b64[k].detach().cpu() for k in keys}
        nb_host = float(bv.norm(b_host))

    _sync(device)
    t0 = time.perf_counter()
    x64 = {k: torch.zeros_like(b64[k]) for k in keys}
    hist, steps, cycles = [], 0, 0
    while steps < max_steps:
        r = residual(x64)
        nr = float(bv.norm(r))  # the step's one device -> host sync
        hist.append(nr / nb)
        steps += 1
        if nr <= tol * nb:
            break
        rhs = {k: (r[k] / nr).to(torch.float32) for k in keys}
        c = bv.zeros_like(rhs)
        for _ in range(chain_k):
            c = step(c, rhs)
        cycles += chain_k
        x64 = {k: x64[k] + nr * c[k].to(torch.float64) for k in keys}
    _sync(device)
    t_loop = time.perf_counter() - t0
    rel = hist[-1]
    verified = False
    if host_residual is not None:
        x_host = {k: x64[k].detach().cpu() for k in keys}
        rel = float(bv.norm(host_residual(x_host))) / nb_host
        verified = rel <= tol
    seconds = time.perf_counter() - t0
    return x64, {"history": hist, "steps": steps, "cycles": cycles,
                 "seconds": seconds, "seconds_loop": t_loop,
                 "verified": verified, "rel_residual": rel,
                 "runs": [{"seconds": seconds, "rel_residual": rel}]}

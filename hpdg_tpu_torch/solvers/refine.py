"""Mixed-precision iterative refinement around f32 multigrid chains.

Keeps the contract of ``hpdg_tpu.solvers.refine.onchip_refinement_solve``
on a card with native f64.  Per step:

1. the anchored residual ``r = b - A x`` in f64 on the device;
2. its norm comes to the host (one read: the step's barrier) and enters
   the history;
3. if ``||r|| <= tol ||b||`` the loop stops;
4. otherwise ``chain_k`` f32 V-cycles from zero solve ``A c = r/||r||``;
5. ``x += ||r|| c`` in f64.

One f64 residual on the host verifies the downloaded answer at the end.

``fused=True`` is the reference's one-program mode.  On a card the step
is captured once as two CUDA graphs over static device buffers and
replayed: the *anchor* graph (1-2) and the *chain* graph (4-5).  The
host reads ``||r||`` between the two replays and replays the chain only
while the anchor misses ``tol``, where the reference's ``lax.cond``
skips it.  A step that cannot be captured (a host sync, a pageable copy)
raises; nothing falls back to the eager loop.  On CPU tensors the same
two bodies run eagerly.  The TPU's double-f32 pairs, exact-split
residuals and int16 download codec are not needed here (ROADMAP "Not
ported").
"""

from __future__ import annotations

import time

import torch

from hpdg_tpu_torch.linalg import blockvector as bv
from hpdg_tpu_torch.solvers.graphs import capture_graph


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def refinement_solve(step, residual, b64: dict, *, chain_k: int = 2,
                     tol: float = 1e-8, max_steps: int = 10,
                     host_residual=None, n_runs: int = 1,
                     fused: bool = False):
    """Solve A x = b to a VERIFIED f64-relative ``tol``.

    step:          one V-cycle ``step(x, b) -> x`` on f32 bucket dicts
    residual:      ``x64 -> b - A x64`` on f64 bucket dicts, on the
                   device of ``b64``
    b64:           f64 rhs bucket dict (on the solve's device)
    host_residual: ``x64 -> r64`` on CPU f64 bucket dicts for the final
                   verification; without it ``verified`` stays False and
                   ``rel_residual`` is the last anchored value
    n_runs:        solves from zero; the best is returned (a verified run
                   before an unverified one, then the faster)
    fused:         the step as two replayed CUDA graphs (module
                   docstring), captured once per call

    Returns ``(x64, info)`` of the best run: ``history`` (anchored
    relative residuals, one per step), ``steps``, ``cycles`` (V-cycles
    run), ``seconds`` (loop + download + verification), ``seconds_loop``,
    ``seconds_fetch`` (the f64 x to the host), ``seconds_verify``,
    ``verified``, ``rel_residual`` and ``runs`` (per run its seconds,
    residual, steps and history).  ``fused=True`` adds
    ``seconds_capture`` (the warm-up and capture, outside ``seconds``)
    and ``replays`` (anchor and chain replays over all runs; 0 on the
    CPU).
    """
    keys = sorted(b64)
    device = b64[keys[0]].device
    nb = float(bv.norm(b64))
    nb_host = None
    if host_residual is not None:
        nb_host = float(bv.norm({k: b64[k].detach().cpu() for k in keys}))

    if fused:
        x_static = {k: torch.zeros_like(b64[k]) for k in keys}
        state = {}

        def anchor():
            state["r"] = residual(x_static)
            state["nr"] = bv.norm(state["r"])

        def chain():
            r, nr = state["r"], state["nr"]
            inv = 1.0 / nr
            rhs = {k: (r[k] * inv).to(torch.float32) for k in keys}
            c = bv.zeros_like(rhs)
            for _ in range(chain_k):
                c = step(c, rhs)
            for k in keys:
                x_static[k].add_(nr * c[k].to(torch.float64))

        t0 = time.perf_counter()
        if device.type == "cuda":
            g_anchor, _ = capture_graph(anchor, device)
            g_anchor.replay()  # the chain's warm-up reads a real residual
            g_chain, _ = capture_graph(chain, device, pool=g_anchor.pool())
            anchor, chain = g_anchor.replay, g_chain.replay
        t_capture = time.perf_counter() - t0
        replays = {"anchor": 0, "chain": 0}

    def one_run():
        _sync(device)
        t0 = time.perf_counter()
        hist, cycles = [], 0
        if fused:
            for v in x_static.values():
                v.zero_()
            while len(hist) < max_steps:
                anchor()
                nr = float(state["nr"])  # the step's one device -> host read
                hist.append(nr / nb)
                if nr <= tol * nb:
                    break
                chain()
                cycles += chain_k
            x64 = x_static
            if device.type == "cuda":
                replays["anchor"] += len(hist)
                replays["chain"] += cycles // chain_k
        else:
            x64 = {k: torch.zeros_like(b64[k]) for k in keys}
            while len(hist) < max_steps:
                r = residual(x64)
                nr = float(bv.norm(r))  # the step's one device -> host sync
                hist.append(nr / nb)
                if nr <= tol * nb:
                    break
                # times the reciprocal, as the reference's ``refstep``
                # scales (hpdg_tpu/solvers/refine.py:255-256) and the
                # fused chain does (a CUDA tensor divided by a host
                # scalar is that product too), so both routes round alike
                inv = 1.0 / nr
                rhs = {k: (r[k] * inv).to(torch.float32) for k in keys}
                c = bv.zeros_like(rhs)
                for _ in range(chain_k):
                    c = step(c, rhs)
                cycles += chain_k
                x64 = {k: x64[k] + nr * c[k].to(torch.float64) for k in keys}
        _sync(device)
        t_loop = time.perf_counter() - t0
        x_host = {k: x64[k].detach().cpu() for k in keys}
        t_fetch = time.perf_counter() - t0 - t_loop
        rel, verified, t_verify = hist[-1], False, 0.0
        if host_residual is not None:
            t_v0 = time.perf_counter()
            rel = float(bv.norm(host_residual(x_host))) / nb_host
            verified = rel <= tol
            t_verify = time.perf_counter() - t_v0
        seconds = time.perf_counter() - t0
        if fused:  # the static buffer is rewritten by the next run
            x64 = {k: v.clone() for k, v in x64.items()}
        return x64, {"history": hist, "steps": len(hist), "cycles": cycles,
                     "seconds": seconds, "seconds_loop": t_loop,
                     "seconds_fetch": t_fetch, "seconds_verify": t_verify,
                     "verified": verified, "rel_residual": rel}

    best_x, best = one_run()
    runs = [best]
    for _ in range(n_runs - 1):
        x64, info = one_run()
        runs.append(info)
        met_new = info["rel_residual"] <= tol
        met_old = best["rel_residual"] <= tol
        if (met_new and not met_old) or (met_new == met_old
                                         and info["seconds"]
                                         < best["seconds"]):
            best_x, best = x64, info
    best = dict(best, runs=[{"seconds": i["seconds"],
                             "rel_residual": i["rel_residual"],
                             "steps": i["steps"], "history": i["history"]}
                            for i in runs])
    if fused:
        best.update(seconds_capture=t_capture, replays=replays)
    return best_x, best

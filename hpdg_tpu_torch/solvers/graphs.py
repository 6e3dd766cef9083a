"""CUDA graphs of the reference's device-resident loops.

The reference runs its solver loops as single XLA programs: a
``lax.fori_loop`` of a fixed count, or a ``lax.while_loop`` whose stop
depends on the data.  The port runs such a loop as a CUDA graph over
static state, replayed on the card:

* :class:`DeviceLoop` holds the loop's state in static device buffers.
  Its body ``body(state) -> (new_state, out)`` reads the state, and
  :class:`DeviceLoop` copies ``new_state`` back into the buffers only
  after the body has returned, so no read sees a half-written state.
* **Fixed count** (``fori_loop``): :meth:`DeviceLoop.repeat` replays one
  iteration ``n`` times with no host read in between.
* **Data-dependent stop** (``while_loop``): :meth:`DeviceLoop.step` runs
  a block of ``block`` iterations; the caller reads one device flag from
  ``out`` between blocks.  The body must freeze the state once the
  loop's condition fails, so a block may run past the stop.

On a card the first block runs eagerly on a side stream (the warm-up
builds every lazily built table and library handle, which capture
forbids) and counts as the loop's first block; then the block is
captured once, into one graph and one memory pool per loop, and every
later block replays it.  A body that cannot be captured (a host read, a
pageable host-to-device copy) raises: nothing falls back to the eager
loop.  On CPU tensors, inside :func:`eager_loops` and under a caller's
own capture (where the loop's iterations are recorded into the caller's
graph) the same body runs eagerly on the same static buffers.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

# what every DeviceLoop of the process did on a card: graphs captured,
# replays, iterations replayed, and the seconds of warm-up and capture
# (instrumentation, read and reset by callers like a kernel's launches)
counts = {"captures": 0, "replays": 0, "iterations": 0,
          "capture_seconds": 0.0}

_EAGER = contextvars.ContextVar("hpdg_eager_loops", default=False)


def reset_counts():
    """Sets every entry of :data:`counts` to 0."""
    for k in counts:
        counts[k] = 0.0 if k == "capture_seconds" else 0


@contextlib.contextmanager
def eager_loops():
    """Inside this context every :class:`DeviceLoop` created on a card
    runs its body eagerly, launch by launch (the comparison route)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def capturing(device) -> bool:
    """Whether work on ``device`` is being recorded into a caller's CUDA
    graph (the current stream is capturing)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _capture(fn, device, pool=None):
    """``fn()`` once eagerly on a side stream, then once under capture:
    ``(graph, out, warm)`` with ``out`` the captured call's result (every
    replay rewrites it) and ``warm`` the eager call's."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out, warm


def capture_graph(fn, device, pool=None):
    """Capture ``fn()`` into a ``torch.cuda.CUDAGraph`` on ``device``.

    ``fn`` runs once eagerly on a side stream first (the warm-up builds
    every lazily built device table and library handle, which capture
    forbids), then once under capture.  Returns ``(graph, out)``: ``out``
    is what the captured call returned, tensors that every replay
    rewrites in place.  Raises where ``fn`` cannot be captured.
    """
    graph, out, _ = _capture(fn, device, pool)
    return graph, out


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    raise TypeError(f"loop state holds a {type(tree).__name__}, not a "
                    f"tensor")


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return type(tree)(_clone(v) for v in tree)


class DeviceLoop:
    """A loop over static state: ``state = body(state)[0]``, block by
    block (module docstring).

    ``state`` is a tensor or a (nested) tuple, list or dict of tensors;
    it is cloned into the loop's static buffers (:attr:`state`).  On a
    card the loop captures at its first :meth:`step` unless it was
    created inside :func:`eager_loops` or under a caller's capture
    (:attr:`nested`)."""

    def __init__(self, body, state, block: int = 1):
        self.body, self.block = body, int(block)
        if self.block < 1:
            raise ValueError(f"a block holds at least one iteration, got "
                             f"{block}")
        self.device = _leaves(state)[0].device
        self.nested = capturing(self.device)
        self.capture = (self.device.type == "cuda" and not self.nested
                        and not _EAGER.get())
        self.state = _clone(state)
        self._static = _leaves(self.state)
        self.graph = self.out = None

    def _assign(self, new):
        """Copies ``new`` (the body's new state) into the static buffers
        after the body has read all of the old state; a new leaf that IS
        another static buffer is copied first."""
        new = _leaves(new)
        if len(new) != len(self._static):
            raise ValueError("the body changed the structure of the loop "
                             "state")
        ids = {id(t): i for i, t in enumerate(self._static)}
        new = [t.clone() if ids.get(id(t), i) != i else t
               for i, t in enumerate(new)]
        for dst, src in zip(self._static, new):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"the body returned a {src.dtype} "
                                 f"{tuple(src.shape)} leaf for a {dst.dtype} "
                                 f"{tuple(dst.shape)} one")
            if src is not dst:
                dst.copy_(src)

    def _run_block(self):
        out = None
        for _ in range(self.block):
            new, out = self.body(self.state)
            self._assign(new)
        return out

    def step(self):
        """One block of iterations; returns the last body's ``out`` (on a
        card the next replay rewrites it)."""
        if not self.capture:
            return self._run_block()
        if self.graph is None:
            t0 = time.perf_counter()
            self.graph, self.out, warm = _capture(self._run_block,
                                                  self.device)
            counts["captures"] += 1
            counts["capture_seconds"] += time.perf_counter() - t0
            return warm
        self.graph.replay()
        counts["replays"] += 1
        counts["iterations"] += self.block
        return self.out

    def repeat(self, n: int):
        """``n`` blocks with no host read in between; returns the
        state."""
        for _ in range(n):
            self.step()
        return self.state


def repeat(body, state, n: int):
    """The reference's ``fori_loop``: ``n`` iterations of ``state =
    body(state)`` as a :class:`DeviceLoop` (one iteration captured,
    replayed ``n - 1`` times on a card).  Returns the final state, in
    buffers of its own."""
    return DeviceLoop(lambda s: (body(s), None), state).repeat(n)

"""Wall-clock timers that block correctly around asynchronous dispatch.

CUDA work is asynchronous: ``out = fn(x)`` returns as soon as the kernels
are *enqueued*, so ``perf_counter()`` around the call measures launch
latency, not compute.  Every timer here therefore takes the dispatch
**output** and synchronizes the CUDA device of every tensor in it before
reading the clock — the only honest way to attribute device time to a
dispatch site.  CPU tensors are complete when they are returned, so they
need no wait.

Compile-safety: inside ``torch.compile`` tracing there is nothing to
synchronize on (and timing a trace would be meaningless); ``block_ready``
checks ``torch.compiler.is_compiling()`` and skips, returning False.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["block_ready", "device_timer", "time_dispatch"]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def block_ready(out) -> bool:
    """Synchronize the CUDA device of every tensor in ``out`` (a tensor or a
    nested tuple / list / dict of them).

    Returns True iff it blocked: False for CPU-only outputs, which are
    complete already, and under ``torch.compile`` tracing.
    """
    if torch.compiler.is_compiling():
        return False
    devices = {t.device for t in _leaves(out) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return bool(devices)


class _Timer:
    """Handle yielded by ``device_timer``; ``stop(out)`` ends the region."""

    __slots__ = ("t0", "seconds", "blocked")

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds: float | None = None
        self.blocked = False

    def stop(self, out=None) -> float:
        """Block on ``out``'s devices, record and return elapsed seconds."""
        self.blocked = block_ready(out) if out is not None else False
        self.seconds = time.perf_counter() - self.t0
        return self.seconds


@contextlib.contextmanager
def device_timer():
    """Time a dispatch region, blocking on its result::

        with device_timer() as t:
            out = kernel(x)
            t.stop(out)            # synchronize out's devices, then read clock
        hist.observe(t.seconds)

    If ``stop`` is never called the exit path stops without blocking (host
    wall-clock only).
    """
    t = _Timer()
    yield t
    if t.seconds is None:
        t.stop()


def time_dispatch(fn, *args, **kwargs):
    """``(out, seconds)`` of one blocked dispatch of ``fn(*args, **kwargs)``."""
    with device_timer() as t:
        out = fn(*args, **kwargs)
        t.stop(out)
    return out, t.seconds

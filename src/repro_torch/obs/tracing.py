"""Trace spans under one naming convention: ``torch.profiler.record_function``
plus an NVTX range on the card.

Span names are slash-paths ``repro/<layer>/<stage>[/<detail>]`` — e.g.
``repro/serve/flush/append``, ``repro/blocked/panel`` — so a profile groups
by layer first and pipeline stage second, with the same names as the JAX
package's spans.

* ``span(name)`` — enters ``torch.profiler.record_function(name)``, so the
  region shows on the host timeline of a ``torch.profiler`` trace with the
  device kernels it launched beneath it, and, once CUDA is initialised, a
  ``torch.cuda.nvtx.range(name)`` for external timeline tools.
* ``named_span(name)`` — the same span.  The JAX package has a second,
  in-graph kind for code inside ``jit``; PyTorch runs eagerly, so there is
  one timeline and one kind, and the name is kept so call sites read alike.

Both cost a few microseconds a call even when no profiler is running, so
instrumentation sites enter them only when ``obs.enabled()`` is True.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "named_span", "annotate_fn"]


@contextlib.contextmanager
def span(name: str):
    """Profiler span (``record_function``) plus an NVTX range on the card."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def named_span(name: str):
    """The same span as ``span`` (PyTorch has one, eager, timeline)."""
    return span(name)


def annotate_fn(name: str, fn):
    """Wrap ``fn`` so every call runs under ``span(name)``."""

    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    return wrapped

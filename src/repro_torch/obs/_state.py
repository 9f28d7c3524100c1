"""The process-wide active registry (module-private; use ``repro_torch.obs``).

Kept out of ``__init__`` so sibling modules (``flops``, ``health``) can
import the active-registry accessor without importing the package init —
no intra-package cycles, and the accessor stays one dict lookup + attribute
read, cheap enough for uninstrumented hot paths.
"""
from __future__ import annotations

import contextlib

from .registry import MetricsRegistry, NULL

__all__ = ["install", "uninstall", "_active", "collecting"]

_REGISTRY = NULL


def install(registry) -> None:
    """Make ``registry`` the process-wide collector.

    Pass a ``MetricsRegistry`` to start collecting; instrumentation sites
    pick it up on their next call (there is no buffering — metrics recorded
    before install are gone, which is the point of the no-op default).
    """
    global _REGISTRY
    _REGISTRY = registry


def uninstall() -> None:
    """Restore the no-op default registry."""
    global _REGISTRY
    _REGISTRY = NULL


def _active():
    """The active registry (the ``NULL`` no-op unless one was installed)."""
    return _REGISTRY


@contextlib.contextmanager
def collecting(registry=None):
    """Install a collecting registry for the scope of a ``with`` block::

        with obs.collecting() as reg:
            server.flush()
        print(obs.prometheus_text(reg))

    Restores whatever was installed before (usually the no-op default).
    """
    reg = MetricsRegistry() if registry is None else registry
    prev = _REGISTRY
    install(reg)
    try:
        yield reg
    finally:
        install(prev)

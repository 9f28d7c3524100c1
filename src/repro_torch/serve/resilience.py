"""Typed failure results of the serving engine.

Only the ``ServeError`` hierarchy is ported so far — what the continuous
batcher needs to resolve a failed ticket.  The fault-tolerant
``ResilientDispatcher`` (failure domains, retry/degrade ladder, quarantine,
state vault) is a later slice of the port.
"""
from __future__ import annotations

__all__ = ["PoisonedError", "ServeError"]


class ServeError(RuntimeError):
    """Terminal typed result for a request whose dispatch failed.

    Stored in the result slot of every affected ticket;
    ``ContinuousBatcher.result`` re-raises it.  ``classification`` is one of
    ``"transient"`` (retries and the whole degradation ladder exhausted),
    ``"poisoned"`` (see :class:`PoisonedError`), or ``"fatal"``
    (non-retryable programming/shape error).
    """

    def __init__(self, kind: str, classification: str, reason: str,
                 cause: BaseException | None = None):
        super().__init__(
            f"{kind} dispatch failed [{classification}]: {reason}")
        self.kind = kind
        self.classification = classification
        self.reason = reason
        self.cause = cause


class PoisonedError(ServeError):
    """The request itself was bad: non-finite operands, non-finite results,
    or isolated by bisection as the trigger of a poisoned executor failure.
    Retrying cannot help; the ticket is quarantined."""

    def __init__(self, kind: str, reason: str,
                 cause: BaseException | None = None):
        super().__init__(kind, "poisoned", reason, cause)

"""repro_torch.serve — the layered QR serving engine.

The serving stack, bottom-up:

    requests.py   typed Request/Ticket + group signatures (what may stack)
    dispatch.py   per-kind executors, pad-before-dispatch, the sharded path
                  over a 1-D batch mesh, bounded executable cache,
                  double-buffered in-flight chunks (completion tracked
                  with CUDA events)
    batcher.py    continuous batching: open batches close on max_batch /
                  deadline / flush; per-(group, cycle) results
    policy.py     admission control: per-kind latency tiers, reject/shed
    resilience.py failure domains: classify/retry/degrade/quarantine,
                  circuit breakers, streaming-state snapshot vault

``repro_torch.launch.serve_qr.QRServer`` is the closed-loop facade over
these layers.
"""
from .batcher import ContinuousBatcher, OpenBatch
from .dispatch import Dispatcher, DrainError, ExecutableCache, InFlight
from .policy import AdmissionPolicy, LatencyTier, Rejected, ShedError
from .requests import KINDS, Request, Ticket, group_signature, make_request
from .resilience import (
    DEFAULT_LADDER,
    CircuitBreaker,
    IntegrityError,
    PoisonedError,
    Provenance,
    ResilientDispatcher,
    RetryPolicy,
    Rung,
    ServeError,
    StateVault,
    classify_failure,
)

__all__ = [
    "AdmissionPolicy",
    "CircuitBreaker",
    "ContinuousBatcher",
    "DEFAULT_LADDER",
    "Dispatcher",
    "DrainError",
    "ExecutableCache",
    "InFlight",
    "IntegrityError",
    "KINDS",
    "LatencyTier",
    "OpenBatch",
    "PoisonedError",
    "Provenance",
    "Rejected",
    "Request",
    "ResilientDispatcher",
    "RetryPolicy",
    "Rung",
    "ServeError",
    "ShedError",
    "StateVault",
    "Ticket",
    "classify_failure",
    "group_signature",
    "make_request",
]

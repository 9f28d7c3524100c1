"""repro_torch.serve — the layered QR serving engine.

The serving stack, bottom-up:

    requests.py   typed Request/Ticket + group signatures (what may stack)
    dispatch.py   per-kind executors, pad-before-dispatch, double-buffered
                  in-flight chunks (completion tracked with CUDA events)
    batcher.py    continuous batching: open batches close on max_batch /
                  deadline / flush; per-(group, cycle) results
    policy.py     admission control: per-kind latency tiers, reject/shed
    resilience.py the typed ``ServeError`` results (the fault-tolerant
                  dispatcher is not ported yet)

``repro_torch.launch.serve_qr.QRServer`` is the closed-loop facade over
these layers.
"""
from .batcher import ContinuousBatcher, OpenBatch
from .dispatch import Dispatcher, DrainError, ExecutableCache, InFlight
from .policy import AdmissionPolicy, LatencyTier, Rejected, ShedError
from .requests import KINDS, Request, Ticket, group_signature, make_request
from .resilience import PoisonedError, ServeError

__all__ = [
    "AdmissionPolicy",
    "ContinuousBatcher",
    "Dispatcher",
    "DrainError",
    "ExecutableCache",
    "InFlight",
    "KINDS",
    "LatencyTier",
    "OpenBatch",
    "PoisonedError",
    "Rejected",
    "Request",
    "ServeError",
    "ShedError",
    "Ticket",
    "group_signature",
    "make_request",
]

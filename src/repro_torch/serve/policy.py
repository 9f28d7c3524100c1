"""Admission control and per-kind latency tiers for the serving engine.

The control loop the batcher runs on every submit/poll is driven by per-kind
queue depth and queue wait (the age of the oldest open batch).

A ``LatencyTier`` bundles the three per-kind knobs:

* ``deadline`` — an open batch is force-closed (and dispatched) once it has
  been open this long, even if not full.  This is what gives one-shot
  ``lstsq`` solves a tighter latency bound than bulk ``append`` state
  updates without starving either.
* ``max_queue`` — bound on the number of admitted-but-undispatched requests
  of the kind.  ``None`` means unbounded (the legacy closed-loop behavior).
* ``on_full`` — what to do when ``max_queue`` would be exceeded:
  ``"reject"`` refuses the *new* request (raises ``Rejected``);
  ``"shed_oldest"`` drops the kind's oldest open batch instead (its tickets
  resolve to ``ShedError``) and admits the newcomer — fresh work is usually
  worth more than stale work under overload.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

__all__ = ["AdmissionPolicy", "LatencyTier", "Rejected", "ShedError"]


class Rejected(RuntimeError):
    """Admission refused: the kind's queue is at ``max_queue`` capacity."""

    def __init__(self, kind: str, depth: int, limit: int):
        super().__init__(
            f"{kind} admission rejected: queue depth {depth} at its "
            f"max_queue={limit} bound")
        self.kind, self.depth, self.limit = kind, depth, limit


class ShedError(KeyError):
    """The ticket's batch was shed (dropped un-dispatched) under overload."""


@dataclass(frozen=True)
class LatencyTier:
    """Per-kind serving knobs; ``LatencyTier()`` is the do-nothing default."""

    deadline: float | None = None     # seconds an open batch may age
    max_queue: int | None = None      # admitted-but-undispatched bound
    on_full: str = "reject"           # "reject" | "shed_oldest"

    def __post_init__(self):
        if self.on_full not in ("reject", "shed_oldest"):
            raise ValueError(
                f"on_full must be 'reject' or 'shed_oldest', "
                f"got {self.on_full!r}")
        if self.deadline is not None and self.deadline < 0:
            raise ValueError(f"deadline must be >= 0, got {self.deadline}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")


@dataclass(frozen=True)
class AdmissionPolicy:
    """Kind -> tier mapping with a shared default.

    The legacy ``QRServer`` facade runs the default policy (no deadlines,
    unbounded queues) so its closed-loop flush semantics are untouched; the
    async engine passes real tiers, e.g.::

        AdmissionPolicy(tiers={
            "lstsq": LatencyTier(deadline=0.002, max_queue=4096),
            "append": LatencyTier(deadline=0.02, max_queue=16384,
                                  on_full="shed_oldest"),
        })
    """

    tiers: Mapping[str, LatencyTier] = field(default_factory=dict)
    default: LatencyTier = field(default_factory=LatencyTier)

    def tier(self, kind: str) -> LatencyTier:
        return self.tiers.get(kind, self.default)

    def deadline(self, kind: str) -> float | None:
        return self.tier(kind).deadline

    def admit_action(self, kind: str, depth: int) -> str:
        """Decision for one would-be admit at the given per-kind depth.

        ``depth`` counts requests already admitted and not yet dispatched
        (the value ``serve.queue_depth`` gauges).  Returns ``"admit"``,
        ``"reject"``, or ``"shed_oldest"``.
        """
        tier = self.tier(kind)
        if tier.max_queue is None or depth < tier.max_queue:
            return "admit"
        return tier.on_full

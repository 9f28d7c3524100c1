"""Continuous batching: open in-flight batches instead of flush cycles.

The legacy serving loop was all-or-nothing: requests queue until somebody
calls ``flush()``, which stacks and dispatches *everything*.  The
``ContinuousBatcher`` replaces that with LLM-serving-style continuous
batching: each group (see ``serve.requests``) keeps ONE open batch
that admitted requests join, and the batch **closes** — is handed to the
``Dispatcher`` — on the first of:

* ``admit_max`` requests joined (close reason ``"max_batch"``),
* the kind's ``LatencyTier.deadline`` elapsed since the batch opened
  (reason ``"deadline"``, checked by ``poll`` and piggybacked on admits
  whenever the policy carries any deadline),
* an explicit ``flush()`` / ``flush(kind=...)`` (reason ``"flush"``).

Every close advances the group's **cycle**; results are stored per
``(group, cycle)`` with a retention knob: ``retain_cycles=1`` reproduces
the legacy facade semantics (a later close of the same group expires older
tickets), ``retain_cycles=None`` keeps every cycle until read (what an
open-loop server wants — early max_batch closes must not eat a later
caller's results).

Admission runs through the ``AdmissionPolicy`` *before* a request joins:
over-bound kinds either reject the newcomer (``Rejected``) or shed their
oldest open batch (tickets resolve to ``ShedError``) — see ``serve.policy``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from repro_torch import obs

from .dispatch import Dispatcher
from .policy import AdmissionPolicy, Rejected, ShedError
from .requests import KINDS, Request, Ticket, make_request
from .resilience import ServeError

__all__ = ["ContinuousBatcher", "OpenBatch"]

_SHED = object()  # result-store sentinel for shed cycles


@dataclass(frozen=True)
class _PurgedCycle:
    """Result-store marker for an eagerly purged fully-errored cycle.

    When every ticket of a cycle resolved to a ``ServeError`` there is
    nothing worth retaining until ``retain_cycles`` rotation — the per-slot
    list (and its error tracebacks) is dropped immediately and this
    fixed-size marker answers the cycle's tickets with one representative
    error instead.
    """

    error: ServeError
    count: int


@dataclass
class OpenBatch:
    """One group's in-flight batch: requests admitted since the last close."""

    key: tuple
    cycle: int
    opened_at: float
    requests: list = field(default_factory=list)
    submit_times: list = field(default_factory=list)  # obs-only, may be empty


class ContinuousBatcher:
    """Admission -> open batches -> close -> dispatch -> ticket results.

    ``admit_max=None`` + the default policy + ``retain_cycles=1`` is the
    legacy closed-loop mode the ``QRServer`` facade runs (only ``flush``
    closes batches); an async deployment sets ``admit_max``, real tiers,
    and ``retain_cycles=None``, and calls ``poll()`` from its serve loop.
    """

    def __init__(self, dispatcher: Dispatcher | None = None,
                 policy: AdmissionPolicy | None = None,
                 admit_max: int | None = None,
                 retain_cycles: int | None = 1,
                 clock=time.perf_counter):
        self.dispatcher = dispatcher if dispatcher is not None else Dispatcher()
        self.policy = policy if policy is not None else AdmissionPolicy()
        self.admit_max = admit_max
        self.retain_cycles = retain_cycles
        self._clock = clock
        self._open: dict[tuple, OpenBatch] = {}
        self._cycles: dict[tuple, int] = {}    # completed closes per group
        self._results: dict[tuple, dict[int, list]] = {}
        self._handles: dict[tuple, list] = {}  # (group, cycle) -> InFlight[]
        # any deadline anywhere? then admits piggyback a poll
        self._has_deadlines = any(
            t.deadline is not None
            for t in (*self.policy.tiers.values(), self.policy.default))

    # ------------------------------------------------------------- queries
    def _kind_depth(self, kind: str) -> int:
        return sum(len(b.requests) for k, b in self._open.items()
                   if k[0] == kind)

    def pending(self) -> int:
        """Requests admitted but not yet dispatched by a close."""
        return sum(len(b.requests) for b in self._open.values())

    # ----------------------------------------------------------- admission
    def submit(self, kind: str, *args, **kwargs) -> Ticket:
        """Build a typed request on the dispatcher's device and admit it (the
        ``submit_*`` entry)."""
        return self.admit(make_request(kind, *args,
                                       device=self.dispatcher.device, **kwargs))

    def admit(self, request: Request) -> Ticket:
        """Admit one request into its group's open batch.

        Raises ``Rejected`` when the kind's queue bound says so; may close
        the batch immediately (``admit_max``) or close *other* stale
        batches first (deadline piggyback).
        """
        if self._has_deadlines:
            self.poll()
        kind = request.kind
        action = self.policy.admit_action(kind, self._kind_depth(kind))
        if action == "reject":
            if obs.enabled():
                obs.counter("serve.admission_rejected", kind=kind).inc()
            raise Rejected(kind, self._kind_depth(kind),
                           self.policy.tier(kind).max_queue)
        if action == "shed_oldest":
            self._shed_oldest(kind)

        key = request.group
        batch = self._open.get(key)
        if batch is None:
            batch = OpenBatch(key, self._cycles.get(key, 0), self._clock())
            self._open[key] = batch
        batch.requests.append(request)
        if obs.enabled():
            batch.submit_times.append(time.perf_counter())
            obs.counter("serve.requests_submitted", kind=kind).inc()
            obs.gauge("serve.queue_depth",
                      kind=kind).set(self._kind_depth(kind))
        ticket = Ticket(kind, key, len(batch.requests) - 1, batch.cycle)
        if self.admit_max is not None and len(batch.requests) >= self.admit_max:
            self._close(batch, "max_batch")
        return ticket

    def _shed_oldest(self, kind: str) -> None:
        """Drop the kind's oldest open batch un-dispatched (overload)."""
        victims = [b for k, b in self._open.items() if k[0] == kind]
        if not victims:
            return
        batch = min(victims, key=lambda b: b.opened_at)
        del self._open[batch.key]
        self._store(batch.key, batch.cycle, _SHED)
        self._cycles[batch.key] = batch.cycle + 1
        if obs.enabled():
            obs.counter("serve.requests_shed",
                        kind=kind).inc(len(batch.requests))
            obs.gauge("serve.queue_depth",
                      kind=kind).set(self._kind_depth(kind))

    # --------------------------------------------------------------- close
    def poll(self, now: float | None = None) -> int:
        """Close deadline-expired batches; pump in-flight finalizations.

        The serve loop's heartbeat — call between arrivals.  Returns the
        number of batches closed.
        """
        closed = 0
        if self._has_deadlines:
            if now is None:
                now = self._clock()
            for batch in [b for b in self._open.values()
                          if self.policy.deadline(b.key[0]) is not None]:
                if now - batch.opened_at >= self.policy.deadline(batch.key[0]):
                    self._close(batch, "deadline")
                    closed += 1
        if self.dispatcher.double_buffer:
            self.dispatcher.pump()
        return closed

    def flush(self, kind: str | None = None) -> int:
        """Close every (matching) open batch now; returns requests served.

        ``kind`` (None | "append" | "lstsq" | "kalman" | "lstsq_pivoted")
        restricts the flush
        to matching groups — e.g. a latency-sensitive deployment can flush
        one-shot solves more often than state updates.  Results become
        available via ``result(ticket)``; each closed batch advances its
        group's cycle (flushes of *other* groups never expire a ticket).
        """
        if kind is not None and kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}")
        served = 0
        for key in [k for k in self._open if kind is None or k[0] == kind]:
            batch = self._open[key]
            served += len(batch.requests)
            self._close(batch, "flush")
        return served

    def _close(self, batch: OpenBatch, reason: str) -> None:
        """Hand one open batch to the dispatcher and store its results.

        ``reason`` ("max_batch" | "deadline" | "flush") names what closed it.
        """
        key = batch.key
        kind = key[0]
        del self._open[key]
        rec = obs.enabled()
        if rec:
            now = time.perf_counter()
            qwait = obs.histogram("serve.queue_wait_seconds", kind=kind)
            for ts in batch.submit_times:
                qwait.observe(now - ts)
            obs.histogram("serve.batch_size",
                          kind=kind).observe(len(batch.requests))
            obs.counter("serve.batch_close", kind=kind, reason=reason).inc()
            group_span = obs.span(f"repro/serve/flush/{kind}")
        else:
            now = 0.0
            group_span = contextlib.nullcontext()
        with group_span:
            outs, handles = self.dispatcher.dispatch(key, batch.requests,
                                                     cycle=batch.cycle)
        if rec:
            # with double buffering off, per-chunk dispatches blocked above,
            # so this measures the whole cycle: stacking + dispatch + scatter;
            # with it on, it measures host-side close cost only
            obs.histogram("serve.flush_duration_seconds",
                          kind=kind).observe(time.perf_counter() - now)
            obs.counter("serve.requests_served",
                        kind=kind).inc(len(batch.requests))
            obs.gauge("serve.queue_depth",
                      kind=kind).set(self._kind_depth(kind))
        self._store(key, batch.cycle, outs)
        self._handles[(key, batch.cycle)] = handles
        self._cycles[key] = batch.cycle + 1

    def _store(self, key: tuple, cycle: int, outs) -> None:
        if (outs is not _SHED and outs
                and all(isinstance(o, ServeError) for o in outs)):
            # fully-errored cycle: purge eagerly instead of lingering until
            # retain_cycles rotation — tickets still resolve (to the error)
            outs = _PurgedCycle(error=outs[0], count=len(outs))
            if obs.enabled():
                obs.counter("serve.cycles_purged", kind=key[0]).inc()
        cycles = self._results.setdefault(key, {})
        cycles[cycle] = outs
        if self.retain_cycles is not None:
            while len(cycles) > self.retain_cycles:
                dropped = min(cycles)
                del cycles[dropped]
                self._handles.pop((key, dropped), None)

    # ------------------------------------------------------------- results
    def result(self, ticket: Ticket):
        """Fetch a dispatched request's result.

        Raises KeyError if the ticket's batch has not closed since the
        request was queued (still pending — including when closes of
        *other* groups have happened meanwhile), if a later close of the
        same group already replaced the result (``retain_cycles``), or — as
        the ``ShedError`` subclass — if the batch was shed under overload.
        Raises the stored ``ServeError`` (``PoisonedError`` for quarantined
        requests) when resilient dispatch failed the request.
        """
        cycles = self._results.get(ticket.group, {})
        if ticket.cycle in cycles:
            entry = cycles[ticket.cycle]
            if entry is _SHED:
                raise ShedError(
                    f"ticket {ticket.kind}#{ticket.index} (group cycle "
                    f"{ticket.cycle}): shed under overload before dispatch")
            if isinstance(entry, _PurgedCycle):
                raise entry.error
            out = entry[ticket.index]
            if isinstance(out, ServeError):
                raise out
            return out
        if self._cycles.get(ticket.group, 0) <= ticket.cycle:
            queued = len(getattr(self._open.get(ticket.group), "requests", ()))
            state = f"not yet flushed ({queued} request(s) queued in its group)"
        else:
            state = "expired by a later flush of the same request group"
        raise KeyError(f"ticket {ticket.kind}#{ticket.index} "
                       f"(group cycle {ticket.cycle}): {state}")

    def done_at(self, ticket: Ticket) -> float | None:
        """perf_counter timestamp the ticket's chunk finished on device
        (None until its handle was pumped/drained) — the open-loop latency
        bench's completion clock."""
        handles = self._handles.get((ticket.group, ticket.cycle))
        if not handles:
            return None
        return handles[ticket.index // self.dispatcher.max_batch].done_at

    def drain(self) -> int:
        """Block until every stored result is device-complete.

        Also finalizes (blocks + accounts) every in-flight double-buffered
        chunk.  Returns the number of results waited on.
        """
        self.dispatcher.drain()
        outs = [o for cycles in self._results.values()
                for entry in cycles.values()
                if entry is not _SHED and not isinstance(entry, _PurgedCycle)
                for o in entry if not isinstance(o, ServeError)]
        if self.dispatcher.device.type == "cuda":
            torch.cuda.synchronize(self.dispatcher.device)
        return len(outs)

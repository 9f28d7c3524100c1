"""Fault-tolerant dispatch: failure domains, retry/degrade, quarantine.

The plain ``Dispatcher`` assumes the fast path always works: one device
error in one chunk, or one NaN-laden request hiding inside a padded batch,
unwinds through the serve loop and takes every co-resident ticket with it.
This module is the containment layer:

* **Failure domains** — ``ResilientDispatcher`` catches per-chunk executor
  exceptions, classifies them (``classify_failure``: transient / poisoned /
  fatal), and completes the affected tickets with a typed :class:`ServeError`
  *result* instead of raising.  The blast radius of any failure is one
  group-cycle; the serve loop never sees the exception.
* **Retry + circuit breaker** — transient failures retry under a
  :class:`RetryPolicy` (exponential backoff, deterministic jitter, per-kind
  budget); a per-(kind, rung) :class:`CircuitBreaker` (closed / open /
  half-open) trips after N consecutive failures so a persistently broken
  configuration stops being offered traffic.
* **Degradation ladder** — when retries exhaust (or a breaker is open) the
  chunk re-dispatches down :data:`DEFAULT_LADDER`: fused -> tree schedule
  (``kernels.backend.degraded_mode``), mixed-precision -> f32, and
  ultimately the unfused ``"reference"`` backend.  Every hop is counted
  (``serve.degraded_dispatches{from,to}``).  The JAX package's "interpret"
  rung has no counterpart: a kernel's plain version runs only on a CPU
  tensor, and nothing puts it on the card.
* **Poisoned-batch quarantine** — a pre-dispatch finite check catches NaN/Inf
  operands before they enter a fused batch; a post-dispatch check (non-finite
  outputs, plus an optional ``batch_cond_estimate`` bound on returned R
  factors — the ``ranks.monitor`` signal) catches in-flight blow-ups.  Both
  run once per chunk: one reduction per operand position or output leaf and
  one host read of the per-lane mask, whatever the chunk's size.  An
  executor-raised poisoned failure bisects the chunk to isolate the offending
  request(s); quarantined tickets resolve to :class:`PoisonedError` and the
  healthy remainder re-dispatches **at the original padded width**, so
  quarantine never changes the shapes (and so the bits) the survivors see.
* **Streaming-state recovery** — :class:`StateVault` snapshots long-lived
  ``RecursiveLS`` / ``KalmanState`` ``(R, d)`` states through
  ``repro_torch.checkpoint`` and restores the newest snapshot that passes an
  integrity gate (finite leaves + cond-estimate bound), falling back to
  older snapshots past corrupted ones.

**Failures on the card.**  A CUDA out-of-memory error
(``torch.OutOfMemoryError``), a CUDA runtime error raised at a
synchronization (``torch.AcceleratorError``) and ``MemoryError`` are
transient.  The kernel binding's own ``RuntimeError`` — a kernel that fails
to build (``nvcc``) or whose launch is refused — is fatal, like every other
unrecognized exception: its tickets resolve to ``ServeError("fatal")`` and a
lower rung never serves them.  A sticky device fault (an illegal address)
leaves the CUDA context unusable, so every rung fails in turn and the
tickets resolve to ``ServeError("transient")``; that is what the card does,
not a choice of this module.

Fault injection (``repro_torch.testing.faults``) plugs in through
``set_injector``: the injector's ``on_dispatch`` hook runs inside the
executor's failure domain, so injected raises exercise exactly the
production classify/retry/degrade/quarantine machinery.

With no installed injector and no faults, ``ResilientDispatcher`` is
bitwise-compatible with ``Dispatcher``: same stacking, same padding, same
kernels, same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import shutil
import time
import zlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.backend import degraded_mode

from .dispatch import Dispatcher, InFlight

__all__ = [
    "CircuitBreaker",
    "DEFAULT_LADDER",
    "IntegrityError",
    "PoisonedError",
    "Provenance",
    "ResilientDispatcher",
    "RetryPolicy",
    "Rung",
    "ServeError",
    "StateVault",
    "classify_failure",
    "get_injector",
    "set_injector",
]


# ------------------------------------------------------------ typed results
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


# ------------------------------------------------------------ classification
#: exception type names (matched by name, as in the JAX package) treated as
#: transient device/runtime trouble: a CUDA out-of-memory error and a CUDA
#: runtime error raised at a synchronization.
_TRANSIENT_NAMES = frozenset({"OutOfMemoryError", "AcceleratorError"})


def classify_failure(exc: BaseException) -> str:
    """Map one executor exception to ``transient | poisoned | fatal``.

    An exception may pre-classify itself via a ``serve_classification``
    attribute (the fault injectors do); otherwise ``FloatingPointError`` is
    data poison (the eager ``DowndateGuard(mode="raise")`` path),
    device-runtime errors and ``MemoryError`` are transient, and anything
    else — shape errors, type errors, a kernel that fails to build or
    launch, plain bugs — is fatal: retrying a deterministic failure only
    burns the retry budget.
    """
    tag = getattr(exc, "serve_classification", None)
    if tag in ("transient", "poisoned", "fatal"):
        return tag
    if isinstance(exc, FloatingPointError):
        return "poisoned"
    if isinstance(exc, MemoryError):
        return "transient"
    if type(exc).__name__ in _TRANSIENT_NAMES:
        return "transient"
    return "fatal"


# ------------------------------------------------------------------ injector
_INJECTOR = None


def set_injector(injector):
    """Install (or, with None, remove) the process-wide fault injector.

    Returns the previously installed injector so context managers can
    restore it.  The injector's ``on_dispatch(kind=, rung=, dispatcher=,
    chunk=)`` hook is called inside every executor attempt's failure domain
    — raising from it is indistinguishable from the executor raising.
    """
    global _INJECTOR
    prev, _INJECTOR = _INJECTOR, injector
    return prev


def get_injector():
    return _INJECTOR


# --------------------------------------------------------------- retry policy
class RetryPolicy(NamedTuple):
    """Backoff schedule for transient chunk failures.

    ``delay(attempt, salt)`` is ``backoff * backoff_factor**(attempt-1)``
    scaled by a deterministic jitter in ``[1-jitter, 1+jitter]`` derived
    from ``salt`` (a hash of the group key and rung) — reproducible runs,
    but co-resident groups still decorrelate.  ``kind_budget`` bounds the
    *total* retries a dispatcher spends per kind (None = unbounded): one
    chunk melting down cannot starve the rest of the fleet of retry time.
    """

    max_attempts: int = 3
    backoff: float = 0.005
    backoff_factor: float = 2.0
    jitter: float = 0.25
    kind_budget: int | None = None

    def delay(self, attempt: int, salt: int = 0) -> float:
        base = self.backoff * self.backoff_factor ** max(attempt - 1, 0)
        if not self.jitter:
            return base
        u = ((salt * 2654435761 + attempt * 40503) & 0x3FF) / 1023.0
        return base * (1.0 - self.jitter + 2.0 * self.jitter * u)


def _salt(key: tuple, rung_i: int) -> int:
    return zlib.crc32(repr((key, rung_i)).encode())


# ------------------------------------------------------------ circuit breaker
_BREAKER_STATES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Closed / open / half-open breaker over one (kind, rung) lane.

    ``failure_threshold`` consecutive failures open the breaker; after
    ``cooldown`` seconds it half-opens and admits probes — a probe success
    closes it, a probe failure re-opens it (and restarts the cooldown).
    ``clock`` is injectable for tests; ``on_state`` fires on every
    transition (the dispatcher wires it to the ``serve.breaker_state``
    gauge: closed=0, half_open=1, open=2).
    """

    def __init__(self, failure_threshold: int = 5, cooldown: float = 30.0,
                 clock=time.monotonic, on_state=None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.clock = clock
        self.on_state = on_state
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        if on_state is not None:
            on_state("closed")

    def _transition(self, state: str) -> None:
        if state != self._state:
            self._state = state
            if self.on_state is not None:
                self.on_state(state)

    @property
    def state(self) -> str:
        if (self._state == "open"
                and self.clock() - self._opened_at >= self.cooldown):
            self._transition("half_open")
        return self._state

    def allow(self) -> bool:
        """May this lane be offered traffic right now?"""
        return self.state != "open"

    def record_success(self) -> None:
        self._failures = 0
        self._transition("closed")

    def record_failure(self) -> None:
        self._failures += 1
        if self.state == "half_open" or self._failures >= self.failure_threshold:
            self._opened_at = self.clock()
            self._failures = 0
            self._transition("open")


# --------------------------------------------------------- degradation ladder
class Rung(NamedTuple):
    """One degraded configuration: dispatcher field overrides applied for
    the duration of the attempt, plus ``kernels.backend.degraded_mode``
    kwargs for knobs that are not threaded through executor signatures."""

    name: str
    overrides: tuple = ()  # ((dispatcher_field, value), ...)
    kernel: tuple = ()     # degraded_mode kwargs: (("schedule", "tree"), ...)


#: native -> tree schedule -> uniform f32 -> the unfused reference backend.
#: Each rung is slower and more conservative than the one above it; the last
#: rung (plain PyTorch sweeps, no hand-written kernel) is always admitted
#: even when its breaker disagrees — it is the floor.
DEFAULT_LADDER = (
    Rung("native"),
    Rung("tree_schedule", kernel=(("schedule", "tree"),)),
    Rung("f32", overrides=(("precision", "f32"),)),
    Rung("reference", overrides=(("backend", "reference"),)),
)


class Provenance(NamedTuple):
    """How one request's result was produced (``ResilientDispatcher
    .provenance[(group, cycle)]``, aligned with submission order)."""

    rung: str                     # ladder rung name, or "quarantined"
    attempts: int                 # executor attempts the chunk consumed
    error: ServeError | None = None
    quarantined: bool = False


def _sum_flops(*parts):
    """One chunk's flops callable from its sub-dispatches' (None = no work)."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    return lambda: sum(p() for p in parts)


# -------------------------------------------------------- resilient dispatch
@dataclass
class ResilientDispatcher(Dispatcher):
    """Drop-in ``Dispatcher`` with failure domains around every chunk.

    ``dispatch`` never raises for executor/data failures: every request in
    the batch comes back as either a result or a :class:`ServeError`, and
    ``provenance[(group, cycle)]`` records which rung served each request,
    how many attempts it took, and whether it was quarantined.

    Validation is synchronous (results are synchronized and checked before
    ``dispatch`` returns), so ``double_buffer=True`` is rejected — you
    cannot quarantine a batch you have not looked at.  A rung whose
    ``overrides`` name a field this dispatcher lacks, or whose ``kernel``
    names a knob ``degraded_mode`` lacks, is rejected when the dispatcher is
    built.

    ``max_cond`` arms the post-dispatch condition gate: returned R factors
    whose ``batch_cond_estimate`` exceeds it are quarantined alongside the
    non-finite lanes (the ``ranks.monitor`` rank-cliff signal, applied per
    serving lane).
    """

    retry: RetryPolicy = RetryPolicy()
    ladder: tuple = DEFAULT_LADDER
    precheck: bool = True
    postcheck: bool = True
    max_cond: float | None = None
    max_isolation_depth: int = 8
    breaker_threshold: int = 5
    breaker_cooldown: float = 30.0
    sleep: object = time.sleep       # injectable: tests pass a recorder
    clock: object = time.monotonic   # breaker clock, injectable
    provenance: dict = field(default_factory=dict)
    _breakers: dict = field(default_factory=dict)
    _retry_spent: dict = field(default_factory=dict)
    _pad_floor: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.double_buffer:
            raise ValueError(
                "ResilientDispatcher validates results synchronously; "
                "double_buffer=True is not supported")
        self.ladder = tuple(self.ladder)
        if not self.ladder:
            raise ValueError("degradation ladder needs at least one rung")
        fields = {f.name for f in dataclasses.fields(self)}
        knobs = set(inspect.signature(degraded_mode).parameters)
        for rung in self.ladder:
            unknown = ([f for f, _ in rung.overrides if f not in fields]
                       + [k for k, _ in rung.kernel if k not in knobs])
            if unknown:
                raise ValueError(
                    f"rung {rung.name!r} overrides {unknown}, which this "
                    "dispatcher does not have (the port has no interpret "
                    "or mesh knob)")

    # ------------------------------------------------------------- padding
    def padded_chunk(self, nb: int, kind: str, dtype=None) -> int:
        # the pad floor pins quarantine/bisect re-dispatches to the original
        # chunk's padded width: survivors run at the same shapes and keep
        # their fault-free bits
        p = super().padded_chunk(nb, kind, dtype)
        return max(p, self._pad_floor) if self._pad_floor else p

    # ------------------------------------------------------------ dispatch
    def dispatch(self, key: tuple, reqs: list,
                 cycle: int = 0) -> tuple[list, list[InFlight]]:
        kind = key[0]
        outs: list = []
        handles: list[InFlight] = []
        prov_all: list[Provenance] = []
        for lo in range(0, len(reqs), self.max_batch):
            chunk = reqs[lo:lo + self.max_batch]
            rec = obs.enabled()
            t0 = time.perf_counter() if rec else 0.0
            entries, provs, flops, r_factor = self._run_chunk(key, chunk)
            outs.extend(entries)
            prov_all.extend(provs)
            # the chunk's attempts synchronized inside their failure domains:
            # this event completes at once
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            record = rec and flops is not None
            infl = InFlight(key, len(chunk), entries, event, t0, flops,
                            r_factor, record)
            if record:
                sig = (key, self.padded_chunk(len(chunk), kind, key[2]))
                if sig not in self._seen_dispatch:
                    self._seen_dispatch.add(sig)
                    obs.counter("serve.executable_cache_miss",
                                kind=kind).inc()
            self.finalize(infl)
            handles.append(infl)
        self.provenance[(key, cycle)] = prov_all
        return outs, handles

    # ----------------------------------------------------- one chunk's domain
    def _run_chunk(self, key: tuple, chunk: list):
        """Pre-check, dispatch with retries/degradation, post-check.

        Returns ``(entries, provenance, flops, r_factor)`` with one entry
        (result or ServeError) per request, in chunk order; ``flops`` is the
        chunk's flops callable, or None when no executor attempt succeeded.
        Never raises for executor or data failures.
        """
        kind = key[0]
        n = len(chunk)
        entries: list = [None] * n
        provs: list = [None] * n
        bad_ops = _nonfinite_operands(chunk) if self.precheck else {}
        for i, bad_op in bad_ops.items():
            err = PoisonedError(
                kind, f"non-finite operand #{bad_op} "
                      "(pre-dispatch finite check)")
            entries[i] = err
            provs[i] = Provenance("quarantined", 0, err, quarantined=True)
            if obs.enabled():
                obs.counter("serve.quarantined", kind=kind,
                            stage="precheck").inc()
        if len(bad_ops) == n:
            return entries, provs, None, None
        live = [i for i in range(n) if i not in bad_ops]
        sub = [chunk[i] for i in live] if bad_ops else chunk
        saved_floor = self._pad_floor
        self._pad_floor = max(saved_floor,
                              Dispatcher.padded_chunk(self, n, kind, key[2]))
        try:
            ent, prv, flops, r_factor = self._dispatch_resilient(key, sub)
        finally:
            self._pad_floor = saved_floor
        if not bad_ops:
            return ent, prv, flops, r_factor
        for j, i in enumerate(live):
            entries[i] = ent[j]
            provs[i] = prv[j]
        return entries, provs, flops, r_factor

    def _dispatch_resilient(self, key: tuple, sub: list, depth: int = 0):
        """Retry / degrade / quarantine loop for one (sub-)chunk."""
        kind = key[0]
        ladder = self.ladder
        rung_i = 0
        attempt = 0
        while True:
            # breaker-open rungs are skipped (counted as degradations); the
            # last rung is the floor and always admits traffic
            while (rung_i + 1 < len(ladder)
                   and not self._breaker(kind, rung_i).allow()):
                self._note_degraded(kind, ladder[rung_i].name,
                                    ladder[rung_i + 1].name, "breaker_open")
                rung_i += 1
                attempt = 0
            rung = ladder[rung_i]
            try:
                outs, flops, r_factor = self._execute(key, sub, rung)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — classifying is the job
                cls = classify_failure(e)
                if obs.enabled():
                    obs.counter("serve.chunk_failures", kind=kind,
                                classification=cls).inc()
                if cls == "poisoned":
                    return self._isolate(key, sub, depth, e)
                self._breaker(kind, rung_i).record_failure()
                if cls == "fatal":
                    err = ServeError(kind, "fatal",
                                     f"{type(e).__name__}: {e}", cause=e)
                    prov = Provenance(rung.name, attempt + 1, err)
                    return [err] * len(sub), [prov] * len(sub), None, None
                attempt += 1
                if (attempt < self.retry.max_attempts
                        and self._consume_retry(kind)):
                    if obs.enabled():
                        obs.counter("serve.retries", kind=kind).inc()
                    self.sleep(self.retry.delay(attempt,
                                                salt=_salt(key, rung_i)))
                    continue
                if rung_i + 1 < len(ladder):
                    self._note_degraded(kind, rung.name,
                                        ladder[rung_i + 1].name,
                                        "retry_exhausted")
                    rung_i += 1
                    attempt = 0
                    continue
                err = ServeError(
                    kind, "transient",
                    "retries and degradation ladder exhausted "
                    f"({type(e).__name__}: {e})", cause=e)
                prov = Provenance(rung.name, attempt, err)
                return [err] * len(sub), [prov] * len(sub), None, None

            bad = self._bad_lanes(outs, r_factor) if self.postcheck else []
            if not bad:
                self._breaker(kind, rung_i).record_success()
                prov = Provenance(rung.name, attempt + 1)
                return list(outs), [prov] * len(sub), flops, r_factor
            return self._quarantine_lanes(key, sub, outs, bad, rung,
                                          attempt + 1, flops, r_factor, depth)

    # -------------------------------------------------------------- attempts
    def _execute(self, key: tuple, sub: list, rung: Rung):
        """One executor attempt under one rung's configuration.

        Synchronizes the dispatcher's device *inside* the rung's failure
        domain so asynchronously-raised device errors surface here,
        attributable to this attempt, not later in ``finalize``.
        """
        kind = key[0]
        injector = get_injector()
        with self._apply_rung(rung):
            if injector is not None:
                injector.on_dispatch(kind=kind, rung=rung.name,
                                     dispatcher=self, chunk=sub)
            exec_one = self._EXECUTORS[kind]
            outs, flops, r_factor = exec_one(self, sub)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return outs, flops, r_factor

    @contextlib.contextmanager
    def _apply_rung(self, rung: Rung):
        saved = [(f, getattr(self, f)) for f, _ in rung.overrides]
        for f, v in rung.overrides:
            if f == "precision" and v is not None:
                from repro_torch.kernels import resolve_precision

                v = resolve_precision(v)
            setattr(self, f, v)
        try:
            if rung.kernel:
                with degraded_mode(**dict(rung.kernel)):
                    yield
            else:
                yield
        finally:
            for f, v in saved:
                setattr(self, f, v)

    # ------------------------------------------------------------ quarantine
    def _bad_lanes(self, outs, r_factor) -> list[int]:
        """Lane indices whose results fail the post-dispatch gate: one
        finite reduction per output leaf over the chunk, the condition
        gate's one batched estimate, one host read."""
        bad = _nonfinite_lanes(outs)
        if self.max_cond is not None and r_factor is not None:
            from repro_torch.ranks.monitor import batch_cond_estimate

            conds = batch_cond_estimate(r_factor[:len(outs)])
            bad = bad | (conds > self.max_cond)
        return torch.nonzero(bad.cpu()).flatten().tolist()

    def _quarantine_lanes(self, key, sub, outs, bad, rung, attempts,
                          flops, r_factor, depth):
        """Fail the poisoned lanes, re-dispatch the healthy remainder (at
        the pinned padded width, so survivors keep their shapes)."""
        kind = key[0]
        if obs.enabled():
            obs.counter("serve.quarantined", kind=kind,
                        stage="postcheck").inc(len(bad))
        entries: list = [None] * len(sub)
        provs: list = [None] * len(sub)
        for i in bad:
            err = PoisonedError(
                kind, "non-finite or ill-conditioned result "
                      "(post-dispatch check)")
            entries[i] = err
            provs[i] = Provenance(rung.name, attempts, err, quarantined=True)
        healthy = [i for i in range(len(sub)) if i not in set(bad)]
        if not healthy:
            return entries, provs, None, None
        if depth >= self.max_isolation_depth:
            # bisection budget spent: keep the healthy lanes' (validated-
            # finite) results rather than recursing forever
            for i in healthy:
                entries[i] = outs[i]
                provs[i] = Provenance(rung.name, attempts)
            return entries, provs, flops, r_factor
        h_ent, h_prov, h_flops, _ = self._dispatch_resilient(
            key, [sub[i] for i in healthy], depth + 1)
        for j, i in enumerate(healthy):
            entries[i] = h_ent[j]
            provs[i] = h_prov[j]
        return entries, provs, h_flops, None

    def _isolate(self, key: tuple, sub: list, depth: int,
                 cause: BaseException):
        """Bisect a poisoned executor failure down to the offending
        request(s); halves that execute cleanly keep their results."""
        kind = key[0]
        if len(sub) == 1 or depth >= self.max_isolation_depth:
            err = PoisonedError(
                kind, f"isolated by bisection after "
                      f"{type(cause).__name__}: {cause}", cause=cause)
            if obs.enabled():
                obs.counter("serve.quarantined", kind=kind,
                            stage="bisect").inc(len(sub))
            prov = Provenance("quarantined", 0, err, quarantined=True)
            return [err] * len(sub), [prov] * len(sub), None, None
        mid = len(sub) // 2
        l_ent, l_prov, l_flops, _ = self._dispatch_resilient(
            key, sub[:mid], depth + 1)
        r_ent, r_prov, r_flops, _ = self._dispatch_resilient(
            key, sub[mid:], depth + 1)
        return (l_ent + r_ent, l_prov + r_prov, _sum_flops(l_flops, r_flops),
                None)

    # ------------------------------------------------------------- plumbing
    def _breaker(self, kind: str, rung_i: int) -> CircuitBreaker:
        breaker = self._breakers.get((kind, rung_i))
        if breaker is None:
            rung_name = self.ladder[rung_i].name

            def on_state(state, _kind=kind, _rung=rung_name):
                if obs.enabled():
                    obs.gauge("serve.breaker_state", kind=_kind,
                              rung=_rung).set(_BREAKER_STATES[state])

            breaker = CircuitBreaker(self.breaker_threshold,
                                     self.breaker_cooldown,
                                     clock=self.clock, on_state=on_state)
            self._breakers[(kind, rung_i)] = breaker
        return breaker

    def _consume_retry(self, kind: str) -> bool:
        budget = self.retry.kind_budget
        if budget is None:
            return True
        spent = self._retry_spent.get(kind, 0)
        if spent >= budget:
            return False
        self._retry_spent[kind] = spent + 1
        return True

    def _note_degraded(self, kind: str, from_rung: str, to_rung: str,
                       reason: str) -> None:
        if obs.enabled():
            obs.counter("serve.degraded_dispatches", kind=kind,
                        reason=reason,
                        **{"from": from_rung, "to": to_rung}).inc()


def _nonfinite_rows(x: torch.Tensor) -> torch.Tensor:
    """(len(x),) bool: rows of ``x`` holding a non-finite value."""
    return ~torch.isfinite(x).reshape(len(x), -1).all(1)


def _nonfinite_operands(chunk: list) -> dict:
    """``{lane: index of its first non-finite operand}``.

    One reduction per operand position over the chunk and one host read of
    the (positions, lanes) mask.  A position whose tensors are all distinct
    is checked on its stack; a position with shared tensors (the
    fleet-shared kalman models) checks each distinct tensor once.  The chunk
    shares one group signature, so every request has the same operands and
    dtypes."""
    n = len(chunk)
    rows, where = [], []
    for j, a0 in enumerate(chunk[0].arrays):
        if a0 is None or not (a0.is_floating_point() or a0.is_complex()):
            continue
        col = [r.arrays[j] for r in chunk]
        distinct = {id(a): a for a in col}
        if len(distinct) == n:
            rows.append(_nonfinite_rows(torch.stack(col)))
        else:
            # each distinct tensor once; verdicts expanded back to the lanes
            slot = {k: u for u, k in enumerate(distinct)}
            bad = _nonfinite_rows(torch.stack(list(distinct.values())))
            rows.append(bad[torch.tensor([slot[id(a)] for a in col],
                                         device=bad.device)])
        where.append(j)
    if not rows:
        return {}
    mask = torch.stack(rows).cpu().numpy()  # the one host read
    return {int(i): where[int(mask[:, i].argmax())]
            for i in np.flatnonzero(mask.any(0))}


def _nonfinite_lanes(outs) -> torch.Tensor:
    """(n,) bool on the results' device: lanes with a non-finite value in any
    result leaf — one reduction per batched output of the chunk (the
    executor's ``Lanes.batched``)."""
    bad = None
    for leaf in outs.batched:
        if not (leaf.is_floating_point() or leaf.is_complex()):
            continue
        lane = ~torch.isfinite(leaf).reshape(len(leaf), -1).all(1)
        bad = lane if bad is None else bad | lane
    return bad


# ----------------------------------------------------- streaming-state vault
class IntegrityError(RuntimeError):
    """No snapshot passed the restore-time integrity gate."""


@dataclass
class StateVault:
    """Periodic snapshot/restore of long-lived streaming states.

    ``snapshot(name, state)`` counts updates per name and persists every
    ``interval``-th one through ``repro_torch.checkpoint`` (atomic rename, so
    a crash mid-save never shadows the previous good snapshot), keeping the
    newest ``keep`` snapshots.  ``restore_latest(name, like)`` walks the
    snapshots newest-first and returns the first that passes the integrity
    gate — every float leaf finite, and (when ``max_cond`` is set and the
    state carries an ``R`` factor) ``cond_estimate(R) <= max_cond`` — so a
    corrupted newest snapshot falls back to an older good one instead of
    resurrecting the corruption it was meant to survive.  Restored leaves
    land on the device and dtype of ``like``'s.  The files are the JAX
    package's: either package restores the other's snapshots.
    """

    root: str
    interval: int = 100
    max_cond: float | None = None
    keep: int = 3

    def __post_init__(self):
        self._counts: dict[str, int] = {}

    def snapshot(self, name: str, state, force: bool = False) -> str | None:
        """Fold one state update in; persist on the interval (or ``force``).
        Returns the written snapshot path, or None when skipped."""
        count = self._counts.get(name, 0) + 1
        self._counts[name] = count
        if not force and count % self.interval:
            return None
        from repro_torch.checkpoint import save

        path = save(os.path.join(self.root, name), count, state)
        self._gc(name)
        if obs.enabled():
            obs.counter("serve.state_snapshots", name=name).inc()
        return path

    def validate(self, state) -> tuple[bool, str]:
        """The restore-time integrity gate, exposed for callers that want
        to vet a live state without persisting it."""
        from repro_torch.solvers.lstsq import state_integrity

        return state_integrity(state, max_cond=self.max_cond)

    def restore_latest(self, name: str, like):
        """Restore the newest snapshot of ``name`` that passes the gate.

        Returns ``(state, step)``; raises :class:`IntegrityError` when no
        stored snapshot validates (callers re-initialize from scratch).
        """
        from repro_torch.checkpoint import restore

        directory = os.path.join(self.root, name)
        rejected = []
        for step in sorted(self._steps(directory), reverse=True):
            tree, _ = restore(directory, step, like)
            ok, why = self.validate(tree)
            if ok:
                if obs.enabled():
                    obs.counter("serve.state_restores", name=name,
                                outcome="ok").inc()
                return tree, step
            rejected.append(f"step {step}: {why}")
            if obs.enabled():
                obs.counter("serve.state_restores", name=name,
                            outcome="rejected").inc()
        detail = "; ".join(rejected) if rejected else "no snapshots on disk"
        raise IntegrityError(
            f"no valid snapshot for {name!r} under {directory}: {detail}")

    def _steps(self, directory: str) -> list[int]:
        if not os.path.isdir(directory):
            return []
        return [int(d.split("_")[1]) for d in os.listdir(directory)
                if d.startswith("step_")
                and os.path.exists(os.path.join(directory, d,
                                                "manifest.json"))]

    def _gc(self, name: str) -> None:
        directory = os.path.join(self.root, name)
        steps = sorted(self._steps(directory), reverse=True)
        for step in steps[self.keep:]:
            shutil.rmtree(os.path.join(directory, f"step_{step:08d}"),
                          ignore_errors=True)

"""Deterministic, seedable fault injection for the serving engine.

The chaos harness: a :class:`FaultPlan` names fault classes and rates, a
:class:`FaultInjector` draws from its own ``numpy`` Generator (one draw per
hazard per dispatch attempt, in fixed order, so a given seed yields the
same fault schedule regardless of which rates are zero), and
:func:`inject` installs it behind the ``repro_torch.serve.resilience`` hook for
the duration of a ``with`` block:

    from repro_torch.testing.faults import FaultPlan, inject

    with inject(FaultPlan(seed=7, transient_rate=0.05)) as inj:
        engine.flush(); engine.drain()
    assert inj.counts["transient"] >= 1

Injected exceptions carry ``serve_classification`` attributes, so they
exercise exactly the production ``classify_failure`` -> retry -> degrade ->
quarantine machinery — no test-only code paths inside the dispatcher.

Fault classes:

* **executor raise** — ``transient_rate`` raises :class:`InjectedTransient`
  from inside the executor's failure domain (``transient_limit`` caps the
  total, which is how the ladder drills force "fail exactly K attempts and
  land on rung K // max_attempts"); ``poison_rate`` raises
  :class:`InjectedPoison`, triggering bisection.
* **NaN insertion** — :func:`poison_workload` corrupts a deterministic
  subset of a ``make_workload`` request list (NaN into a copy of the first
  operand, numpy or tensor), returning the poisoned indices so the harness
  can assert exactly those tickets quarantine.
* **latency spikes** — ``latency_rate`` sleeps ``latency_s`` before the
  executor runs (p99-under-degradation measurements).
* **cache eviction storms** — ``evict_rate`` clears the dispatcher's
  ``ExecutableCache`` (the rebuild cost shows up as a miss spike).

The draws are the JAX package's (``repro.testing.faults``), in the same
order, so one seed gives the same fault schedule in both packages.

Everything here is test/benchmark-side; production code never imports
``repro_torch.testing``.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.serve import resilience

__all__ = [
    "FaultInjector",
    "FaultPlan",
    "InjectedFatal",
    "InjectedPoison",
    "InjectedTransient",
    "ScriptedInjector",
    "inject",
    "poison_workload",
]


class InjectedTransient(RuntimeError):
    """Injected stand-in for a retryable device/runtime failure."""

    serve_classification = "transient"


class InjectedPoison(RuntimeError):
    """Injected stand-in for a data-poisoned executor failure (bisected)."""

    serve_classification = "poisoned"


class InjectedFatal(RuntimeError):
    """Injected stand-in for a non-retryable failure."""

    serve_classification = "fatal"


@dataclass(frozen=True)
class FaultPlan:
    """Declarative chaos configuration: per-hazard rates, one seed.

    Rates are per *executor attempt* (retries re-roll, so a transient storm
    compounds exactly the way a real flaky device does).  ``kinds``
    restricts injection to the named request kinds; ``transient_limit``
    caps the number of transient raises over the injector's lifetime.
    """

    seed: int = 0
    transient_rate: float = 0.0
    transient_limit: int | None = None
    poison_rate: float = 0.0     # executor-raise poison (drives bisection)
    latency_rate: float = 0.0
    latency_s: float = 0.0
    evict_rate: float = 0.0
    kinds: tuple | None = None


class FaultInjector:
    """Draws the plan's hazards on every dispatch attempt; counts what
    actually fired (``counts``: latency / evict / transient / poison)."""

    def __init__(self, plan: FaultPlan, sleep=time.sleep):
        self.plan = plan
        self.sleep = sleep
        self.rng = np.random.default_rng(plan.seed)
        self.counts: Counter = Counter()

    def on_dispatch(self, kind: str, rung: str, dispatcher, chunk=None):
        plan = self.plan
        if plan.kinds is not None and kind not in plan.kinds:
            return
        # fixed draw order (latency, evict, transient, poison) keeps the
        # fault schedule a pure function of the seed and the call sequence
        r_latency, r_evict, r_transient, r_poison = self.rng.random(4)
        if plan.latency_rate and r_latency < plan.latency_rate:
            self.counts["latency"] += 1
            self.sleep(plan.latency_s)
        if plan.evict_rate and r_evict < plan.evict_rate:
            self.counts["evict"] += 1
            dispatcher.executables.clear()
        if (plan.transient_rate and r_transient < plan.transient_rate
                and (plan.transient_limit is None
                     or self.counts["transient"] < plan.transient_limit)):
            self.counts["transient"] += 1
            raise InjectedTransient(
                f"injected transient executor failure "
                f"#{self.counts['transient']} ({kind}/{rung})")
        if plan.poison_rate and r_poison < plan.poison_rate:
            self.counts["poison"] += 1
            raise InjectedPoison(
                f"injected poisoned executor failure "
                f"#{self.counts['poison']} ({kind}/{rung})")


class ScriptedInjector:
    """Raise on exact dispatch-attempt indices (0-based) — the ladder
    drills' precision tool: failing attempts ``0..K*max_attempts-1`` forces
    the chunk onto rung K deterministically."""

    def __init__(self, fail_calls, exc=InjectedTransient):
        self.fail_calls = set(fail_calls)
        self.exc = exc
        self.calls = 0

    def on_dispatch(self, kind: str, rung: str, dispatcher, chunk=None):
        index = self.calls
        self.calls += 1
        if index in self.fail_calls:
            raise self.exc(f"scripted {self.exc.__name__} at attempt "
                           f"{index} ({kind}/{rung})")


@contextlib.contextmanager
def inject(plan_or_injector):
    """Install a fault injector for the dynamic extent of the block.

    Accepts a :class:`FaultPlan` (wrapped in a fresh
    :class:`FaultInjector`) or any object with an ``on_dispatch`` hook;
    yields the injector and restores the previously installed one on exit.
    """
    if hasattr(plan_or_injector, "on_dispatch"):
        injector = plan_or_injector
    else:
        injector = FaultInjector(plan_or_injector)
    previous = resilience.set_injector(injector)
    try:
        yield injector
    finally:
        resilience.set_injector(previous)


def poison_workload(reqs: list, rate: float, seed: int = 0):
    """NaN-poison a deterministic subset of a ``make_workload`` list.

    Returns ``(poisoned_reqs, indices)``: at least one and about
    ``ceil(rate * len)`` requests get a NaN written into one element of
    their first operand (a fresh copy — numpy, or a tensor cloned on its
    device; the input list and its operands are never mutated).  The
    indices let a harness assert that exactly those tickets resolve to
    ``PoisonedError`` and no others.
    """
    n = len(reqs)
    if not n or rate <= 0.0:
        return list(reqs), []
    rng = np.random.default_rng(seed)
    count = min(n, max(1, math.ceil(rate * n)))
    indices = sorted(int(i) for i in
                     rng.choice(n, size=count, replace=False))
    out = list(reqs)
    for i in indices:
        kind, *operands = out[i]
        if isinstance(operands[0], torch.Tensor):
            first = operands[0].clone(memory_format=torch.contiguous_format)
            first.view(-1)[int(rng.integers(first.numel()))] = float("nan")
        else:
            first = np.array(operands[0], copy=True)
            first.flat[int(rng.integers(first.size))] = np.nan
        out[i] = (kind, first, *operands[1:])
    return out, indices

"""Batch executors and the device-dispatch layer of the serving engine.

One ``Dispatcher`` owns everything between "a closed batch of typed
requests" and "per-request results": per-kind executors (append / lstsq /
kalman / lstsq_pivoted), the per-server executable cache and the
double-buffering that overlaps host-side stacking of batch k+1 with batch
k's device work.  Eager PyTorch builds no executables, so as in the JAX
package's single-device path nothing fills the cache (``ExecutableCache``,
a bounded LRU) until a compiled path — the sharded dispatch of a later
slice — uses it; the fault injector's eviction hazard clears it.

**Padding before dispatch.**  Every chunk is zero-padded to ``block_b``
granularity (``padded_chunk``) before the executor sees it, so deadline
closes of arbitrary size run at a few batch shapes only.  Zero problems are
exact fixed points of the eps-guarded sweeps, so the pad rows are sliced off
afterwards unchanged.

**Double buffering.**  CUDA work is asynchronous: an executor enqueues
kernels on the current stream and returns tensors that are not yet
computed.  In ``double_buffer=True`` mode the dispatcher never blocks at
dispatch time — it records a CUDA event after each chunk and keeps an
``InFlight`` handle; the caller (the continuous batcher) finalizes handles
later (``pump`` polls the events without blocking, ``drain`` blocks), so the
host stacks the next batch while the card works on the previous one.
``double_buffer=False`` finalizes each chunk before the next is stacked.

**Accounting.**  With a ``repro_torch.obs`` collector installed, finalizing
a chunk blocks on its CUDA event and records it: ``record_dispatch`` (the
host clock from stacking to the event's completion, and the chunk's flops
from the ``core.counts`` models), ``serve.padding_waste`` and, for the
R-producing kinds, ``factor_health``; the first dispatch of each (group,
padded batch) signature counts a ``serve.executable_cache_miss``.  Without
a collector a chunk costs one ``enabled`` read more.

Entry points run on the card: ``Dispatcher(device="cuda")`` is the default
and raises when no CUDA device is present; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from repro_torch import obs
from repro_torch.kernels import Precision, pad_batch, resolve_precision
from repro_torch.kernels.backend import dtype_name, torch_dtype

__all__ = ["Dispatcher", "DrainError", "ExecutableCache", "InFlight",
           "resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device`` for a serving entry point; raises when a CUDA device
    is asked for and none is present (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


class DrainError(RuntimeError):
    """Aggregate of per-chunk finalization failures from ``pump``/``drain``.

    ``failures`` is ``[(InFlight, exception), ...]`` — every failed chunk,
    not just the first: a raise from one in-flight chunk must never orphan
    the other double-buffered chunks' tickets, so pump/drain finalize every
    chunk they can and report the casualties together afterwards.
    """

    def __init__(self, failures: list):
        self.failures = list(failures)
        detail = "; ".join(
            f"{infl.key[0]}[{infl.nb}]: {type(e).__name__}: {e}"
            for infl, e in self.failures)
        super().__init__(
            f"{len(self.failures)} in-flight chunk(s) failed to finalize: "
            f"{detail}")


class ExecutableCache:
    """Bounded LRU of built executables, keyed by hashable signatures.

    ``get(key, build)`` returns the cached value or builds, inserts, and
    evicts the least-recently-used entry past ``maxsize``.
    """

    def __init__(self, maxsize: int = 32):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._entries: OrderedDict = OrderedDict()

    def get(self, key, build):
        try:
            value = self._entries[key]
            self._entries.move_to_end(key)
            self.hits += 1
            return value
        except KeyError:
            pass
        self.misses += 1
        value = build()
        self._entries[key] = value
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return value

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries)

    def clear(self) -> None:
        """Drop every cached executable (rebuilt on next use); hit/miss
        counters are kept."""
        self._entries.clear()


@dataclass
class InFlight:
    """One enqueued chunk awaiting finalization (blocking + accounting)."""

    key: tuple             # group signature
    nb: int                # real (un-padded) request count in the chunk
    outs: list             # per-request results (tensors or tuples of tensors)
    event: object = None   # torch.cuda.Event recorded after the chunk, or None
    t0: float = 0.0        # host perf_counter at stack start (obs only)
    flops: object = None   # () -> analytic useful-work flops of the chunk
    r_factor: object = None  # batched R for factor-health gauges (or None)
    record: bool = False   # obs was collecting at dispatch time
    done_at: float | None = None
    finalized: bool = False

    def ready(self) -> bool:
        """True when the chunk's device work is complete (non-blocking)."""
        return self.event is None or self.event.query()

    def block(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class Lanes(list):
    """One chunk's per-request results: views into the chunk's batched
    outputs (a tuple per request, or the bare tensor when there is one
    output), with those outputs kept in ``batched`` so a check over the
    whole chunk reads them in one pass."""

    def __init__(self, batched: tuple, bare: bool = False):
        super().__init__(batched[0].unbind(0) if bare else zip(*batched))
        self.batched = batched


def _pad_to(x: torch.Tensor, batch: int) -> torch.Tensor:
    """Zero-pad dim 0 up to exactly ``batch`` rows (no-op when already there)."""
    if x.shape[0] == batch:
        return x
    return pad_batch(x, batch)


@dataclass
class Dispatcher:
    """Chunked, padded executor for closed batches.

    ``backend`` ("pallas" — the kernel path — | "reference"), ``max_batch``
    chunk granularity, ``block_b`` padding granularity, ``device`` the
    serving device (the card unless the caller asks for the CPU).
    ``double_buffer`` selects async (see module docstring); ``cache_size``
    bounds the executable cache.
    """

    backend: str = "pallas"
    max_batch: int = 64
    device: object = "cuda"
    block_b: int = 8
    double_buffer: bool = False
    cache_size: int = 32
    precision: object | None = None  # Precision | policy name | None
    executables: ExecutableCache = None  # built in __post_init__
    _inflight: list = field(default_factory=list)
    _seen_dispatch: set = field(default_factory=set)  # (group, padded_B), obs only

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.executables is None:
            self.executables = ExecutableCache(self.cache_size)
        if self.precision is not None:
            self.precision = resolve_precision(self.precision)

    # ------------------------------------------------------------ precision
    def block_b_for(self, dtype) -> int:
        """Storage-scaled batch granularity for one group's at-rest dtype:
        2-byte storage (bf16/f16) groups run — and pad — at double
        ``block_b``."""
        try:
            scale = 2 if torch_dtype(dtype).itemsize <= 2 else 1
        except TypeError:
            scale = 1
        return self.block_b * scale

    def _chunk_precision(self, store_dtype: str):
        """``(compute_dtype, kernel_precision)`` for a group stored at
        ``store_dtype``.

        No policy installed: compute at storage dtype.  With a policy, the
        chunk computes at ``promote_types(store, policy)``; under an explicit
        bf16/f16 policy the low-precision groups stay at tile dtype and the
        kernels get the mixed policy (wide accumulation); f64 groups always
        pass through untouched.
        """
        if self.precision is None:
            return store_dtype, None
        cd = torch.promote_types(torch_dtype(store_dtype), self.precision.compute)
        if cd.itemsize <= 2:
            return dtype_name(cd), Precision(dtype_name(cd),
                                             self.precision.accum_dtype,
                                             store_dtype)
        return dtype_name(cd), None

    # ------------------------------------------------------------- padding
    def padded_chunk(self, nb: int, kind: str, dtype=None) -> int:
        """Batch size a dispatch of ``nb`` requests actually runs at, after
        pad_batch rounding to ``block_b`` (``block_b_for(dtype)`` for a
        group stored at ``dtype``) — for every kind and backend, so deadline
        closes of arbitrary size run at few batch shapes."""
        gran = self.block_b if dtype is None else self.block_b_for(dtype)
        return -(-nb // gran) * gran

    # ----------------------------------------------------------- executors
    def _kernel_opts(self, store_dtype: str) -> dict:
        return dict(backend=self.backend, block_b=self.block_b_for(store_dtype),
                    precision=self._chunk_precision(store_dtype)[1])

    def _stack(self, chunk, i: int, P: int, compute_dt: str) -> torch.Tensor:
        x = _pad_to(torch.stack([r.arrays[i] for r in chunk]), P)
        return x.to(torch_dtype(compute_dt))

    def _exec_append(self, chunk):
        """Stack + pad one append chunk, dispatch the fused batched kernel.

        Like every executor, returns ``(outs, flops, r_factor)``: the
        per-request results, a callable giving the chunk's model flops (only
        called when a collector records it) and the batched R factor for
        the health gauges (None for the solve kinds)."""
        from repro_torch.solvers import qr_append_rows_batched

        nb = len(chunk)
        store_dt = dtype_name(chunk[0].arrays[0].dtype)
        compute_dt, _ = self._chunk_precision(store_dt)
        P = self.padded_chunk(nb, "append", store_dt)
        store = torch_dtype(store_dt)
        Rb, Ub = (self._stack(chunk, i, P, compute_dt) for i in (0, 1))
        n, p = Rb.shape[2], Ub.shape[1]
        if chunk[0].arrays[2] is not None:
            db, Yb = (self._stack(chunk, i, P, compute_dt) for i in (2, 3))
            Rn, dn = qr_append_rows_batched(Rb, Ub, db, Yb,
                                            **self._kernel_opts(store_dt))
            Rn = Rn[:nb].to(store)  # down-cast to storage on return
            dn = dn[:nb].to(store)
            outs = Lanes((Rn, dn))
            w = n + Yb.shape[2]
        else:
            Rn = qr_append_rows_batched(Rb, Ub, **self._kernel_opts(store_dt))
            Rn = Rn[:nb].to(store)
            outs = Lanes((Rn,), bare=True)
            w = n
        return outs, lambda: nb * obs.ggr_append_flops(n, p, w), Rn

    def _exec_lstsq(self, chunk):
        """Stack + pad one lstsq chunk, dispatch the batched augmented sweep.

        The zero problems that pad the chunk are rank-collapsed by
        construction, so the eager rank check is switched off explicitly."""
        from repro_torch.solvers import ggr_lstsq

        nb = len(chunk)
        store_dt = dtype_name(chunk[0].arrays[0].dtype)
        compute_dt, _ = self._chunk_precision(store_dt)
        P = self.padded_chunk(nb, "lstsq", store_dt)
        Ab, bb = (self._stack(chunk, i, P, compute_dt) for i in (0, 1))
        fit = ggr_lstsq(Ab, bb, check_rank=False)
        store = torch_dtype(store_dt)
        xs = fit.x[:nb].to(store)  # down-cast to storage on return
        rs = fit.resid[:nb].to(store)
        m, n = Ab.shape[1], Ab.shape[2]
        k = bb.shape[2] if bb.ndim > 2 else 1
        return Lanes((xs, rs)), lambda: nb * obs.lstsq_flops(m, n, k), None

    def _exec_kalman(self, chunk):
        """Stack + pad one kalman chunk, dispatch the fused SRIF step.

        Model operands (F, Qi, H, z, G) that are the SAME tensor object
        across the whole chunk — one dynamics model, many tracks — stay 2-D
        and broadcast inside ``kf_step_batched`` instead of stacking B
        redundant copies; per-filter models stack (and pad) normally.
        """
        from repro_torch.solvers.kalman import kf_step_batched

        nb = len(chunk)
        store_dt = dtype_name(chunk[0].arrays[0].dtype)
        compute_dt, _ = self._chunk_precision(store_dt)
        P = self.padded_chunk(nb, "kalman", store_dt)
        has_G = chunk[0].arrays[6] is not None

        def fld(i):
            if i >= 2 and all(r.arrays[i] is chunk[0].arrays[i] for r in chunk):
                # shared: broadcast, don't stack
                return chunk[0].arrays[i].to(torch_dtype(compute_dt))
            return self._stack(chunk, i, P, compute_dt)

        cols = [fld(i) for i in range(7 if has_G else 6)]
        n, w, p = cols[0].shape[-1], cols[3].shape[-1], cols[4].shape[-2]
        Rn, dn = kf_step_batched(*cols[:6], cols[6] if has_G else None,
                                 **self._kernel_opts(store_dt))
        store = torch_dtype(store_dt)
        Rn = Rn[:nb].to(store)  # down-cast to storage on return
        dn = dn[:nb].to(store)
        # fused SRIF stack: (w + 2n + p, w + n + 1) with w + n pivots
        # -> n + p rows ride below the (triangular-by-construction) top
        return (Lanes((Rn, dn)),
                lambda: nb * obs.ggr_append_flops(w + n, n + p, w + n + 1), Rn)

    def _exec_lstsq_pivoted(self, chunk):
        """Stack + pad one rank-revealing lstsq chunk: the batched QRCP
        min-norm solve (``ranks.lstsq_pivoted``).  Per-request result is
        ``(x, resid, rank)`` — rank stays int32.  Padded lanes are all-zero
        problems, whose pivoted sweep is an exact fixed point (rank 0,
        x = 0), so slicing them off is lossless."""
        from repro_torch.ranks import lstsq_pivoted

        nb = len(chunk)
        store_dt = dtype_name(chunk[0].arrays[0].dtype)
        compute_dt, _ = self._chunk_precision(store_dt)
        P = self.padded_chunk(nb, "lstsq_pivoted", store_dt)
        Ab, bb = (self._stack(chunk, i, P, compute_dt) for i in (0, 1))
        fit = lstsq_pivoted(Ab, bb)
        store = torch_dtype(store_dt)
        xs = fit.x[:nb].to(store)  # down-cast to storage on return
        rs = fit.resid[:nb].to(store)
        rk = fit.rank[:nb]
        m, n = Ab.shape[1], Ab.shape[2]
        k = bb.shape[2] if bb.ndim > 2 else 1
        # pivoting adds the per-step suffix-norm matrix + swap on top of the
        # plain augmented sweep: ~2x the unpivoted macro-op count
        return (Lanes((xs, rs, rk)),
                lambda: nb * 2.0 * obs.lstsq_flops(m, n, k), None)

    _EXECUTORS = {"append": _exec_append, "lstsq": _exec_lstsq,
                  "kalman": _exec_kalman,
                  "lstsq_pivoted": _exec_lstsq_pivoted}

    # ------------------------------------------------------------ dispatch
    def dispatch(self, key: tuple, reqs: list,
                 cycle: int = 0) -> tuple[list, list[InFlight]]:
        """Dispatch one closed batch in ``max_batch`` chunks.

        Returns ``(outs, handles)``: per-request results in submission
        order, plus one ``InFlight`` handle per chunk.  In double-buffer
        mode the handles are un-finalized (the caller pumps/drains them);
        otherwise they are finalized here, chunk by chunk, before the next
        chunk is stacked.  ``cycle`` is the batch cycle being dispatched
        (unused here; part of the signature a resilient dispatcher keys on).
        """
        kind = key[0]
        exec_one = self._EXECUTORS[kind]
        outs: list = []
        handles: list[InFlight] = []
        for lo in range(0, len(reqs), self.max_batch):
            chunk = reqs[lo:lo + self.max_batch]
            rec = obs.enabled()
            t0 = time.perf_counter() if rec else 0.0
            chunk_outs, flops, r_factor = exec_one(self, chunk)
            outs.extend(chunk_outs)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            infl = InFlight(key, len(chunk), chunk_outs, event, t0, flops,
                            r_factor, rec)
            if rec:
                # the first dispatch of a (group, padded batch) signature is
                # the one a compiled path would build an executable for
                sig = (key, self.padded_chunk(len(chunk), kind, key[2]))
                if sig not in self._seen_dispatch:
                    self._seen_dispatch.add(sig)
                    obs.counter("serve.executable_cache_miss", kind=kind).inc()
            if self.double_buffer:
                self._inflight.append(infl)
            else:
                self.finalize(infl)
            handles.append(infl)
        return outs, handles

    # -------------------------------------------------------- finalization
    def finalize(self, infl: InFlight) -> None:
        """Mark one chunk finalized, stamping ``done_at`` once it is ready;
        when it was dispatched under a collector, block on it and record its
        dispatch metrics."""
        if infl.finalized:
            return
        infl.finalized = True
        if not infl.record:
            if infl.done_at is None and infl.ready():
                infl.done_at = time.perf_counter()
            return
        infl.block()
        if infl.done_at is None:
            infl.done_at = time.perf_counter()
        kind = infl.key[0]
        store_dt = infl.key[2]  # first required operand's dtype name
        compute_dt, kernel_prec = self._chunk_precision(store_dt)
        accum_dt = (kernel_prec.accum_dtype if kernel_prec is not None
                    else compute_dt)
        flops = infl.flops()
        obs.record_dispatch("serve", flops, infl.done_at - infl.t0,
                            by_dtype=obs.flops_by_dtype(flops, compute_dt,
                                                        accum_dt),
                            kind=kind, precision=compute_dt)
        padded = self.padded_chunk(infl.nb, kind, store_dt)
        obs.gauge("serve.padding_waste", kind=kind).set(
            (padded - infl.nb) / padded if padded else 0.0)
        if infl.r_factor is not None:
            obs.factor_health(infl.r_factor, "serve", kind=kind)

    def pump(self) -> int:
        """Finalize every in-flight chunk whose device work is done
        (non-blocking).  Returns the number finalized cleanly; failures are
        aggregated into one ``DrainError`` after every ready chunk has been
        attempted."""
        done = [i for i in self._inflight if i.ready()]
        failures = []
        ok = 0
        for infl in done:
            if infl.done_at is None:
                infl.done_at = time.perf_counter()
            try:
                self.finalize(infl)
                ok += 1
            except Exception as e:  # noqa: BLE001 — aggregated below
                infl.finalized = True  # terminal: don't re-finalize later
                failures.append((infl, e))
        self._inflight = [i for i in self._inflight if not i.finalized]
        if failures:
            raise DrainError(failures)
        return ok

    def drain(self) -> int:
        """Block on and finalize ALL in-flight chunks.

        Returns the count finalized cleanly.  Every chunk is attempted even
        when an earlier one raises; failures are re-raised together as one
        ``DrainError`` at the end.
        """
        pending = self._inflight
        self._inflight = []
        failures = []
        ok = 0
        for infl in pending:
            try:
                infl.block()
                if infl.done_at is None:
                    infl.done_at = time.perf_counter()
                self.finalize(infl)
                ok += 1
            except Exception as e:  # noqa: BLE001 — aggregated below
                infl.finalized = True
                failures.append((infl, e))
        if failures:
            raise DrainError(failures)
        return ok

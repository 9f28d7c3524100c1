"""QR solver serving front-door: micro-batched solve/update dispatch.

The realistic heavy-traffic QR workload is millions of *small* independent
requests (RLS/Kalman state updates, windowed regressions), not one giant
factorization.  ``QRServer`` is the closed-loop batching facade over the
layered serving engine in ``repro_torch.serve`` (typed requests -> continuous
batcher -> padded dispatch -> admission policy): requests accumulate in
per-(kind, shape, dtype) groups; ``flush()`` stacks each group and
dispatches ONE fused call per group — the batched row-append kernel for
row-appends and SRIF Kalman steps, a batched augmented-GGR sweep for
one-shot lstsq — then scatters results back to submission order.
``backend="reference"`` runs the same semantics through plain PyTorch sweeps
for A/B checking.

Request kinds: ``append`` (row-append a compact ``(R, d)`` state), ``lstsq``
(one-shot solve), ``kalman`` (one square-root information filter
predict+observe step, batched through ``kf_step_batched``), and
``lstsq_pivoted`` (rank-revealing one-shot solve returning
``(x, resid, rank)``).

The server runs on the card (``device="cuda"``) unless the caller asks for
the CPU; with no CUDA device and the default it raises.

Sharded serving: pass ``mesh=`` (a 1-D ``parallel.BatchMesh``, e.g. from
``repro_torch.parallel.make_batch_mesh``) and every flushed group is split
over the mesh's batch axis — the fused kernel runs once per shard on its
slice of the stacked requests.  Groups are zero-padded up to ``shards x
block_b`` (``shards`` for the lstsq kinds) so every shard gets the same
number of problems; results are gathered on the serving device and sliced
back, so sharded and single-device flushes of the kernel kinds agree bit for
bit.

    PYTHONPATH=src python -m repro_torch.launch.serve_qr --requests 64 \
        --n 16 --rows 8 --backend pallas --device cuda

    # 4-way sharded flush on the host (four shards of the CPU):
    PYTHONPATH=src python -m repro_torch.launch.serve_qr --device cpu \
        --requests 67 --mesh 4

emits one CSV line per run with throughput; ``--check`` folds a cross-backend
max-error into the ``derived`` column (rows always have exactly 3 fields).
``--resilient`` serves through the fault-tolerant dispatcher
(``repro_torch.serve.resilience``).  ``--mesh N`` shards over N distinct
cards (``--device cuda``) or N shards of the host (``--device cpu``); more
cards than are visible exits non-zero with the mesh's message.

Observability: the serving layers are instrumented with ``repro_torch.obs``
— per-kind queue-depth gauges, submit->flush queue-wait and flush-duration
histograms, batch-size, batch-close-reason and padding-waste tracking,
executable-cache-miss counters, factor-health gauges, and per-dispatch
achieved-GFLOP/s from the ``core.counts`` models.  All of it is a no-op
until a collector is installed (``obs.install``/``obs.collecting``);
``--metrics PREFIX`` installs one for the CLI run and writes
``PREFIX.jsonl`` + ``PREFIX.prom`` snapshots (also triggered by the
``REPRO_OBS_SNAPSHOT`` environment variable); the CSV stays on stdout and
the note naming the files goes to stderr.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve import (ContinuousBatcher, Dispatcher,
                               ResilientDispatcher, Ticket)

__all__ = ["QRServer", "make_workload"]


@dataclass
class QRServer:
    """Micro-batching dispatcher for QR solve/update requests.

    Thin closed-loop facade over ``repro_torch.serve``: submits admit into
    the engine's per-group open batches, and only ``flush()`` closes them (no
    deadlines, unbounded admission, latest-cycle result retention).

    backend: "pallas" (the fused batched kernel path) or "reference" (plain
    PyTorch sweeps).  max_batch: dispatch granularity — each group is flushed
    in chunks of at most this many stacked requests.  device: where requests
    are stacked and solved — the card by default.  mesh/mesh_axis: optional
    1-D ``parallel.BatchMesh`` (``device`` one of its devices); when set,
    each chunk is split over ``mesh_axis`` with the batch padded to
    ``shards x block_b`` (appends/kalman) or ``shards`` (lstsq kinds) and
    gathered back on ``device``.  resilient: serve through
    ``ResilientDispatcher`` (failure domains, retry/degrade, quarantine;
    bitwise equal to the plain dispatcher when nothing fails).  Requests of
    the same shape but different dtypes land in *different* groups —
    stacking never silently promotes a request's dtype.
    """

    backend: str = "pallas"
    max_batch: int = 64
    device: str = "cuda"
    mesh: object | None = None  # parallel.BatchMesh
    mesh_axis: str = "batch"
    block_b: int = 8
    precision: object | None = None  # Precision | policy name | None
    resilient: bool = False  # fault-tolerant dispatch (serve.resilience)

    def __post_init__(self):
        dispatcher_cls = ResilientDispatcher if self.resilient else Dispatcher
        self._engine = ContinuousBatcher(
            dispatcher_cls(backend=self.backend, max_batch=self.max_batch,
                           device=self.device, mesh=self.mesh,
                           mesh_axis=self.mesh_axis, block_b=self.block_b,
                           double_buffer=False, precision=self.precision),
            admit_max=None, retain_cycles=1)

    @property
    def _submit_times(self) -> dict:
        """Pending per-group submit timestamps (empty when uninstrumented)."""
        return {k: b.submit_times for k, b in self._engine._open.items()
                if b.submit_times}

    @property
    def _seen_dispatch(self) -> set:
        """(group, padded-batch) signatures already dispatched (obs-only)."""
        return self._engine.dispatcher._seen_dispatch

    # ------------------------------------------------------------- submits
    def submit_append(self, R, U, d=None, Y=None) -> Ticket:
        """Queue a row-append update of one (R[, d]) state."""
        return self._engine.submit("append", R, U, d, Y)

    def submit_lstsq(self, A, b) -> Ticket:
        """Queue a one-shot least-squares solve min ||Ax - b||."""
        return self._engine.submit("lstsq", A, b)

    def submit_lstsq_pivoted(self, A, b) -> Ticket:
        """Queue a rank-revealing least-squares solve (ill-posed traffic).

        The result is ``(x, resid, rank)`` with ``x`` the min-norm solution
        over the detected numerical rank and ``rank`` an int32 scalar.
        """
        return self._engine.submit("lstsq_pivoted", A, b)

    def submit_kalman(self, R, d, F, Qi, H, z, G=None) -> Ticket:
        """Queue one SRIF predict+observe step of a ``(R, d)`` Kalman state.

        Arguments follow ``repro_torch.solvers.kalman.kf_step``.  Passing the
        *same* tensor object (on the server's device) for a model operand
        across requests lets the executor broadcast it instead of stacking
        copies.
        """
        return self._engine.submit("kalman", R, d, F, Qi, H, z, G)

    # ------------------------------------------------------------ serving
    def pending(self) -> int:
        """Number of submitted requests not yet dispatched by a flush."""
        return self._engine.pending()

    def flush(self, kind: str | None = None) -> int:
        """Dispatch queued groups; returns the number of requests served.

        ``kind`` (None | "append" | "lstsq" | "kalman" | "lstsq_pivoted")
        restricts the flush to matching groups.  Results become available
        via ``result(ticket)``; each flushed group's cycle counter advances
        (a later flush of the same group expires its tickets, flushes of
        other groups don't).
        """
        return self._engine.flush(kind)

    def drain(self) -> int:
        """Block until every stored flush result is device-complete.

        ``flush`` returns as soon as the last kernel is *enqueued*; a
        throughput measurement must drain every group.  Returns the number
        of results waited on.
        """
        return self._engine.drain()

    def result(self, ticket: Ticket):
        """Fetch a flushed request's result.

        Raises KeyError if the ticket's group has not been flushed since the
        request was queued, or if a later flush of the same group already
        replaced the result.
        """
        return self._engine.result(ticket)


def make_workload(num: int, n: int, rows: int, k: int, seed: int = 0,
                  device="cuda"):
    """Synthetic request mix covering all four kinds and their edge forms:
    row-append updates (1/2, every 4th of them a bare no-rhs append), SRIF
    Kalman steps (1/4, alternating fleet-shared model matrices — the
    broadcast case — with per-track models), one-shot solves (1/4, split
    between well-conditioned plain ``lstsq`` and deliberately rank-deficient
    ``lstsq_pivoted`` requests).

    Draws exactly the numpy stream of the JAX package's ``make_workload``,
    so both packages serve the same requests.  The shared model matrices are
    ONE set of tensors on ``device`` (the serving device), so every
    shared-model request carries the *same* objects and the executor
    broadcasts instead of stacking copies; every other operand is numpy.
    """
    rng = np.random.default_rng(seed)

    def _triu_spd(size):
        T = np.triu(rng.standard_normal((size, size))).astype(np.float32)
        np.fill_diagonal(T, np.abs(np.diag(T)) + 1.0)
        return T

    def _models():
        F = np.eye(n, dtype=np.float32) + 0.1 * rng.standard_normal(
            (n, n)).astype(np.float32)
        Qi = _triu_spd(n)
        H = rng.standard_normal((rows, n)).astype(np.float32)
        return F, Qi, H

    F_sh, Qi_sh, H_sh = (torch.as_tensor(M, device=device) for M in _models())

    reqs = []
    for i in range(num):
        if i % 4 == 3:
            if i % 8 == 3:
                # rank-deficient by construction: tall x thin product
                r = -(-n // 2)
                A = (rng.standard_normal((4 * n, r)) @
                     rng.standard_normal((r, n))).astype(np.float32)
                b = rng.standard_normal((4 * n, k)).astype(np.float32)
                reqs.append(("lstsq_pivoted", A, b))
                continue
            A = rng.standard_normal((4 * n, n)).astype(np.float32)
            b = rng.standard_normal((4 * n, k)).astype(np.float32)
            reqs.append(("lstsq", A, b))
        elif i % 4 == 1:
            R = _triu_spd(n)
            d = rng.standard_normal(n).astype(np.float32)
            z = rng.standard_normal(rows).astype(np.float32)
            if i % 8 == 1:
                reqs.append(("kalman", R, d, F_sh, Qi_sh, H_sh, z))
            else:
                reqs.append(("kalman", R, d, *_models(), z))
        else:
            R = _triu_spd(n)
            U = rng.standard_normal((rows, n)).astype(np.float32)
            if i % 8 == 4:
                reqs.append(("append", R, U))  # no-rhs: R-only update
                continue
            d = rng.standard_normal((n, k)).astype(np.float32)
            Y = rng.standard_normal((rows, k)).astype(np.float32)
            reqs.append(("append", R, U, d, Y))
    return reqs


def _submit_all(server, reqs):
    tickets = []
    for r in reqs:
        if r[0] == "lstsq":
            tickets.append(server.submit_lstsq(r[1], r[2]))
        elif r[0] == "lstsq_pivoted":
            tickets.append(server.submit_lstsq_pivoted(r[1], r[2]))
        elif r[0] == "kalman":
            tickets.append(server.submit_kalman(*r[1:]))
        else:
            tickets.append(server.submit_append(*r[1:]))
    return tickets


def _as_tuple(res) -> tuple:
    """Normalize a ticket result to a tuple of tensors.

    No-rhs appends resolve to ONE bare tensor; lstsq/kalman/rhs-append
    resolve to tuples.  Comparison code that ``zip``s two results would
    silently iterate matrix *rows* for the bare-tensor case — always
    normalize first.
    """
    return res if isinstance(res, tuple) else (res,)


def main(argv=None):
    """Serving CLI: run a synthetic workload through one timed flush.

    Emits one 3-field CSV row (name, req_per_s, derived); ``--mesh N``
    shards flushed groups over an N-device batch mesh, ``--check`` folds a
    cross-backend max-error into the derived column, and ``--metrics P`` (or
    ``REPRO_OBS_SNAPSHOT=P``) collects ``repro_torch.obs`` metrics for the
    run and writes ``P.jsonl`` + ``P.prom`` snapshots.
    """
    ap = argparse.ArgumentParser(prog="serve_qr")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--nrhs", type=int, default=1)
    ap.add_argument("--backend", default="pallas", choices=["pallas", "reference"])
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serving device (default: the card)")
    ap.add_argument("--mesh", type=int, default=1, metavar="N",
                    help="shard flushed groups over an N-device batch mesh "
                         "(N cards with --device cuda, N shards of the host "
                         "with --device cpu)")
    ap.add_argument("--check", action="store_true",
                    help="cross-check a sample of results against the other backend")
    ap.add_argument("--resilient", action="store_true",
                    help="serve through the fault-tolerant dispatcher "
                         "(failure domains, retry/degrade, quarantine; "
                         "bitwise equal to the plain path when nothing "
                         "fails)")
    ap.add_argument("--metrics", default=os.environ.get("REPRO_OBS_SNAPSHOT"),
                    metavar="PREFIX",
                    help="collect obs metrics and write PREFIX.jsonl + "
                         "PREFIX.prom snapshots (default: $REPRO_OBS_SNAPSHOT)")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh > 1:
        from repro_torch.parallel import make_batch_mesh

        try:
            mesh = make_batch_mesh(args.mesh, device=args.device)
        except ValueError as e:
            sys.exit(str(e))

    reg = None
    if args.metrics:
        reg = obs.MetricsRegistry()
        obs.install(reg)

    server = QRServer(backend=args.backend, max_batch=args.max_batch,
                      device=args.device, mesh=mesh, resilient=args.resilient)
    reqs = make_workload(args.requests, args.n, args.rows, args.nrhs,
                         device=args.device)

    tickets = _submit_all(server, reqs)  # warmup flush builds the kernels
    server.flush()
    server.drain()

    tickets = _submit_all(server, reqs)
    t0 = time.perf_counter()
    served = server.flush()
    server.drain()  # block on ALL flushed groups, not just the last ticket
    dt = time.perf_counter() - t0

    check = ""
    if args.check:
        other = QRServer(backend="pallas" if args.backend == "reference"
                         else "reference", max_batch=args.max_batch,
                         device=args.device)
        oticks = _submit_all(other, reqs)
        other.flush()
        err = 0.0
        for tk, ot in list(zip(tickets, oticks))[:: max(1, len(tickets) // 8)]:
            a, b = _as_tuple(server.result(tk)), _as_tuple(other.result(ot))
            err = max(err, max(float((x.double() - y.double()).abs().max())
                               for x, y in zip(a, b)))
        check = f";xbackend_maxerr={err:.2e}"

    # derived column is ';'-separated key=val pairs — rows stay 3 CSV fields
    print("name,req_per_s,derived")
    print(f"serve_qr_{args.backend}_n{args.n}_p{args.rows},{served / dt:.1f},"
          f"max_batch={args.max_batch};mesh={args.mesh};device={args.device}{check}")

    if reg is not None:
        meta = {"cli": "serve_qr", "backend": args.backend, "mesh": args.mesh,
                "device": args.device, "requests": args.requests, "n": args.n,
                "rows": args.rows, "req_per_s": served / dt}
        obs.write_jsonl(f"{args.metrics}.jsonl", reg, meta)
        obs.write_prometheus(f"{args.metrics}.prom", reg)
        obs.uninstall()
        print(f"serve_qr: wrote {args.metrics}.jsonl and {args.metrics}.prom",
              file=sys.stderr)


if __name__ == "__main__":
    main()

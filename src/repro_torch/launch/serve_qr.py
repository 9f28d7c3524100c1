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

    PYTHONPATH=src python -m repro_torch.launch.serve_qr --requests 64 \
        --n 16 --rows 8 --backend pallas --device cuda

emits one CSV line per run with throughput; ``--check`` folds a cross-backend
max-error into the ``derived`` column (rows always have exactly 3 fields).
``--mesh N`` (N > 1), ``--resilient`` and ``--metrics`` are not ported yet
and exit with code 2.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.serve import ContinuousBatcher, Dispatcher, Ticket

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
    are stacked and solved — the card by default.  Requests of the same shape
    but different dtypes land in *different* groups — stacking never silently
    promotes a request's dtype.
    """

    backend: str = "pallas"
    max_batch: int = 64
    device: str = "cuda"
    block_b: int = 8
    precision: object | None = None  # Precision | policy name | None

    def __post_init__(self):
        self._engine = ContinuousBatcher(
            Dispatcher(backend=self.backend, max_batch=self.max_batch,
                       device=self.device, block_b=self.block_b,
                       double_buffer=False, precision=self.precision),
            admit_max=None, retain_cycles=1)

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

    Emits one 3-field CSV row (name, req_per_s, derived); ``--check`` folds a
    cross-backend max-error into the derived column.
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
                    help="not ported yet: N > 1 exits with code 2")
    ap.add_argument("--check", action="store_true",
                    help="cross-check a sample of results against the other backend")
    ap.add_argument("--resilient", action="store_true",
                    help="not ported yet: exits with code 2")
    ap.add_argument("--metrics", default=None, metavar="PREFIX",
                    help="not ported yet: exits with code 2")
    args = ap.parse_args(argv)
    for flag, asked in (("--mesh N > 1", args.mesh > 1),
                        ("--resilient", args.resilient),
                        ("--metrics", args.metrics is not None)):
        if asked:
            ap.error(f"{flag} is not yet ported")

    server = QRServer(backend=args.backend, max_batch=args.max_batch,
                      device=args.device)
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
          f"max_batch={args.max_batch};device={args.device}{check}")


if __name__ == "__main__":
    main()

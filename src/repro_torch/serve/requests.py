"""Typed requests, tickets, and group signatures for the serving engine.

One request = one small QR problem (a row-append update, a one-shot
least-squares solve — plain or rank-revealing pivoted — or an SRIF Kalman
step).  Requests that may legally be
stacked into a single fused dispatch share a **group signature**: a hashable
tuple of the kind plus every operand's ``(shape, dtype)`` — dtypes included
so stacking never silently promotes a request (same-shape f32 and f64
requests land in *different* groups).

This module replaces the three near-identical tuple-key code paths the old
monolithic ``QRServer.submit_*`` methods carried: each kind declares its
operand list once in ``_SPECS`` and ``make_request`` derives the canonical
array tuple and signature.  The signature layout is kept byte-compatible
with the old keys (``(kind, shape, dtype, shape, dtype, ..., optional_sig)``)
so tickets issued by the old server and the new engine are interchangeable.

A ``Ticket`` names a request's place in the serving pipeline: its group,
its index within the batch cycle it was admitted to, and that cycle number.
Cycles advance when a batch *closes* (explicit flush, deadline expiry, or a
full batch — see ``serve.batcher``); results are stored per
``(group, cycle)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.backend import dtype_name

__all__ = ["KINDS", "Request", "Ticket", "group_signature", "make_request"]

KINDS = ("append", "lstsq", "kalman", "lstsq_pivoted")

# kind -> (required operand names, optional operand names).  Optional
# operands are all-or-nothing per *pair* for append (d with Y) and
# independent for kalman's G; their signature folds into one trailing
# tuple-or-None element exactly like the legacy keys did.
_SPECS = {
    "append": (("R", "U"), ("d", "Y")),
    "lstsq": (("A", "b"), ()),
    "kalman": (("R", "d", "F", "Qi", "H", "z"), ("G",)),
    "lstsq_pivoted": (("A", "b"), ()),
}


@dataclass(frozen=True)
class Ticket:
    """Claim check for one submitted request.

    ``group`` is the request's group signature, ``index`` its position
    within the batch cycle it was admitted to, ``cycle`` that cycle.  A
    ticket resolves exactly one closed batch's results; a later cycle of the
    same group expires it (see ``ResultStore`` retention).
    """

    kind: str          # "append" | "lstsq" | "kalman" | "lstsq_pivoted"
    group: tuple       # group signature the request queued under
    index: int         # position within its group's batch cycle
    cycle: int         # the group's batch cycle the request belongs to


@dataclass(frozen=True)
class Request:
    """One typed serving request: kind + operands in canonical order.

    ``arrays`` always has one slot per operand named in the kind's spec
    (required then optional), with ``None`` filling absent optionals — so
    executors index positionally without re-deriving which optional form
    the request took.
    """

    kind: str
    group: tuple
    arrays: tuple

    @property
    def has_optional(self) -> bool:
        return self.arrays[-1] is not None


def _sig(a) -> tuple:
    return (tuple(a.shape), dtype_name(a.dtype))


def group_signature(kind: str, required: tuple, optional: tuple) -> tuple:
    """The hashable stacking key: kind + per-operand (shape, dtype) pairs.

    Optional operands collapse into ONE trailing element: ``None`` when
    absent, else the flattened (shape, dtype, ...) tuple — matching the
    legacy ``QRServer`` key layout (``rhs_sig`` / ``g_sig``) bit for bit.
    """
    flat = []
    for a in required:
        flat.extend(_sig(a))
    if not optional:
        return (kind, *flat)
    present = [a for a in optional if a is not None]
    if not present:
        return (kind, *flat, None)
    opt = []
    for a in present:
        opt.extend(_sig(a))
    return (kind, *flat, tuple(opt))


def make_request(kind: str, *args, device=None, **kwargs) -> Request:
    """Build a typed ``Request`` from raw operands (the ``submit_*`` body).

    Positional/keyword operands follow the kind's spec order.  Arrays become
    tensors on ``device`` once here (``None`` keeps a tensor where it is);
    a tensor already on ``device`` passes through as the same object, and
    passing the *same* tensor for a model operand across requests is what
    lets the kalman executor detect a fleet-shared model and broadcast
    instead of stacking B copies.
    """
    if kind not in _SPECS:
        raise ValueError(f"unknown request kind {kind!r} (one of {KINDS})")
    req_names, opt_names = _SPECS[kind]
    values = dict(zip(req_names + opt_names, args))
    for k, v in kwargs.items():
        if k not in req_names + opt_names:
            raise TypeError(f"{kind} request has no operand {k!r}")
        if k in values:
            raise TypeError(f"duplicate operand {k!r}")
        values[k] = v
    missing = [k for k in req_names if values.get(k) is None]
    if missing:
        raise TypeError(f"{kind} request missing operands: {missing}")

    required = tuple(torch.as_tensor(values[k], device=device)
                     for k in req_names)
    optional = tuple(None if values.get(k) is None
                     else torch.as_tensor(values[k], device=device)
                     for k in opt_names)
    if kind == "append" and (optional[0] is None) != (optional[1] is None):
        raise ValueError("pass both d and Y, or neither")
    group = group_signature(kind, required, optional)
    return Request(kind, group, required + optional)

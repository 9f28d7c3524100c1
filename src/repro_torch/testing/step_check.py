"""One optimizer step held against another run of it (the JAX package's,
or the port's on another device): each leaf's update (p0 - p1) / lr and
each state leaf compared relative to its own rms, over the elements the
step's inputs determine.

    from repro_torch.testing.step_check import rms_gap, step_gaps, update_of

Two runs whose gradients agree to roundoff still disagree, by O(1) of an
update, where a first step amplifies roundoff:

- AdamW's first update is g / (|g| + eps), about sign(g): where |g| is
  near the gradients' own error its sign is roundoff (``sign_determined``).
- int8 error feedback rounds x / scale to an integer: an element within
  the gradients' error of a half-integer rounds either way, and its
  residual and payload move by one quantum (``off_ties``).
- Orthant's direction Q = M·R⁻¹ of a momentum of numerical rank r < n
  (tall orientation, n columns): Q's last n - r columns are the normalized
  residual of columns that depend on the ones before, which is roundoff
  (``leading_columns``).  olmo's LayerNorm (centred, without weights)
  gives every weight gradient a null vector, (1, ..., 1) along d_model,
  so r = n - 1 wherever d_model is the narrow side.

Everything is float64 numpy; the masks come from the reference run alone.
"""
from __future__ import annotations

import numpy as np

__all__ = ["leading_columns", "off_ties", "rms_gap", "sign_determined", "step_gaps",
           "update_of"]


def update_of(p0, p1, lr: float) -> np.ndarray:
    """(p0 - p1) / lr in float64: the step a leaf took, in units of lr."""
    return (np.asarray(p0, np.float64) - np.asarray(p1, np.float64)) / lr


def rms_gap(got, want, mask=None, of=None) -> float:
    """rms(got - want) / rms(want) over ``mask`` (every element if None);
    relative to rms(``of``) instead where it is given (a leaf that is the
    small difference of two large ones, measured against the large one); 0
    where both are exactly zero there."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    of = want if of is None else np.asarray(of, np.float64)
    if mask is not None:
        got, want, of = got[mask], want[mask], of[mask]
    err = float(np.sqrt(np.mean((got - want) ** 2))) if got.size else 0.0
    rms = float(np.sqrt(np.mean(of ** 2))) if of.size else 0.0
    return err / rms if rms > 0 else (0.0 if err == 0 else float("inf"))


def sign_determined(g, rel: float = 1e-3) -> np.ndarray:
    """Elements with |g| >= rel·rms(g): where a gradient (or a first
    moment, proportional to it after one step) is that large, roundoff
    cannot flip its sign while two runs' gradients agree within 1e-4 of
    rms."""
    g = np.abs(np.asarray(g, np.float64))
    return g >= rel * np.sqrt(np.mean(g ** 2))


def off_ties(residual, rel: float = 2e-2) -> np.ndarray:
    """Elements of an int8 error-feedback residual whose value before
    rounding lay at least ``rel`` / 2 of a quantum from a half-integer.  The
    residual is the rounding error, at most half a quantum; over a leaf of
    many elements its largest magnitude is that half quantum."""
    r = np.abs(np.asarray(residual, np.float64))
    return r < (1 - rel) * r.max()


def leading_columns(m, rel: float = 1e-5) -> tuple[np.ndarray, list[int]]:
    """(mask, ranks) of a stack of matrices ``m`` (..., a, b): each matrix's
    numerical rank r (singular values above rel·the largest) and a mask,
    shaped like ``m``, of the columns of its tall orientation (rows of a
    wide matrix) that a QR determines, the first r."""
    m = np.asarray(m, np.float64)
    a, b = m.shape[-2:]
    flat = m.reshape(-1, a, b)
    mask = np.zeros(flat.shape, bool)
    ranks = []
    for i, x in enumerate(flat):
        s = np.linalg.svd(x, compute_uv=False)
        r = int((s > rel * s[0]).sum()) if s[0] > 0 else 0
        ranks.append(r)
        if a >= b:
            mask[i, :, :r] = True
        else:
            mask[i, :r, :] = True
    return mask.reshape(m.shape), ranks


def step_gaps(p0: dict, got: tuple, want: tuple, lr: float, optimizer: str) -> dict:
    """Optimizer steps from parameters ``p0`` ({leaf: array}) to ``got`` and
    to ``want``, each a pair of dicts (params by leaf, optimizer state by
    its flattened path: ``.m/<leaf>``, ``.momentum/<leaf>``, ``.step``...).
    The worst leaf's update gap ``rms_gap(update_of(p0, got), update_of(p0,
    want))`` over the elements ``want`` determines (AdamW: its first moment
    ``sign_determined``; Orthant: a matrix's ``leading_columns`` of its
    momentum, a vector's momentum ``sign_determined``), and the worst state
    leaf's gap over every element, each as (leaf, gap); ``span``, the
    largest update difference over every element in units of lr;
    ``masked``, the largest share of a leaf masked; and the two steps'
    ``.step`` counts."""
    (gp, gs), (wp, ws) = got, want
    if sorted(gp) != sorted(wp) or sorted(gs) != sorted(ws):
        raise ValueError("step_gaps: the two steps' trees differ")
    first = ".m/" if optimizer == "adamw" else ".momentum/"
    masks = {}
    for k, p in p0.items():
        p = np.asarray(p)
        if optimizer == "orthant" and p.ndim >= 2 and min(p.shape[-2:]) > 1:
            masks[k] = leading_columns(ws[".momentum/" + k])[0]
        else:
            masks[k] = sign_determined(ws[first + k])
    update = {k: rms_gap(update_of(p0[k], gp[k], lr), update_of(p0[k], wp[k], lr), masks[k])
              for k in wp}
    state = {k: rms_gap(gs[k], ws[k]) for k in ws if not k.endswith(".step")}
    return {"update": max(update.items(), key=lambda kv: kv[1]),
            "state": max(state.items(), key=lambda kv: kv[1]),
            "span": max(float(np.abs(update_of(gp[k], wp[k], lr)).max()) for k in wp),
            "masked": max(1 - float(m.mean()) for m in masks.values()),
            "steps": (int(gs[".step"]), int(ws[".step"]))}

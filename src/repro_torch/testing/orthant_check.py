"""The Orthant direction check: olmo-1b's parameter tree at full width, the
blocked driver through the kernels' plain versions, and the readings that
hold each Orthant direction against its plain-version direction and against
``torch.linalg.qr``.

    from repro_torch.testing.orthant_check import direction_readings, olmo_tree

``chip_smoke.py`` phase 9 (c) applies its rule to these readings on random
momenta; ``tools/orthant_readings.py`` prints them, with those of two
faulty directions, to show where the rule's factor sits.  Phase 12 (b)
holds the trained momenta by ``momentum_readings``: each column of the
direction against a float64 one, relative to its own condition number.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs import get_config

__all__ = ["DETERMINED", "OLMO", "direction_readings", "momentum_readings", "olmo_leaves",
           "olmo_tree", "plain_driver"]

# olmo-1b at its published widths
OLMO = get_config("olmo-1b")
# a direction's column whose float32 error bound, u·cond_k, is over this is
# roundoff (``momentum_readings``)
DETERMINED = 0.1


def olmo_tree(gen: torch.Generator, depth: int, scale: bool, device=None) -> dict:
    """olmo-1b's parameter tree as ``models.transformer.init_lm`` lays it out
    (its paths, shapes and dtypes at ``depth`` = 16): embed (vocab, d),
    ``depth`` stacked layers of wq/wk/wv/wo (d, d) and the gated MLP's w1,
    w3 (d, ff) and w2 (ff, d); the non-parametric norms hold no leaves.
    Normal entries drawn from ``gen`` in this order on ``device`` (default:
    the generator's), scaled as ``init_lm`` scales them (``scale``) or unit
    (gradients)."""
    d, ff, vocab = OLMO.d_model, OLMO.d_ff, OLMO.vocab
    device = gen.device if device is None else device

    def normal(shape, s):
        x = torch.randn(shape, generator=gen, device=device)
        return x.mul_(s) if scale else x

    return {"embed": normal((vocab, d), d ** -0.5), "final_norm": {},
            "layers": {"attn": {k: normal((depth, d, d), d ** -0.5)
                                for k in ("wq", "wk", "wv", "wo")},
                       "n1": {}, "n2": {},
                       "mlp": {"w1": normal((depth, d, ff), d ** -0.5),
                               "w2": normal((depth, ff, d), ff ** -0.5),
                               "w3": normal((depth, d, ff), d ** -0.5)}}}


def olmo_leaves(tree: dict) -> dict:
    """The matrices of an ``olmo_tree``-shaped tree by path."""
    layers = tree["layers"]
    return {"embed": tree["embed"],
            **{f"layers/attn/{k}": v for k, v in layers["attn"].items()},
            **{f"layers/mlp/{k}": v for k, v in layers["mlp"].items()}}


def _also_kernel(hold, fn, call, plain_out) -> None:
    """Run ``call`` (kernel wrapper ``fn`` on a plain step's inputs) and hand
    ``hold`` each (shape, param, dtype, accum) it launched at with both
    results."""
    saved, fn.shapes = fn.shapes, set()
    try:
        out = call()
    finally:
        keys, fn.shapes = fn.shapes, saved | fn.shapes
    for key in sorted(keys, key=str):
        hold(fn.__name__, key, out, plain_out)


@contextlib.contextmanager
def plain_driver(hold=None):
    """The blocked driver's fused steps through the kernels' plain versions,
    on the tensors' own device: the whole-driver counterpart of holding a
    kernel against its plain version.  Launches nothing, unless ``hold`` is
    given: then each step also runs the kernel on the same inputs and
    ``hold(kernel name, (shape, param, dtype, accum) launched, kernel
    result, plain result)`` is called for each launch (a CPU tensor
    launches nothing)."""
    from repro_torch.core import blocked
    from repro_torch.kernels import ggr_apply, ggr_panel

    def panel_step(panel, pivot0=0, precision=None):
        res = ggr_panel.panel_factor_plain(panel, pivot0)
        if hold is not None:
            _also_kernel(hold, ggr_panel.panel_factor,
                         lambda: ggr_panel.panel_factor(panel, pivot0), res)
        return res

    def apply_step(V, T, C, pivot0=0, block_w=256, precision=None, out=None):
        res = ggr_apply.apply_factors_plain(V, T, C, pivot0)
        if hold is not None:  # before ``out``, which may be C, is written
            _also_kernel(hold, ggr_apply.apply_factors,
                         lambda: ggr_apply.apply_factors(V, T, C, pivot0), res)
        return res if out is None else out.copy_(res)

    saved = blocked.panel_factor, blocked.apply_factors
    blocked.panel_factor = panel_step
    blocked.apply_factors = apply_step
    try:
        yield
    finally:
        blocked.panel_factor, blocked.apply_factors = saved


def direction_readings(M: torch.Tensor, faults: bool = False, hold=None) -> dict:
    """Readings of the Orthant directions of a (B, a, b) f32 stack: under
    each name a pair of (B,) tensors, (max|QᵀQ - I|, max|Q - Q_lib·D|), of
    the tall orientation's Q.  Q_lib is ``torch.linalg.qr``'s Q of the same
    scaled tall matrix, and D matches each column's sign to the sign of the
    diag(R) the direction was made from.

    "kernels": ``orthant._orthogonalize`` (on the card, the kernels);
    "plain": its formula with the R of the same driver through the kernels'
    plain versions; "cusolver": its formula with ``torch.linalg.qr``'s R.
    With ``faults``, two faulty directions too — "flipped": the kernels'
    with its last column's sign flipped (the square sign case); "half": the
    formula with the R of the matrix rounded to float16 (a tile stored at
    half precision).  ``hold``: ``plain_driver``'s."""
    return momentum_readings(M, faults, hold=hold)["directions"]


def momentum_readings(M: torch.Tensor, faults: bool = False, plain: bool = True,
                      hold=None) -> dict:
    """``direction_readings`` under "directions"; under "gram" each R's
    backward error, ||RᵀR - MᵀM||_F / ||M||_F² of the scaled tall matrix
    ((B,) under "kernels", "plain" and "cusolver"); under "columns" the
    kernels' direction held column by column against orthant's formula in
    float64 (``torch.linalg.qr``'s R in float64 with GGR's signs: a
    positive diagonal, a square matrix's last one the plain driver's).
    Column k of Q = M·R⁻¹ depends on the first k + 1 columns alone, and its
    float32 error on u·cond_k, u = 2⁻²⁴ and cond_k the Frobenius condition
    number of the leading (k + 1) x (k + 1) block of the shifted R: a column
    with u·cond_k > DETERMINED is roundoff (its prefix holds a column that
    depends on those before it) and is left out.  (B,) under "determined"
    (columns held), "ratio" (the largest ||q_k - q_k,64|| / (u·cond_k) over
    them) and "signs_off" (held columns pointing away from the float64
    one's).  With ``faults``, the same two readings of two faulty
    directions under "flipped" (the kernels' with its first column's sign
    flipped) and "half" (from the R of the matrix rounded to float16), and
    "half" under "gram".  ``plain=False`` leaves out the plain versions'
    readings of a non-square matrix (the plain driver's R is slow at
    olmo-1b's widths, and only a square matrix's last sign needs it).
    ``hold``: ``plain_driver``'s, for the plain versions' R."""
    from repro_torch.core.blocked import ggr_triangularize_blocked
    from repro_torch.optim import orthant

    def r_factor(x):  # orthant's own R call
        return torch.triu(ggr_triangularize_blocked(
            x, min(x.shape[-2] - 1, x.shape[-1]), schedule="fused"))[..., :n, :]

    def shifted(R):  # orthant's eps shift
        diag = R.diagonal(dim1=-2, dim2=-1).abs()
        eye = torch.eye(n, dtype=R.dtype, device=R.device)
        return R + 1e-7 * (diag.amax(-1) + 1e-20)[:, None, None] * eye

    def formula(R, x):  # orthant's Q = M·R⁻¹
        q = torch.linalg.solve_triangular(shifted(R), x, upper=True, left=False)
        return torch.where(torch.isfinite(q), q, 0.0)

    tall = M if M.shape[-2] >= M.shape[-1] else M.mT
    mf = tall / torch.sqrt((tall * tall).mean((-2, -1), keepdim=True) + 1e-20)
    n = mf.shape[-1]
    eye = torch.eye(n, dtype=mf.dtype, device=mf.device)
    Q_lib, R_lib = torch.linalg.qr(mf)
    sign_lib = torch.sign(R_lib.diagonal(dim1=-2, dim2=-1))

    def read(Q, R):
        d = torch.sign(R.diagonal(dim1=-2, dim2=-1)) * sign_lib
        return ((Q.mT @ Q - eye).abs().amax((-2, -1)),
                (Q - Q_lib * d[:, None, :]).abs().amax((-2, -1)))

    def gram(R):
        R64, M64 = R.double(), mf.double()
        return (torch.linalg.matrix_norm(R64.mT @ R64 - M64.mT @ M64)
                / torch.linalg.matrix_norm(M64) ** 2)

    Q = orthant._orthogonalize(M)
    Q, R = (Q if M.shape[-2] >= M.shape[-1] else Q.mT), r_factor(mf)
    out = {"kernels": read(Q, R), "cusolver": read(formula(R_lib, mf), R_lib)}
    grams = {"kernels": gram(R), "cusolver": gram(R_lib)}
    if plain or mf.shape[-2] == n:
        with plain_driver(hold):
            R_plain = r_factor(mf)
        out["plain"] = read(formula(R_plain, mf), R_plain)
        grams["plain"] = gram(R_plain)

    # the float64 reference and each column's condition number
    m64 = mf.double()
    R64 = torch.linalg.qr(m64, mode="r").R
    sign = torch.sign(R64.diagonal(dim1=-2, dim2=-1))
    want = torch.ones_like(sign)
    if mf.shape[-2] == n:  # n - 1 pivots: the last row keeps its own sign
        want[:, -1] = torch.sign(R_plain[:, -1, -1]).double()
    R64 = R64 * (torch.where(sign == 0, 1.0, sign) * want)[:, :, None]
    Q64, Rs = formula(R64, m64), shifted(R64)
    Rinv = torch.linalg.solve_triangular(Rs, torch.eye(n, dtype=Rs.dtype, device=Rs.device)
                                         .expand_as(Rs), upper=True)
    cond = torch.sqrt(torch.cumsum(Rs.square().sum(-2), -1)
                      * torch.cumsum(Rinv.square().sum(-2), -1))
    bound = 2.0 ** -24 * cond
    held = bound <= DETERMINED

    def columns(Qx):
        Qx = Qx.double()
        err = torch.linalg.vector_norm(Qx - Q64, dim=-2)
        return (torch.where(held, err / bound, 0.0).amax(-1),
                ((Qx * Q64).sum(-2) <= 0).logical_and(held).sum(-1))

    ratio, off = columns(Q)
    cols = {"determined": held.sum(-1), "ratio": ratio, "signs_off": off}
    if faults:
        cols["flipped"] = columns(torch.cat([-Q[..., :1], Q[..., 1:]], -1))
        Q[..., -1] *= -1
        out["flipped"] = read(Q, R)
        R_half = r_factor(mf.half().float())
        Q_half = formula(R_half, mf)
        out["half"] = read(Q_half, R_half)
        cols["half"] = columns(Q_half)
        grams["half"] = gram(R_half)
    return {"directions": out, "gram": grams, "columns": cols}

"""How the CUDA kernels are held against their plain versions on the card
(``repro_torch.testing.kernel_check``), checked here on the CPU with the
plain versions.

The check that a bf16 / f16 kernel rounds its state at every step holds
each part of its outputs to ``ROUNDING`` times the plain version's error
from the exact result.  Here the plain version with f64 sums at the same
tile dtype stands in for a sound kernel (it rounds the state at the same
points, from other sums), and the f32 plain version rounded once to the
tile dtype is the fault the check is there for: the first must pass, the
second must fail, at shapes where a part has READ_ENTRIES entries.  Those
cases, each kernel's, are in ``test_torch_kernel_check_{update,geqrt,
panel,apply}.py``, one file a kernel so that they run on separate workers;
this file holds the checks that take no kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.backend import resolve_precision
from repro_torch.testing import kernel_check as kc

KERNELS = ("batched_update", "batched_geqrt", "panel_factor", "apply_factors")


def test_condition_leaves_a_tall_block_as_it_is():
    """A Gaussian block of TALL times as many rows as columns already has a
    condition number near 3: left untouched."""
    x = torch.randn((2, 4 * 64, 64), generator=torch.Generator().manual_seed(0))
    assert torch.equal(kc.condition_(x.clone(), "panel_factor", 0), x)


def test_parts_split_b1_and_b2_at_the_last_pivot():
    """B1's and B2's rows above the last pivot and below it; the rows above
    and B3's R and T are what the algorithm determines at a bf16 tile."""
    o = torch.arange(2 * 7 * 5.0).reshape(2, 7, 5)
    top, rest = kc.parts("batched_update", 4, (o,))
    assert torch.equal(top, o[:, :4]) and torch.equal(rest, o[:, 4:])
    top, rest = kc.parts("batched_geqrt", 7, (o,))
    assert torch.equal(top, o) and rest.numel() == 0
    R, V, T = o, 2 * o, 3 * o
    assert all(a is b for a, b in zip(kc.parts("panel_factor", 0, (R, V, T)), (R, V, T)))
    (held,) = kc.determined("batched_update", 4, (o,))
    assert torch.equal(held, o[:, :4])
    held = kc.determined("panel_factor", 0, (R, V, T))
    assert len(held) == 2 and held[0] is R and held[1] is T


def test_a_part_too_small_to_read_is_left_out():
    """A part the plain version misses in fewer than READ_ENTRIES entries
    gives no ratio, unless the kernel misses what it gets exactly."""
    e = torch.ones(4, 10)
    p = e.clone()
    p[0, 0] = 1.5
    assert kc.error_ratios([p * 3], [p], [e]) == []
    assert kc.error_ratios([e + 1], [e], [e]) == [np.inf]
    big = torch.ones(kc.READ_ENTRIES)
    off = big + 0.5
    assert kc.error_ratios([big + 0.75], [off], [big]) == [pytest.approx(1.5)]


def test_the_tables_cover_every_kernel_and_tile_dtype():
    """REL has an entry for each kernel at each tile dtype the kernels take,
    the mixed ones tighter than an output's rms; each mixed tile's POLICY
    resolves to that tile with f32 sums (ACCUM)."""
    for name in KERNELS:
        assert set(kc.REL[name]) == set(kc.ACCUM)
        assert all(kc.REL[name][d] < 1.0 + 1e-9 for d in kc.POLICY)
    for tile, policy in kc.POLICY.items():
        prec = resolve_precision(policy)
        assert (kc.dtype_name(prec.compute), prec.accum_dtype) == (tile, kc.ACCUM[tile])

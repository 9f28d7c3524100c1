"""How the CUDA kernels are held against their plain versions on the card
(``repro_torch.testing.kernel_check``), checked here on the CPU with the
plain versions.

The check that a bf16 / f16 kernel rounds its state at every step holds
each part of its outputs to ``ROUNDING`` times the plain version's error
from the exact result.  Here the plain version with f64 sums at the same
tile dtype stands in for a sound kernel (it rounds the state at the same
points, from other sums), and the f32 plain version rounded once to the
tile dtype is the fault the check is there for: the first must pass, the
second must fail, at shapes where a part has READ_ENTRIES entries.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.backend import resolve_precision
from repro_torch.testing import kernel_check as kc

KERNELS = ("batched_update", "batched_geqrt", "panel_factor", "apply_factors")
# (kernel, shape, param) with a part of at least READ_ENTRIES entries:
# B1's residual rows at the serving append's and the tree coupling's
# widths, B2's tiles, B3's V and T, B4's columns
CASES = [("batched_update", (2048, 40, 33), 32), ("batched_update", (8, 128, 192), 64),
         ("batched_geqrt", (8, 64, 128), 64), ("panel_factor", (1, 1024, 64), 0),
         ("apply_factors", (1, 512, 256), (64, 0))]


def _case(name, shape, param, dtype, seed=1):
    x, plain, _ = kc.mixed_inputs(name, shape, param, dtype,
                                  torch.Generator().manual_seed(seed))
    return x, plain


def _outs(name, param, r):
    return kc.parts(name, param, r if isinstance(r, tuple) else (r,))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,shape,param", CASES)
def test_rounding_at_every_step_is_told_from_rounding_once(name, shape, param, dtype):
    """Every part of a state rounded at every step (f64 sums) reads within
    ROUNDING; the f32 result rounded once reads below half its lower end on
    some part."""
    x, plain = _case(name, shape, param, dtype)
    ref = _outs(name, param, plain(x, "float32"))
    exact = _outs(name, param, plain(x.double(), None))
    sound, ratios = kc.per_step(_outs(name, param, plain(x, "float64")), ref, exact)
    assert ratios and sound, ratios
    once = tuple(o.to(dtype) for o in _outs(name, param, plain(x.float(), None)))
    fooled, once_ratios = kc.per_step(once, ref, exact)
    assert not fooled and min(once_ratios) < 0.5 * kc.ROUNDING[0], once_ratios


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,shape,param", CASES)
def test_a_sound_mixed_result_is_within_its_bound(name, shape, param, dtype):
    """The f64-summed stand-in lies within rel_bound (max|err| / rms) of the
    f32-summed plain version on every output: the bound has room for a
    sound kernel's other sums."""
    x, plain = _case(name, shape, param, dtype)
    got, want = plain(x, "float64"), plain(x, "float32")
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    bound = kc.rel_bound(name, shape[1], shape[2], dtype)
    assert max(kc.rel_err(a, b) for a, b in zip(got, want)) <= bound


@pytest.mark.parametrize("name,shape,param", [
    ("batched_update", (16, 104, 65), 64), ("batched_update", (16, 40, 33), 32),
    ("batched_geqrt", (16, 64, 128), 64), ("batched_geqrt", (16, 20, 24), 16),
    ("panel_factor", (4, 96, 64), 0), ("panel_factor", (4, 300, 40), 200),
    ("apply_factors", (4, 120, 30), (64, 0))])
def test_condition_makes_every_problem_well_conditioned(name, shape, param):
    """Each problem's pivot block (B1: the state [R; U] over its pivot
    columns; B2, B3, the panel behind B4: the rows from the first pivot
    down, over the pivot columns) has a condition number below 10 after
    condition_, where a Gaussian one reaches 10^3 and more."""
    B, m, w = shape
    g = torch.Generator().manual_seed(3)
    if name == "apply_factors":
        x = torch.randn((B, m, param[0]), generator=g, dtype=torch.float64)
    else:
        x = torch.randn(shape, generator=g, dtype=torch.float64)
    kc.condition_(x, name, param)
    if name == "batched_update":
        assert torch.equal(x[:, :param, :param], torch.triu(x[:, :param, :param]))
        block = x[:, :, :param]
    elif name == "batched_geqrt":
        block = x[:, :, :param]
    else:
        row0 = param if name == "panel_factor" else param[1]
        block = x[:, row0:]
    assert float(torch.linalg.cond(block).max()) < 10


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

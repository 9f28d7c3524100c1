"""How B4 (``apply_factors``) is held against its plain version on the card
(``repro_torch.testing.kernel_check``), checked here on the CPU with the
plain versions; ``test_torch_kernel_check.py`` says how, and holds the
checks that take no kernel.  One file a kernel, so the rounding cases of
the four kernels run on separate workers.
"""
import pytest
import torch

from repro_torch.testing import kernel_check as kc

# (kernel, shape, param) with a part of at least READ_ENTRIES entries, as
# ids the cases had in one file for all four kernels
CASES = [pytest.param("apply_factors", (1, 512, 256), (64, 0), id="apply_factors-shape4-param4")]
# problems condition_ must make well conditioned
CONDITION = [pytest.param("apply_factors", (4, 120, 30), (64, 0), id="apply_factors-shape6-param6")]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the suite's other workers, the plain
    versions' many small ops run far slower on a thread pool of every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("name,shape,param", CONDITION)
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


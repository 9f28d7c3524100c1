"""The port's suffix sums at a 2-byte accumulation, held against the
reference's, on the CPU.

``kernels.ggr_panel._revcumsum`` sums a bfloat16 / float16 input by the TPU
kernel's doubling ladder (the reference's ``_revcumsum(native=False)``):
``x[i] += x[i + d]`` for d = 1, 2, 4, ..., every step rounded at the input's
dtype.  The tests hold it bitwise to the reference's ladder, and every other
dtype bitwise to flip-cumsum-flip, as before.

The plain versions of B1 and B2 at (t, t) are then held against the
reference's kernels in interpret mode on the same numpy inputs.  Bitwise is
impossible there: in interpret mode the reference sums by
``lax.associative_scan``, another order, so the two round to different
values.  Each is held by its distance from the exact result (the port's
plain version in float64 on the same inputs): the port's over the
reference's within 0.5-2x, on the parts the algorithm determines at the
tile dtype (``kernel_check.determined``), each row signed as the exact
result's (``kernel_check.bulk_err``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.backend import Precision as RefPrecision
from repro.kernels.ggr_panel import _revcumsum as ref_revcumsum
from repro.kernels.ggr_panel import batched_geqrt_pallas
from repro.kernels.ggr_update import batched_update_pallas
from repro_torch.kernels import ggr_panel, ggr_update
from repro_torch.kernels.ggr_panel import _revcumsum
from repro_torch.testing import kernel_check as kc

NARROW = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
BAND = (0.5, 2.0)  # the port's error from f64 over the reference's


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy()


def _ref_bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("dname", list(NARROW))
def test_ladder_of_the_planning_vector_is_the_references(dname):
    """[2^-9] * 8 + [1]: the TPU kernel's ladder gives [1.015625, 1.0078125,
    ...] at bf16, which neither cumsum (an f32 carry) nor the interpret
    path's associative scan gives."""
    td, jd = NARROW[dname]
    v = np.array([2.0 ** -9] * 8 + [1.0])
    got = _revcumsum(torch.tensor(v, dtype=td))
    want = ref_revcumsum(jnp.asarray(v, jd), native=False)
    np.testing.assert_array_equal(_bits(got), _ref_bits(want))
    if dname == "bfloat16":
        assert got[:2].tolist() == [1.015625, 1.0078125]
        assert not torch.equal(got, torch.tensor(v, dtype=td).flip(0).cumsum(0).flip(0))


@pytest.mark.parametrize("dname", list(NARROW))
def test_ladder_is_the_references_bit_for_bit(dname):
    """Seeded Gaussian rows of every length 1-129: the port's bits, each
    length summed on its own along either axis, are the reference ladder's.
    The reference runs once per ladder depth, on the rows of every length
    of that depth zero-padded to the longest: its steps are the same, and
    a padded zero stays +0 and adds +0, as the ladder's own pad does, so
    each row's sums are bitwise those of a call at its own length."""
    td, jd = NARROW[dname]
    rng = np.random.default_rng(8)
    rows = {L: rng.standard_normal((3, L)).astype(np.float32) for L in range(1, 130)}
    depths = {}
    for L in rows:
        depths.setdefault((L - 1).bit_length(), []).append(L)
    for lengths in depths.values():
        top = max(lengths)
        padded = np.zeros((3 * len(lengths), top), np.float32)
        for k, L in enumerate(lengths):
            padded[3 * k:3 * k + 3, :L] = rows[L]
        want = _ref_bits(ref_revcumsum(jnp.asarray(padded).astype(jd), axis=1, native=False))
        for k, L in enumerate(lengths):
            x = torch.from_numpy(rows[L]).to(td)
            np.testing.assert_array_equal(_bits(_revcumsum(x, 1)), want[3 * k:3 * k + 3, :L],
                                          err_msg=f"L={L}")
            np.testing.assert_array_equal(_bits(_revcumsum(x.T.contiguous(), 0)),
                                          want[3 * k:3 * k + 3, :L].T, err_msg=f"L={L}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_sums_stay_flip_cumsum_flip(dtype):
    """At f32 / f64 the sums are bitwise the flip-cumsum-flip they were."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((5, 67, 9), generator=g, dtype=dtype)
    for dim in (0, 1, 2, -1):
        assert torch.equal(_revcumsum(x, dim), x.flip(dim).cumsum(dim).flip(dim))


def _inputs(name: str, shape, param, dname: str, seed: int):
    """Seeded Gaussian inputs conditioned as the card checks take them
    (``kc.condition_``; B1's top rows upper triangular), at the tile dtype."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape))
    if name == "batched_update":
        x[:, :param, :param] = torch.triu(x[:, :param, :param])
    return kc.condition_(x, name, param).to(NARROW[dname][0])


@pytest.mark.parametrize("dname", list(NARROW))
@pytest.mark.parametrize("name,shape,param", [("batched_update", (24, 28, 21), 16),
                                              ("batched_geqrt", (12, 32, 48), 32)])
def test_plain_narrow_versions_err_as_the_reference_kernels(name, shape, param, dname):
    """B1's / B2's plain version at (t, t) and the reference's kernel in
    interpret mode at Precision(t, t, t), on the same inputs: each part's
    error from the exact result (the plain version in f64), the port's over
    the reference's, within BAND."""
    x = _inputs(name, shape, param, dname, seed=11)
    prec = RefPrecision(dname, dname, dname)
    jx = jnp.asarray(x.float().numpy()).astype(NARROW[dname][1])
    if name == "batched_update":
        got = ggr_update.batched_update_plain(x, param, dname)
        ref = batched_update_pallas(jx, param, interpret=True, precision=prec)
        exact = ggr_update.batched_update_plain(x.double(), param)
    else:
        got = ggr_panel.batched_geqrt_plain(x, param, dname)
        ref = batched_geqrt_pallas(jx, param, interpret=True, precision=prec)
        exact = ggr_panel.batched_geqrt_plain(x.double(), param)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert got.dtype == x.dtype
    for g, r, e in zip(*(kc.determined(name, param, (o,)) for o in (got, ref, exact))):
        ratio = kc.bulk_err(g, e) / kc.bulk_err(r, e)
        assert BAND[0] <= ratio <= BAND[1], ratio

"""Port parity: core.counts — the paper's eqs. 3-5 models and the op census
— against the JAX package, plus the paper's claim measured on the port's own
column step."""
import itertools

import jax.numpy as jnp
import pytest
import torch

import repro.core.counts as jcounts
from repro import obs as jobs
from repro.core.baselines import _rot_pair as j_rot_pair
from repro.core.ggr import ggr_column_step as j_column_step
from repro.core.ggr import ggr_column_step_at as j_column_step_at
from repro_torch import obs
from repro_torch.core import counts
from repro_torch.core.baselines import _rot_pair
from repro_torch.core.ggr import ggr_column_step, ggr_column_step_at
from repro_torch.kernels import ggr_update

_GRID = list(itertools.product((1, 2, 5, 16, 33), (1, 3, 8, 17, 40),
                               (None, 1, 4, 16), (0, 1, 3, 8)))


@pytest.mark.parametrize("model", ["cgr_mults", "gr_mults", "alpha_ratio"])
def test_square_models_equal_the_reference(model):
    for n in range(1, 65):
        assert getattr(counts, model)(n) == getattr(jcounts, model)(n)


def test_rectangular_models_equal_the_reference():
    for m, w, npiv, p in _GRID:
        assert counts.ggr_sweep_mults(m, w, npiv) == jcounts.ggr_sweep_mults(m, w, npiv)
        assert counts.ggr_append_mults(m, p, w) == jcounts.ggr_append_mults(m, p, w)
        assert counts.householder_qr2_mults(m, w) == jcounts.householder_qr2_mults(m, w)
        assert counts.mults_to_flops(m * w) == jcounts.mults_to_flops(m * w)
    for n in range(1, 65):
        assert counts.ggr_sweep_mults(n, n, n) == counts.cgr_mults(n)


def _unrolled(step, n):
    def run(A):
        X = A
        for c in range(n - 1):
            X = step(X, c)
        return X
    return run


def test_census_of_the_column_loop_scales_as_eq3():
    """The census of the port's unrolled GGR column loop grows ~ n^3 with a
    constant within [0.5, 6] of the eq. 3 model, exactly, and within 10% of
    the JAX package's jaxpr count of the same loop."""
    got = {}
    for n in (8, 16, 32):
        c = counts.count_mults(_unrolled(ggr_column_step_at, n),
                               torch.zeros((n, n), dtype=torch.float64))
        assert c.exact
        got[n] = c
        assert 0.5 * counts.cgr_mults(n) < c < 6 * counts.cgr_mults(n), (n, c)
        ref = jcounts.count_mults(_unrolled(j_column_step_at, n), jnp.zeros((n, n)))
        assert abs(int(c) - int(ref)) <= 0.1 * int(ref), (n, c, ref)
    assert 6 < got[32] / got[16] < 12


def test_census_ratio_ggr_vs_gr_below_one():
    """The paper's claim on the port's own code: GGR's column steps take
    fewer multiplications than classical GR's rotations on the active
    region (the reference's ``tests/test_counts.py`` bound), and each
    census is within 10% of the JAX package's."""
    n = 16
    m_ggr = m_gr = 0
    j_ggr = j_gr = 0
    for c in range(n - 1):
        size = n - c

        def gr_one_col(A, size=size, rot=_rot_pair):
            X = A.clone() if isinstance(A, torch.Tensor) else A
            for i in range(size - 1, 0, -1):
                nh, nl = rot(X[i - 1], X[i], 0)
                if isinstance(X, torch.Tensor):
                    X[i - 1], X[i] = nh, nl
                else:
                    X = X.at[i - 1].set(nh).at[i].set(nl)
            return X

        A = torch.zeros((size, size), dtype=torch.float64)
        g, r = counts.count_mults(ggr_column_step, A), counts.count_mults(gr_one_col, A)
        assert g.exact and r.exact
        m_ggr += g
        m_gr += r
        j_ggr += jcounts.count_mults(j_column_step, jnp.zeros((size, size)))
        j_gr += jcounts.count_mults(lambda X: gr_one_col(X, rot=j_rot_pair),
                                    jnp.zeros((size, size)))
    assert m_ggr < m_gr, (m_ggr, m_gr)
    assert m_ggr / m_gr < 0.95
    assert abs(m_ggr - j_ggr) <= 0.1 * j_ggr and abs(m_gr - j_gr) <= 0.1 * j_gr


def test_census_counting_convention():
    x = torch.ones(3, 4, dtype=torch.float64)
    assert counts.count_mults(lambda a: a * 2.0, x) == 12
    assert counts.count_mults(lambda a: a / 2.0, x) == 12
    assert counts.count_mults(lambda a: a ** 2, x) == 12
    assert counts.count_mults(lambda a: a.clone().mul_(3.0), x) == 12
    assert counts.count_mults(lambda a: torch.addcmul(a, a, a), x) == 12
    assert counts.count_mults(lambda a: a @ a.T, x) == 3 * 3 * 4
    assert counts.count_mults(lambda a: a @ a[0], x) == 3 * 4
    assert counts.count_mults(lambda a: torch.bmm(a[None], a.T[None]), x) == 36
    assert counts.count_mults(lambda a: a[0] @ a[1], x) == 4
    # the opaque aten.linalg_vector_norm counts as the squares it takes
    c = counts.count_mults(torch.linalg.norm, x)
    assert c == 12 and c.exact
    # loops run for real: the trip count is in the census
    c = counts.count_mults(lambda a: [a * 1.5 for _ in range(5)][-1], torch.ones(3))
    assert c == 15 and c.exact


def test_census_is_inexact_after_an_opaque_op(monkeypatch):
    A = torch.eye(4, dtype=torch.float64) * 2.0
    assert not counts.count_mults(torch.linalg.solve, A, A).exact
    assert not counts.count_mults(lambda a: torch.linalg.qr(a).R * 2.0, A).exact
    assert not counts.count_mults(lambda a: a ** 3, A).exact
    assert counts.count_mults(lambda a: a * 2.0 + a, A).exact
    # a launch of a hand-written kernel happens outside the dispatcher: its
    # launch counter moving turns the census inexact
    def fake_launch(x):
        ggr_update.batched_update.launches += 1
        return x * 2.0
    monkeypatch.setattr(ggr_update.batched_update, "launches",
                        ggr_update.batched_update.launches)
    c = counts.count_mults(fake_launch, A)
    assert int(c) == 16 and not c.exact


def test_multcount_behaves_like_int():
    c = counts.MultCount(10, exact=False)
    assert c == 10 and c * 2 == 20 and not c.exact
    assert "exact=False" in repr(c)
    assert not isinstance(c + 1, counts.MultCount)
    assert repr(c) == repr(jcounts.MultCount(10, exact=False))


@pytest.mark.parametrize("cd,ad", [("float32", None), ("float32", "float32"),
                                   ("bfloat16", "float32"), ("float16", "float32"),
                                   ("float64", None)])
def test_flops_by_dtype_matches_the_reference(cd, ad):
    m = counts.ggr_sweep_mults(32, 16, 16)
    assert counts.flops_by_dtype(m, cd, ad) == jcounts.flops_by_dtype(m, cd, ad)
    # torch dtypes key by the reference's names, not "torch.float32"
    tcd = getattr(torch, cd)
    tad = None if ad is None else getattr(torch, ad)
    assert counts.flops_by_dtype(m, tcd, tad) == jcounts.flops_by_dtype(m, cd, ad)
    est = counts.MultCount(10, exact=False)
    assert counts.flops_by_dtype(est, cd, ad) == jcounts.flops_by_dtype(10, cd, ad)


def test_record_dispatch_by_dtype_matches_the_reference():
    flops = counts.mults_to_flops(counts.ggr_append_mults(6, 3, 6))

    def record(o, reg):
        o.install(reg)
        try:
            o.record_dispatch("serve", flops, 1e-3, kind="append",
                              by_dtype=o.flops_by_dtype(flops, "bfloat16", "float32"),
                              precision="bfloat16")
        finally:
            o.uninstall()
        return {(m.name, m.labels): getattr(m, "value", None) or m.values
                for m in reg.collect()}

    got = record(obs, obs.MetricsRegistry())
    assert got == record(jobs, jobs.MetricsRegistry())
    assert got[("serve.flops_total", (("dtype", "bfloat16"), ("kind", "append"),
                                      ("precision", "bfloat16")))] == flops // 2

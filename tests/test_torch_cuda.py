"""The CUDA kernels on the card: each held against its plain PyTorch version.

The card tests carry the ``gpu`` marker and skip without a CUDA device.  This
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda, batched_geqrt, batched_update
from repro_torch.kernels import ggr_panel, ggr_update
from repro_torch.launch import serve_qr

TOL = {torch.float32: 5e-5, torch.float64: 1e-11}


def test_cpu_tensors_never_reach_the_cuda_binding(monkeypatch):
    """The tensor's device decides: CPU tensors take the plain version and
    never touch nvcc or the ctypes binding."""
    def refuse(*a, **k):
        raise AssertionError("CUDA binding reached from a CPU tensor")

    monkeypatch.setattr(_cuda, "launch", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    X = torch.randn(3, 7, 5, dtype=torch.float64)
    X[:, :4, :4] = torch.triu(X[:, :4, :4])
    assert torch.equal(batched_update(X, 4), ggr_update.batched_update_plain(X, 4))
    assert torch.equal(batched_geqrt(X, 4), ggr_panel.batched_geqrt_plain(X, 4))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only there")
    return torch.device("cuda")


def _stack(g, card, B, m, w, n_piv, dtype):
    X = torch.randn((B, m, w), generator=g, device=card, dtype=dtype)
    X[:, :n_piv, :n_piv] = torch.triu(X[:, :n_piv, :n_piv])
    X[0] = 0
    return X


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,m,w,n_piv", [(1, 12, 9, 8), (67, 40, 33, 32),
                                         (7, 104, 65, 64), (5, 128, 192, 64)])
def test_batched_update_kernel_matches_plain(card, dtype, B, m, w, n_piv):
    g = torch.Generator(device=card).manual_seed(B + m)
    X = _stack(g, card, B, m, w, n_piv, dtype)
    n0 = batched_update.launches
    out = batched_update(X, n_piv)
    assert batched_update.launches == n0 + 1
    ref = ggr_update.batched_update_plain(X, n_piv)
    tol = TOL[dtype] * max(1, m // 16) * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol
    bits = out[0].view(torch.int32 if dtype == torch.float32 else torch.int64)
    assert bool((bits == 0).all())  # the zero problem comes back bitwise zero


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,t,w,n_piv", [(1, 8, 16, 8), (67, 64, 128, 64),
                                         (9, 20, 24, 16), (4, 12, 30, 16)])
def test_batched_geqrt_kernel_matches_plain(card, dtype, B, t, w, n_piv):
    g = torch.Generator(device=card).manual_seed(B + t)
    X = torch.randn((B, t, w), generator=g, device=card, dtype=dtype)
    X[0] = 0
    n0 = batched_geqrt.launches
    out = batched_geqrt(X, n_piv)
    assert batched_geqrt.launches == n0 + 1
    ref = ggr_panel.batched_geqrt_plain(X, n_piv)
    tol = TOL[dtype] * max(1, t // 16) * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol
    assert torch.equal(out[0], X[0])


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(card):
    X = torch.zeros((2, 12, 9), device=card)
    for fn in (batched_update, batched_geqrt):
        with pytest.raises(NotImplementedError):
            fn(X, 8, precision="bf16")
        with pytest.raises(NotImplementedError):
            fn(X.half(), 8)
    big = torch.zeros((1, 240, 256), device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        batched_geqrt(big, 64)
    with pytest.raises(ValueError, match="threads"):
        batched_update(torch.zeros((1, 9, 1100), device=card), 8)


@pytest.mark.gpu
def test_server_on_the_card_matches_the_cpu(card):
    reqs = serve_qr.make_workload(num=24, n=8, rows=4, k=1, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        srv = serve_qr.QRServer(device=dev)
        tickets = serve_qr._submit_all(srv, reqs)
        srv.flush()
        srv.drain()
        out[dev] = [serve_qr._as_tuple(srv.result(t)) for t in tickets]
    for a, b in zip(out["cpu"], out["cuda"]):
        for x, y in zip(a, b):
            assert y.device.type == "cuda"
            np.testing.assert_allclose(y.cpu().double().numpy(), x.double().numpy(),
                                       atol=1e-4 * max(1.0, float(x.abs().max())))

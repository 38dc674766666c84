"""The hand-written CUDA kernels against their PyTorch twins, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
machine with the card has no JAX, so this file imports no JAX and needs
nothing from ``tests/conftest.py``; run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances are float32 kernel vs float32 twin, relative to max(1, |ref|):
the Riccati ones are those of the Pallas kernel's own test
(``tests/test_pallas_riccati.py``), the line-search ones those of
``chip_smoke.py`` phase 4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import mpc_verde_tpu_torch as mt
from chip_smoke import _random_riccati, _rel_err
from mpc_verde_tpu_torch.interop import BENCH_DT, bench_ocp
from mpc_verde_tpu_torch.models import unicycle
from mpc_verde_tpu_torch.ops import euler_step, rk4_step
from mpc_verde_tpu_torch.ops.cuda.riccati import (SUPPORTED, riccati_backward,
                                                  riccati_backward_torch)
from mpc_verde_tpu_torch.ops.cuda.rollout import (linesearch_forward,
                                                  linesearch_forward_torch)

pytestmark = pytest.mark.cuda

K1_TOL = {"kff": 2e-4, "K": 2e-3, "dV1": 1e-3, "dV2": 1e-3, "gmax": 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("bounds", ["box", "none"])
@pytest.mark.parametrize("use_ddp", [True, False])
@pytest.mark.parametrize("nx,nu", sorted(SUPPORTED))
def test_riccati_kernel_matches_twin(dev, nx, nu, use_ddp, bounds):
    """B = 200 is not a multiple of the block; half the problems have DDP
    off; with no bounds, dlb/dub are -inf/+inf and nothing may turn NaN."""
    d, dlb, dub, gN, HN, reg, ddp = _random_riccati(
        np.random.default_rng(10 * nx + nu), 200, 6, nx, nu, dev)
    ddp[::2] = 0.0
    if bounds == "none":
        dlb, dub = torch.full_like(dlb, -torch.inf), torch.full_like(dub, torch.inf)
    args = (d, dlb, dub, gN, HN, reg, ddp)
    before = riccati_backward.launches
    out = riccati_backward(*args, nx=nx, nu=nu, use_ddp=use_ddp)
    torch.cuda.synchronize()
    assert riccati_backward.launches == before + 1
    ref = riccati_backward_torch(*args, nx=nx, nu=nu, use_ddp=use_ddp)
    for (name, tol), o, r in zip(K1_TOL.items(), out, ref):
        assert bool(torch.isfinite(o).all()), name
        assert _rel_err(o, r) <= tol, (name, _rel_err(o, r))


def _ocp_variant(variant, N, dev):
    """The bench OCP, or one of the other device models the kernel takes."""
    ocp = bench_ocp(N, dev, torch.float32)
    model = ocp.device_model
    if variant == "terminal":
        Qf = np.diag(np.array([2.0, 10.0, 0.2], np.float32))
        Qt = torch.as_tensor(Qf, device=dev)
        return dataclasses.replace(
            ocp, terminal_cost=lambda x, p: (x - p[:3]) @ Qt @ (x - p[:3]),
            device_model=dataclasses.replace(model, Qf=Qf))
    if variant == "euler":
        return dataclasses.replace(
            ocp, dynamics=euler_step(unicycle.f, BENCH_DT),
            device_model=dataclasses.replace(model, integrator="euler"))
    if variant == "rk4_m3":
        return dataclasses.replace(
            ocp, dynamics=rk4_step(unicycle.f, BENCH_DT, M=3),
            device_model=dataclasses.replace(model, substeps=3))
    return ocp


@pytest.mark.parametrize("variant", ["bench", "preroll", "terminal", "euler",
                                     "rk4_m3"])
def test_linesearch_kernel_matches_twin(dev, variant):
    B, N = 300, 12
    ocp = _ocp_variant(variant, N, dev)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    x0 = t(rng.uniform(-2, 2, (B, 3)))
    xs = t(rng.uniform(-2, 2, (B, N + 1, 3)))
    us = t(rng.uniform(-0.8, 0.8, (B, N, 2)))
    ps = t(np.broadcast_to(np.array([10.0, 10.0, 0.0]), (B, N + 1, 3)).copy())
    kffs = t(0.3 * rng.normal(size=(B, N, 2)))
    Ks = t(0.2 * rng.normal(size=(B, N, 2, 3)))
    alphas = tuple(0.4 ** i for i in range(8))
    if variant == "preroll":
        kffs, Ks, alphas = torch.zeros_like(kffs), torch.zeros_like(Ks), (1.0,)
    args = (x0, xs, us, ps, kffs, Ks, alphas)
    before = linesearch_forward.launches
    xs_k, us_k, c_k, b_k = linesearch_forward(*args, ocp=ocp)
    torch.cuda.synchronize()
    assert linesearch_forward.launches == before + 1
    xs_t, us_t, c_t, b_t = linesearch_forward_torch(*args, ocp=ocp)
    # the winner's cost is the minimum over alphas, so it agrees even where
    # a near-tie picks another alpha; trajectories are compared where the
    # chosen alpha is the same
    assert float(((c_k - c_t).abs() / c_t.abs()).max()) <= 1e-5
    same = b_k == b_t
    assert float(same.float().mean()) >= 0.99
    assert _rel_err(xs_k[same], xs_t[same]) <= 1e-4
    assert _rel_err(us_k[same], us_t[same]) <= 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    d, dlb, dub, gN, HN, reg, ddp = _random_riccati(
        np.random.default_rng(0), 8, 4, 3, 2, dev)
    k1_before, k2_before = riccati_backward.launches, linesearch_forward.launches
    with pytest.raises(TypeError, match="float32"):
        riccati_backward({**d, "fx": d["fx"].double()}, dlb, dub, gN, HN, reg,
                         ddp, nx=3, nu=2)
    with pytest.raises(ValueError, match="contiguous"):
        riccati_backward({**d, "fx": d["fx"].transpose(-1, -2)}, dlb, dub, gN,
                         HN, reg, ddp, nx=3, nu=2)
    with pytest.raises(ValueError, match="on cpu"):
        riccati_backward(d, dlb.cpu(), dub, gN, HN, reg, ddp, nx=3, nu=2)
    with pytest.raises(NotImplementedError):
        riccati_backward(d, dlb, dub, gN, HN, reg, ddp, nx=4, nu=2)
    ocp = bench_ocp(4, dev, torch.float32)
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="shape"):
        linesearch_forward(z(8, 3), z(8, 4, 3), z(8, 4, 2), z(8, 5, 3),
                           z(8, 4, 2), z(8, 4, 2, 3), (1.0,), ocp=ocp)
    with pytest.raises(NotImplementedError, match="device_model"):
        linesearch_forward(z(8, 3), z(8, 5, 3), z(8, 4, 2), z(8, 5, 3),
                           z(8, 4, 2), z(8, 4, 2, 3), (1.0,),
                           ocp=dataclasses.replace(ocp, device_model=None))
    assert riccati_backward.launches == k1_before
    assert linesearch_forward.launches == k2_before


def test_streaming_cuda_matches_torch_float64(dev):
    """The "cuda" backend in float32 against the "torch" backend in float64
    on the card, over a small queue of the bench problem."""
    N, M, W = 20, 64, 16
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-2.0, 2.0, (M, 3))
    target = np.array([10.0, 10.0, 0.0])
    opts = mt.ILQROptions(max_iters=60, tol_grad=1e-4, tol_cost=1e-6,
                          n_alphas=8, alpha_decay=0.4)
    solve = lambda backend, dtype: mt.make_streaming_solver(
        bench_ocp(N, dev, dtype), opts, backend=backend, batch_width=W,
        restarts=2)(x0, target)
    riccati_backward_torch.cuda_calls = 0
    linesearch_forward_torch.cuda_calls = 0
    k1, k2 = riccati_backward.launches, linesearch_forward.launches
    ck = solve("cuda", torch.float32)
    assert riccati_backward.launches > k1 and linesearch_forward.launches > k2
    assert riccati_backward_torch.cuda_calls == 0
    assert linesearch_forward_torch.cuda_calls == 0
    ct = solve("torch", torch.float64)
    assert float((ck.converged == ct.converged).float().mean()) >= 0.95
    both = ck.converged & ct.converged
    assert bool(both.any())
    rel = (ck.cost.double() - ct.cost).abs() / ct.cost.abs()
    assert float(rel[both].max()) <= 1e-3

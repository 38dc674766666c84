"""Port vs JAX: the batched Riccati backward pass (the twin of CUDA kernel K1).

``riccati_backward_torch`` against the JAX ``"xla"`` backward recursion in
float64 for nu = 1..4, and ``riccati_backward`` (which runs the twin for CPU
tensors) against the Pallas kernel in interpret mode in float32, with the
Pallas test's tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mpc_verde_tpu as mv
from mpc_verde_tpu.ops.pallas.riccati import riccati_backward_pallas
from mpc_verde_tpu.solver.batched import _make_parts as j_make_parts
from mpc_verde_tpu_torch.ops.cuda.build import check_args
from mpc_verde_tpu_torch.ops.cuda.riccati import (riccati_backward,
                                                  riccati_backward_torch)

N, B = 6, 5
CASES = [(3, 1), (3, 2), (4, 3), (5, 4)]


def _random_problem(nx, nu):
    """As tests/test_pallas_riccati.py: boxes that bind, a pinned last
    stage, and per-problem DDP on/off."""
    rng = np.random.default_rng(100 * nx + nu)
    d = {
        "fx": rng.normal(size=(B, N, nx, nx)) * 0.3 + np.eye(nx),
        "fu": rng.normal(size=(B, N, nx, nu)) * 0.3,
        "lx": rng.normal(size=(B, N, nx)),
        "lu": rng.normal(size=(B, N, nu)),
        "lxx": np.tile(2 * np.eye(nx), (B, N, 1, 1))
        + 0.1 * rng.normal(size=(B, N, nx, nx)),
        "luu": np.tile(np.eye(nu), (B, N, 1, 1)),
        "lux": 0.1 * rng.normal(size=(B, N, nu, nx)),
        "fxx": 0.05 * rng.normal(size=(B, N, nx, nx, nx)),
        "fux": 0.05 * rng.normal(size=(B, N, nx, nu, nx)),
        "fuu": 0.05 * rng.normal(size=(B, N, nx, nu, nu)),
    }
    d["lxx"] = 0.5 * (d["lxx"] + d["lxx"].transpose(0, 1, 3, 2))
    dlb = np.full((B, N, nu), -0.7)
    dub = np.full((B, N, nu), 0.5)
    dlb[:, -1, :] = 0.0
    dub[:, -1, :] = 0.0
    gN = rng.normal(size=(B, nx))
    HN = np.tile(np.eye(nx), (B, 1, 1))
    reg = np.full((B,), 1e-6)
    ddp = (np.arange(B) % 2 == 0).astype(float)
    return d, dlb, dub, gN, HN, reg, ddp


def _jax_xla_backward(nx, nu):
    """The JAX package's batched "xla" backward for a boxed (nx, nu) OCP."""
    ocp = mv.OCP(dynamics=lambda x, u, p: x, stage_cost=lambda x, u, p: 0.0,
                 N=N, nx=nx, nu=nu,
                 control_bounds=mv.box_bounds(-np.ones(nu), np.ones(nu)))
    return j_make_parts(ocp, mv.ILQROptions(), "xla", "materialize").backward


@pytest.mark.parametrize("nx,nu", CASES)
def test_twin_matches_jax_xla_backward(nx, nu):
    d, dlb, dub, gN, HN, reg, ddp = _random_problem(nx, nu)
    ref = _jax_xla_backward(nx, nu)(d, gN, HN, dlb, dub, reg, ddp)
    t = torch.as_tensor
    out = riccati_backward_torch({k: t(v) for k, v in d.items()}, t(dlb),
                                 t(dub), t(gN), t(HN), t(reg), t(ddp),
                                 nx=nx, nu=nu)
    for name, a, b in zip(("kff", "K", "dV1", "dV2", "gmax"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9,
                                   err_msg=name)
    assert (out[0][:, :-1].abs() > 0.49).any()   # some stage QP binds


@pytest.mark.parametrize("nx,nu", CASES[:2])
def test_wrapper_matches_pallas_interpret(nx, nu):
    d, dlb, dub, gN, HN, reg, _ = _random_problem(nx, nu)
    j32 = lambda a: jnp.asarray(a, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = riccati_backward_pallas({k: j32(v) for k, v in d.items()},
                                      j32(dlb), j32(dub), j32(gN), j32(HN),
                                      j32(reg), nx=nx, nu=nu, use_ddp=True)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    out = riccati_backward({k: t32(v) for k, v in d.items()}, t32(dlb),
                           t32(dub), t32(gN), t32(HN), t32(reg), nx=nx, nu=nu)
    for name, a, b, tol in zip(("kff", "K", "dV1", "gmax"),
                               (out[0], out[1], out[2], out[4]),
                               (ref[0], ref[1], ref[2], ref[4]),
                               (2e-4, 2e-3, 1e-3, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol, err_msg=name)


def test_wrapper_refuses_devices_without_kernel():
    """Only CPU tensors go to the twin; others launch the kernel or raise."""
    d, dlb, dub, gN, HN, reg, _ = _random_problem(3, 2)
    meta = lambda a: torch.empty(np.shape(a), dtype=torch.float32,
                                 device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        riccati_backward({k: meta(v) for k, v in d.items()}, meta(dlb),
                         meta(dub), meta(gN), meta(HN), meta(reg), nx=3, nu=2)


@pytest.mark.parametrize("bad,err", [
    ("float64", TypeError), ("transposed", ValueError),
    ("shape", ValueError), ("device", ValueError)])
def test_kernel_argument_checks(bad, err):
    """What both wrappers check before a launch: contiguous float32 tensors
    of the expected shapes on the launch device."""
    good = torch.zeros((4, 3, 3))
    t = {"float64": good.double(), "transposed": good.transpose(-1, -2),
         "shape": torch.zeros((4, 3, 2)),
         "device": torch.zeros((4, 3, 3), device="meta")}[bad]
    check_args("k", torch.device("cpu"), [("a", good, (4, 3, 3))])
    with pytest.raises(err):
        check_args("k", torch.device("cpu"), [("a", good, (4, 3, 3)),
                                              ("b", t, (4, 3, 3))])

"""Fused parallel line search / pre-roll: CUDA kernel K2 and its PyTorch twin.

``linesearch_forward`` replaces the Pallas TPU kernel
``linesearch_forward_pallas`` (``mpc_verde_tpu/ops/pallas/rollout.py``).
For each problem and each step length alpha it rolls
``u = clip(u_nom + alpha*kff + K(x - x_nom))``, ``x' = F(x, u, p)``,
accumulating the cost, keeps the first minimum over ascending alpha, and
returns the winner's trajectory.  With zero gains and one alpha it is the
pre-roll of a problem queue.

Its kernel is ``csrc/rollout.cu``: one lane per (problem, alpha).  The
lanes of a problem roll all candidates at once, so the dependent chain is
N steps and not (A+1)*N.  A block copies its problems' contiguous slabs of
the nominal trajectory and gains to shared memory with coalesced loads,
every lane keeps its candidate's trajectory in a shared-memory slot, the
first minimum over (cost, alpha index) is found by warp shuffles, and the
winners' slots leave as one coalesced slab, with no second roll.
``linesearch_launch_plan`` picks the variant from the shape and the batch:
``"lanes"`` as described where the batch's grid runs in a few waves or an
SM holds many of its blocks, else ``"lanes_ring"``: the nominal rows
streamed through a ring of stage chunks, so that shared memory does not
grow with N and more blocks share an SM, and the winners rolled again
(the pre-roll, one alpha, rolls once and writes).  The plan also computes
the kernel's shared-memory layout, which the C entry point takes as it is.

The Pallas kernel inlines the OCP's jaxprs.  A CUDA kernel cannot inline a
Python callable, so the kernel evaluates a device model: the one the OCP
carries, or for an OCP given only by its callables the
``TracedDeviceModel`` generated from their trace (``traced_device_model``:
``trace.py`` lowers the callables to a scalar program, ``codegen.py`` writes
it as a model, and its own library instantiates the kernel on it, as the
Pallas kernel inlines the traced jaxpr).  One hand-written model exists,
``UnicycleDeviceModel`` (``csrc/unicycle.cuh``): plain numbers describing
the same dynamics, cost and box as the unicycle OCP's torch callables.  Its
``step`` / ``stage_cost`` / ... methods are those formulas in PyTorch, in
the kernel's order, so a test can tie the two definitions together.  Every
other OCP is its callables and nothing else.  The kernels are templates on
the model (``csrc/rollout.cuh``, instantiated in ``rollout.cu`` and in each
traced program's unit); K3 shares the models' device code.

``linesearch_forward_torch`` is the plain PyTorch version: the JAX
materialising line search (``mpc_verde_tpu/solver/batched.py``) on the
OCP's own callables, with alpha as a batch dimension.

``trajectory_cost`` prices given trajectories on the same device models:
the cost re-base of the streaming solver's continuation rounds, for the
masked slots only, one launch where the plain PyTorch cost
(``trajectory_cost_torch``, elementwise over every slot) is dozens.  Its
kernel sums the stages in ``roll``'s order, so an accepted trajectory's
re-based cost is the float K2 returned for it.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from .build import (SMEM_MAX_BYTES, LaunchPlan, check_args, check_launch,
                    load_library, traced_entry)
from .trace import Program, trace_ocp
from ...utils.profiling import count, span

MAX_ALPHAS = 32  # kMaxAlphas in csrc/rollout.cuh: one problem's lanes fit a warp
LINESEARCH_VARIANTS = ("lanes", "lanes_ring")  # the C entry's ids
# The plan's constants follow measurements on the H100
# (utils/tune_launch_plans.py; PERF.md section 6).
# "lanes": at B = 1024 the kernel's time is one candidate's chain, so 32 to
# 256 threads a block run within 1% of each other at the bench shape and
# within 8% at the fleet's.
_BLOCK_THREADS = 64
_WARP = 32
# "lanes_ring": threads a block, stages a chunk and chunks in the ring
# (kRingChunk and kRingDepth of csrc/rollout.cuh).  At 131,072 problems,
# N = 40, A = 8, 128 threads with 8 stages and two chunks ran fastest on
# both models: the quadrotor's (6, 2) 1.80 ms (64 threads 2.09, 256 threads
# 2.20), the unicycle's 0.80 ms; a third chunk gained nothing, and shorter
# chunks lost more to the chunk's copy and barrier than their smaller ring
# won in blocks an SM (chunk 1 at 64 threads: 3.20 and 1.71 ms).  There
# registers, not shared memory, bound the blocks an SM (93 a thread at
# (6, 2): five blocks of 128 threads).  With one alpha a block of 128
# problems fills an SM's shared memory at (6, 2): its blocks are halved
# until two fit an SM, so that one rolls while the other waits at a barrier
# (the pre-roll of 1,048,576 rows: 8.6 ms in 2 blocks of 64, 9.3 ms in 1 of
# 128).
_RING_THREADS = 128
_RING_CHUNK = 8
_RING_DEPTH = 2
# One SM of the H100 SXM (132 of them): shared memory in bytes (the runtime
# reserves 1 KB a block) and warps.
_SMS = 132
_SM_SMEM, _BLOCK_SMEM_RESERVED = 233_472, 1_024
_SM_WARPS = 64
# The ring rolls the winners again: at one wave it took 1.84-1.87x the time
# of "lanes" (unicycle 0.0568 / 0.0309 ms, quadrotor 0.1119 / 0.0600 at
# B = 1024, N = 40, A = 8), so "lanes" keeps grids of up to two waves.  Past
# them a wave of "lanes" takes one chain however few warps an SM holds: at
# 131,072 problems the quadrotor's one 2-warp block an SM took 6.26 ms
# against the ring's 1.80, the unicycle's three 1.30 against 0.80, while
# the fleet's 13 blocks (26 warps) an SM kept "lanes" ahead, 1.17 against
# 1.72 ms at 524,288.
_LANES_MAX_WAVES = 2
_LANES_MIN_WARPS = 16


def _blocks_an_sm(threads: int, smem_bytes: int) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of dynamic shared
    memory that one SM holds by its shared memory and warps (registers
    aside; the runtime's count is ``linesearch_occupancy``)."""
    return min(_SM_WARPS // -(-threads // _WARP),
               _SM_SMEM // (smem_bytes + _BLOCK_SMEM_RESERVED))


def linesearch_launch_plan(N: int, A: int, npar: int,
                           variant: Optional[str] = None, *, nx: int = 3,
                           nu: int = 2, B: Optional[int] = None) -> LaunchPlan:
    """How ``linesearch_forward`` launches its kernel for horizon ``N``,
    ``A`` alphas, ``npar`` parameters, the model's sizes ``(nx, nu)`` (the
    unicycle's by default) and ``B`` problems (None: one wave): a rule on
    the shape.

    "lanes" takes 64 / A_pad problems a block (A_pad: A rounded up to a
    power of two), halved until the whole-horizon slabs and the candidate
    slots fit; "lanes_ring" takes 128 / A_pad, halved until two blocks fit
    an SM, in bytes that do not grow with N.  The plan is "lanes" where
    A > 1, at least a warp of lanes fits, and its grid runs in at most
    ``_LANES_MAX_WAVES`` waves or an SM holds ``_LANES_MIN_WARPS`` of its
    warps; else the ring (the limits are measurements, stated at the
    constants above).  ``variant`` forces one (for a comparison on the
    card); a variant that does not fit one problem raises ``ValueError``.
    The plan's ``layout`` is the kernel's shared-memory layout, computed
    here and nowhere else: the C entry point takes it as it is.
    """
    if not 1 <= A <= MAX_ALPHAS:
        raise ValueError(f"linesearch_forward takes 1..{MAX_ALPHAS} alphas")
    if variant is not None and variant not in LINESEARCH_VARIANTS:
        raise ValueError(f"unknown line-search variant {variant!r}")
    a_pad = 1 << (A - 1).bit_length()
    lx, lu, lk, lp = (N + 1) * nx, N * nu, N * nu * nx, (N + 1) * npar
    slot = (lx + lu) | 1    # odd: the lanes of a group write different banks

    def lanes_layout(pb):
        """LanesLayout of ``csrc/rollout.cuh`` from ``xs`` on, in floats:
        the offsets of the five nominal slabs of ``pb`` problems, each a
        multiple of 4 floats (16 bytes, for the vector copies), of the
        candidate slots and of the winners' indices; the slot stride; the
        total."""
        offsets = [0]
        for n in (lx, lu, lu, lk, lp):      # xs, us, kff, K, ps
            offsets.append(offsets[-1] + (pb * n + 3) // 4 * 4)
        best = offsets[-1] + pb * a_pad * slot
        return (*offsets, best, slot, best + pb)

    def ring_layout(pb):
        """The ring's layout: the floats of a stage (xs, us, kff, K and ps
        of one problem), the problem stride (a chunk's stages, odd: the
        problems of a warp read different banks), the ring slot's stride,
        the winners' indices' offset, the total."""
        row = nx + 2 * nu + nu * nx + npar
        pstride = (_RING_CHUNK * row) | 1
        sstride = pb * pstride
        best = _RING_DEPTH * sstride
        return (row, pstride, sstride, best, best + pb)

    def fitted(name, threads, layout, per_sm):
        """``name``'s plan: ``threads`` / A_pad problems a block, halved
        until the block fits and ``per_sm`` blocks fit an SM; None where
        one problem does not fit a block, unless ``name`` is forced or the
        last resort, which raise."""
        pb = max(1, threads // a_pad)
        smem = lambda pb: 4 * layout(pb)[-1]
        while pb > 1 and (smem(pb) > SMEM_MAX_BYTES
                          or _blocks_an_sm(pb * a_pad, smem(pb)) < per_sm):
            pb //= 2
        if smem(pb) <= SMEM_MAX_BYTES:
            return LaunchPlan(name, pb, pb * a_pad, smem(pb), layout(pb))
        if variant is None and name == "lanes":
            return None
        raise ValueError(f"variant {name!r} needs {smem(1)} bytes of shared "
                         f"memory for one problem at N={N}, A={A}, "
                         f"npar={npar}, (nx, nu)=({nx}, {nu}); a block has "
                         f"{SMEM_MAX_BYTES}")

    if variant in (None, "lanes"):
        lanes = fitted("lanes", _BLOCK_THREADS, lanes_layout, 1)
        if variant == "lanes":
            return lanes
        if lanes is not None and A > 1 and lanes.threads >= _WARP:
            per_sm = _blocks_an_sm(lanes.threads, lanes.smem_bytes)
            blocks = 0 if B is None else -(-B // lanes.problems)
            if (blocks <= _LANES_MAX_WAVES * _SMS * per_sm
                    or per_sm * lanes.threads >= _LANES_MIN_WARPS * _WARP):
                return lanes
    return fitted("lanes_ring", _RING_THREADS, ring_layout, 2)


BARRIER_RULES = ("streaming", "batched")   # ids 1, 2 of the C entries (0: none)
STAGE_COSTS = ("discrete", "quadrature")


@dataclasses.dataclass(frozen=True)
class UnicycleDeviceModel:
    """Kernel-side description of a unicycle OCP (nx = 3, nu = 2, npar >= 3;
    the model of the kernels library's C entry points).

    Dynamics: unicycle kinematics, ``integrator`` "rk4" (``substeps`` equal
    substeps over ``dt``) or "euler" (one step).  Running cost
    ``L = (x - p[:3])' Q (x - p[:3]) + (u - r)' R (u - r)`` with the control
    reference ``r = p[u_ref : u_ref + 2]``, or ``r = 0`` when ``u_ref`` is
    None.  Stage cost ``L`` itself (``cost="discrete"``), or
    (``cost="quadrature"``) the integral of ``L`` over ``dt`` by
    ``rk4_step_with_quadrature`` with ``quad_substeps`` RK4 substeps of the
    unicycle, whatever ``integrator`` steps the state.  Terminal cost
    ``(x - p[:3])' Qf (x - p[:3])`` when ``Qf`` is given.  Control box
    ``lb <= u <= ub``, constant over the horizon.

    Two optional cost terms, each reading its columns of ``p``:

    * ``barrier``: the log barrier of the interior-point solvers
      (``solver/ipm.py``) on its own constant box ``barrier_lb`` /
      ``barrier_ub`` with ``mu = p[barrier_mu]``, added to the stage cost.
      Rule ``"streaming"`` (``ipm._barrier_term``): ``-mu * sum(log(d))``
      over ``d = [u - lb, ub - u]``, +inf when some ``d <= 0`` and mu > 0,
      exactly 0 (value and derivatives) when mu = 0.  Rule ``"batched"``
      (``make_barrier_solver``): ``- mu * (sum(log(u - lb)) + sum(log(ub -
      u)))``, NaN outside the box.
    * ``al``: the PHR augmented-Lagrangian penalty of the state box
      ``x_lb <= x <= x_ub`` (``solver/batched._augment_ocp_al``) with the
      multipliers ``lam = p[al_lam : al_lam + 6]`` and ``mu = p[al_lam +
      6]``, added to every stage cost and to the terminal cost.  Infinite
      bounds are inactive rows.

    The solvers derive these models (``with_barrier``, ``with_al``) with
    the OCPs they derive; ``None`` where no model can be derived.  The
    boxes keep the OCP's numbers; the kernels take them rounded to float32,
    as a float32 OCP holds them.
    """

    dt: float
    Q: np.ndarray
    R: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    Qf: Optional[np.ndarray] = None
    substeps: int = 1
    integrator: str = "rk4"
    barrier: Optional[str] = None
    barrier_lb: Optional[np.ndarray] = None
    barrier_ub: Optional[np.ndarray] = None
    barrier_mu: int = 0
    al: bool = False
    x_lb: Optional[np.ndarray] = None
    x_ub: Optional[np.ndarray] = None
    al_lam: int = 0
    u_ref: Optional[int] = None
    cost: str = "discrete"
    quad_substeps: int = 1

    def __post_init__(self):
        if self.integrator not in ("rk4", "euler"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.cost not in STAGE_COSTS:
            raise ValueError(f"unknown stage cost {self.cost!r}")
        if self.quad_substeps < 1:
            raise ValueError("quad_substeps must be >= 1")
        if self.u_ref is not None and self.u_ref < 0:
            raise ValueError("u_ref must be a column index >= 0")
        if self.integrator == "euler" and self.substeps != 1:
            raise ValueError("the euler device model takes one step")
        if self.barrier not in (None, *BARRIER_RULES):
            raise ValueError(f"unknown barrier rule {self.barrier!r}")
        shapes = {"Q": (3, 3), "R": (2, 2), "lb": (2,), "ub": (2,)}
        if self.Qf is not None:
            shapes["Qf"] = (3, 3)
        if self.barrier is not None:
            shapes.update(barrier_lb=(2,), barrier_ub=(2,))
        if self.al:
            shapes.update(x_lb=(3,), x_ub=(3,))
        for name, shape in shapes.items():
            if np.shape(getattr(self, name)) != shape:
                raise ValueError(f"{name} must have shape {shape}")

    nx = 3
    nu = 2

    @property
    def al_mu(self) -> int:
        return self.al_lam + 6

    @property
    def min_npar(self) -> int:
        """The fewest parameter columns the model reads."""
        cols = [3]
        if self.u_ref is not None:
            cols.append(self.u_ref + 2)
        if self.barrier is not None:
            cols.append(self.barrier_mu + 1)
        if self.al:
            cols.append(self.al_mu + 1)
        return max(cols)

    def with_barrier(self, lb, ub, mu_col: int, rule: str,
                     clip: bool = True) -> Optional["UnicycleDeviceModel"]:
        """This model plus the log barrier on the box [lb, ub] with mu in
        column ``mu_col``; ``clip=False`` also drops the clip box, as
        ``make_barrier_solver`` drops the OCP's control bounds.  None if
        the model already has a barrier or an AL term (the kernels take one
        of each, the barrier's columns before the AL's)."""
        if self.barrier is not None or self.al:
            return None
        unbounded = np.full(2, np.inf, np.float32)
        return dataclasses.replace(
            self, barrier=rule, barrier_lb=np.asarray(lb, np.float64),
            barrier_ub=np.asarray(ub, np.float64), barrier_mu=int(mu_col),
            **({} if clip else dict(lb=-unbounded, ub=unbounded)))

    def with_al(self, x_lb, x_ub, lam_col: int) -> Optional["UnicycleDeviceModel"]:
        """This model plus the AL penalty of the state box [x_lb, x_ub]
        (infinite entries inactive), lam in columns ``lam_col`` to
        ``lam_col + 5`` and its mu in ``lam_col + 6``.  None if the model
        already has an AL term."""
        if self.al:
            return None
        return dataclasses.replace(
            self, al=True, x_lb=np.asarray(x_lb, np.float64),
            x_ub=np.asarray(x_ub, np.float64), al_lam=int(lam_col))

    def _consts(self, substeps=None):
        """(h, h/2, h/6) of ``substeps`` (the dynamics' by default) equal
        substeps over dt, computed in double as the torch integrators do."""
        h = self.dt / (self.substeps if substeps is None else substeps)
        return h, 0.5 * h, h / 6.0

    def packed(self) -> np.ndarray:
        """float32 [h, h/2, h/6, Q, R, Qf, lb, ub, barrier_lb, barrier_ub,
        x_lb, x_ub, then the quadrature's h, h/2, h/6], the kernels' layout
        (zeros for an absent term)."""
        z = lambda a, n: np.zeros(n) if a is None else np.ravel(a)
        Qf = np.zeros((3, 3)) if self.Qf is None else self.Qf
        return np.concatenate([
            np.asarray(self._consts()), np.ravel(self.Q), np.ravel(self.R),
            np.ravel(Qf), np.ravel(self.lb), np.ravel(self.ub),
            z(self.barrier_lb, 2), z(self.barrier_ub, 2), z(self.x_lb, 3),
            z(self.x_ub, 3), np.asarray(self._consts(self.quad_substeps)),
        ]).astype(np.float32)

    def packed_ints(self) -> np.ndarray:
        """int32 [substeps, euler, has_terminal, barrier rule (0 none,
        1 streaming, 2 batched), barrier_mu, al, al_lam, al_mu, u_ref (-1
        none), quadrature substeps (0 for the discrete cost)]."""
        rule = 0 if self.barrier is None else 1 + BARRIER_RULES.index(self.barrier)
        return np.array([self.substeps, int(self.integrator == "euler"),
                         int(self.Qf is not None), rule, self.barrier_mu,
                         int(self.al), self.al_lam, self.al_mu,
                         -1 if self.u_ref is None else self.u_ref,
                         self.quad_substeps if self.cost == "quadrature"
                         else 0], np.int32)

    def kernel_args(self, device=None):
        """The model as the kernels' C entry points take it: (packed floats,
        packed ints, device tables: none for the unicycle).  The pointers
        keep the packed arrays alive."""
        return (self.packed().ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.packed_ints().ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                None)

    # --- the kernel's formulas in PyTorch (batched over leading dims) -------
    def _t(self, a, like):
        return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                               device=like.device)

    @staticmethod
    def _rhs(x, u):
        return torch.stack([u[..., 0] * torch.cos(x[..., 2]),
                            u[..., 0] * torch.sin(x[..., 2]),
                            u[..., 1]], dim=-1)

    def step(self, x, u):
        h, hh, h6 = self._consts()
        if self.integrator == "euler":
            return x + h * self._rhs(x, u)
        for _ in range(self.substeps):
            k1 = self._rhs(x, u)
            k2 = self._rhs(x + hh * k1, u)
            k3 = self._rhs(x + hh * k2, u)
            k4 = self._rhs(x + h * k3, u)
            x = x + h6 * (((k1 + 2.0 * k2) + 2.0 * k3) + k4)
        return x

    def _quad(self, W, v):
        return ((v[..., :, None] * self._t(W, v)).sum(-2) * v).sum(-1)

    def running_cost(self, x, u, p):
        """``L(x, u, p)``: the tracking terms, without the barrier and AL."""
        du = u if self.u_ref is None else u - p[..., self.u_ref:self.u_ref + 2]
        return self._quad(self.Q, x - p[..., :3]) + self._quad(self.R, du)

    def quadrature_cost(self, x, u, p):
        """The RK4 quadrature of ``L`` over dt (``quad_substeps`` substeps),
        in ``rk4_step_with_quadrature``'s order of operations."""
        h, hh, h6 = self._consts(self.quad_substeps)
        q = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for _ in range(self.quad_substeps):
            k1, k1_q = self._rhs(x, u), self.running_cost(x, u, p)
            t = x + hh * k1
            k2, k2_q = self._rhs(t, u), self.running_cost(t, u, p)
            t = x + hh * k2
            k3, k3_q = self._rhs(t, u), self.running_cost(t, u, p)
            t = x + h * k3
            k4, k4_q = self._rhs(t, u), self.running_cost(t, u, p)
            x = x + h6 * (((k1 + 2.0 * k2) + 2.0 * k3) + k4)
            q = q + h6 * (((k1_q + 2.0 * k2_q) + 2.0 * k3_q) + k4_q)
        return q

    def barrier_term(self, u, p):
        """The barrier's stage term (zeros without a barrier)."""
        if self.barrier is None:
            return torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
        mu = p[..., self.barrier_mu]
        lb, ub = self._t(self.barrier_lb, u), self._t(self.barrier_ub, u)
        if self.barrier == "batched":
            return -mu * (torch.log(u - lb).sum(-1) + torch.log(ub - u).sum(-1))
        d = torch.cat([u - lb, ub - u], dim=-1)
        logs = torch.where(d > 0, torch.log(torch.maximum(
            d, torch.full_like(d, 1e-30))), -torch.inf)
        return torch.where(mu > 0, -mu * logs.sum(-1), 0.0)

    def _al_rows(self, x, p):
        """(y = lam + mu c, lam, mu, dc): the PHR rows, c(x) with inactive
        rows at -1, and dc/dx of each row's state (0 where inactive)."""
        lo, hi = self._t(self.x_lb, x), self._t(self.x_ub, x)
        c = torch.cat([torch.where(torch.isfinite(lo), lo - x, -torch.inf),
                       torch.where(torch.isfinite(hi), x - hi, -torch.inf)], -1)
        active = torch.isfinite(c)
        c = torch.where(active, c, -1.0)
        lam = p[..., self.al_lam:self.al_lam + 6]
        mu = p[..., self.al_mu]
        dc = torch.cat([-torch.ones_like(x), torch.ones_like(x)], -1) * active
        return lam + mu[..., None] * c, lam, mu, dc

    def al_penalty(self, x, p):
        """The AL penalty of the state box (zeros without one)."""
        if not self.al:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        y, lam, mu, _ = self._al_rows(x, p)
        t = torch.maximum(torch.zeros_like(y), y)
        return ((t * t).sum(-1) - (lam * lam).sum(-1)) / (2.0 * mu)

    def stage_cost(self, x, u, p):
        c = (self.quadrature_cost(x, u, p) if self.cost == "quadrature"
             else self.running_cost(x, u, p))
        if self.barrier is not None:
            c = c + self.barrier_term(u, p)
        if self.al:
            c = c + self.al_penalty(x, p)
        return c

    def terminal_cost(self, x, p):
        if self.Qf is None:
            c = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        else:
            c = self._quad(self.Qf, x - p[..., :3])
        return c + self.al_penalty(x, p) if self.al else c

    def terminal_grad_hess(self, x, p):
        """Gradient and Hessian of ``terminal_cost`` in x: the weight's
        closed form ``(Qf + Qf')(x - p[:3])`` and ``Qf + Qf'`` (zeros without
        ``Qf``), plus the AL penalty's, ``t s dc`` and ``mu s^2`` on the
        diagonal, s the slope of max(0, y) (1, 0 or at y = 0 one half, as
        jnp.maximum and torch.maximum differentiate it)."""
        Qf = np.zeros((3, 3)) if self.Qf is None else np.asarray(self.Qf)
        W = self._t(Qf + Qf.T, x)
        H = W.expand(x.shape[:-1] + (3, 3))
        g = (H * (x - p[..., :3])[..., None, :]).sum(-1)
        if self.al:
            y, _, mu, dc = self._al_rows(x, p)
            s = (y > 0).to(x.dtype) + 0.5 * (y == 0).to(x.dtype)
            t = torch.maximum(torch.zeros_like(y), y)
            g = g + (t * s * dc)[..., :3] + (t * s * dc)[..., 3:]
            h = mu[..., None] * (s * dc) ** 2
            H = H + torch.diag_embed(h[..., :3] + h[..., 3:])
        return g, H


@dataclasses.dataclass(frozen=True, eq=False)
class TracedDeviceModel:
    """Kernel-side model generated from the trace of an OCP's own callables.

    ``program`` is ``trace.trace_ocp``'s scalar program of the dynamics,
    stage cost, terminal cost and control box; ``codegen.py`` writes it as a
    CUDA model, and the program's own library (``build.traced_entry``)
    instantiates K2 and K3 on it.  The kernels read the hoisted constants
    from ``table(device)``, which follows a hoisted tensor changed in place.
    ``step`` / ``stage_cost`` / ``terminal_cost`` / ``bounds`` evaluate the
    program in PyTorch (``Program.evaluate``), the twin of the generated
    code.  ``with_barrier`` and ``with_al`` return None: the solvers'
    derived OCPs are traced themselves, as the JAX package traces the
    augmented callables.
    """

    program: Program

    def __post_init__(self):
        object.__setattr__(self, "_tables", {})
        object.__setattr__(self, "_entries", {})

    @property
    def nx(self) -> int:
        return self.program.nx

    @property
    def nu(self) -> int:
        return self.program.nu

    @property
    def min_npar(self) -> int:
        return self.program.min_npar

    def with_barrier(self, lb, ub, mu_col: int, rule: str, clip: bool = True):
        """None: the barrier-derived OCP is traced itself."""
        return None

    def with_al(self, x_lb, x_ub, lam_col: int):
        """None: the AL-derived OCP is traced itself."""
        return None

    def table(self, device) -> torch.Tensor:
        """The hoisted constants as the kernels read them: float32 on
        ``device`` (one float at least, so that the pointer is never null).
        One buffer a device, refilled whenever a hoisted tensor has changed
        in place since the last call (its version counter moved), so the
        kernels read the weights the callables read."""
        device = torch.device(device)
        versions = self.program.versions()
        held = self._tables.get(device)
        if held is None or versions is None or held[0] != versions:
            values = self.program.table(torch.float32, device)
            buf = held[1] if held is not None else torch.zeros(
                max(values.numel(), 1), dtype=torch.float32, device=device)
            buf[:values.numel()].copy_(values)
            self._tables[device] = (versions, buf)
            count(traced_table_fills=1)
        return self._tables[device][1]

    def kernel_args(self, device):
        """The model as the kernels' C entry points take it: (no packed
        floats, no packed ints, the device pointer of ``table(device)``)."""
        return None, None, self.table(device).data_ptr()

    def entry(self, name: str):
        """The C entry point ``name`` of the program's library (built at
        the first call, then kept)."""
        if name not in self._entries:
            self._entries[name] = traced_entry(self.program, name)
        return self._entries[name]

    # --- the program in PyTorch (batched over leading dims) ---------------
    def _eval(self, key, like, **inputs):
        return self.program.evaluate(self.program.outputs[key], like=like,
                                     **inputs)

    def step(self, x, u, p):
        return torch.stack(self._eval("step", x, x=x, u=u, p=p), dim=-1)

    def stage_cost(self, x, u, p):
        return self._eval("stage_cost", x, x=x, u=u, p=p)[0]

    def terminal_cost(self, x, p):
        if "terminal_cost" not in self.program.outputs:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return self._eval("terminal_cost", x, x=x, p=p)[0]

    def bounds(self, x, p, k):
        """Stage ``k``'s box at (x, p): k an int, or an integer tensor of
        x's leading dims; (-inf, inf) without a control box."""
        if "lb" not in self.program.outputs:
            inf = torch.full(x.shape[:-1] + (self.nu,), torch.inf,
                             dtype=x.dtype, device=x.device)
            return -inf, inf
        return tuple(torch.stack(self._eval(key, x, x=x, p=p, k=k), dim=-1)
                     for key in ("lb", "ub"))


def traced_device_model(ocp) -> TracedDeviceModel:
    """The device model generated from the trace of ``ocp``'s callables
    (raises ``NotImplementedError`` for an op outside ``trace.LOWERINGS``),
    traced once per OCP object: the model is kept on the OCP."""
    model = ocp.__dict__.get("_traced_device_model")
    if model is None:
        with span("mpc.trace"):
            model = TracedDeviceModel(trace_ocp(ocp))
        count(traced_traces=1)
        object.__setattr__(ocp, "_traced_device_model", model)
    return model


def kernel_model(ocp):
    """The device model the kernels evaluate for ``ocp``: its own
    ``device_model``, else the one traced from its callables."""
    return ocp.device_model if ocp.device_model is not None else \
        traced_device_model(ocp)


def model_entry(model, name: str):
    """The C entry point ``name`` that launches the kernel on ``model``."""
    if isinstance(model, TracedDeviceModel):
        return model.entry(name)
    return getattr(load_library(), name)


def linesearch_occupancy(model, variant: str, threads: int, smem_bytes: int,
                         device=None) -> dict:
    """What the CUDA runtime says of K2's ``variant`` kernel on ``model`` at
    ``threads`` a block and ``smem_bytes`` of dynamic shared memory:
    ``registers`` and ``local_bytes`` (local memory) a thread
    (``cudaFuncGetAttributes``) and ``blocks_per_sm``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), on ``device`` (the
    current CUDA device by default)."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = model_entry(model, "mv_linesearch_occupancy")(
            LINESEARCH_VARIANTS.index(variant), threads, smem_bytes, out)
    check_launch(rc, "mv_linesearch_occupancy")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))


def _checked_model(ocp, nx: int, nu: int, npar: int):
    """``kernel_model(ocp)``; raises ``ValueError`` unless it takes these
    sizes."""
    model = kernel_model(ocp)
    if (nx, nu) != (model.nx, model.nu) or npar < model.min_npar:
        raise ValueError(f"the {type(model).__name__} needs nx={model.nx}, "
                         f"nu={model.nu}, npar>={model.min_npar}")
    return model


def linesearch_forward_torch(x0, xs, us, ps, kffs, Ks, alphas: Sequence[float],
                             *, ocp):
    """Plain PyTorch line search on ``ocp``'s callables (same contract as the kernel).

    Args:
      x0: (B, nx); xs: (B, N+1, nx) nominal states; us: (B, N, nu) nominal
        controls; ps: (B, N+1, npar); kffs: (B, N, nu); Ks: (B, N, nu, nx).
      alphas: step lengths; the first minimum of the cost wins.

    Returns (xs (B, N+1, nx), us (B, N, nu), cost (B,), best (B,) int32):
    the winner's trajectory, its cost and its alpha index.
    """
    if x0.is_cuda:
        linesearch_forward_torch.cuda_calls += 1
    B, N, nu = us.shape
    nx = x0.shape[-1]
    A = len(alphas)
    al = torch.tensor(list(alphas), dtype=x0.dtype, device=x0.device)
    F = vmap(ocp.dynamics)
    l = vmap(ocp.stage_cost)
    cb = ocp.control_bounds
    cbv = None if cb is None else vmap(cb, in_dims=(0, 0, None))
    rep = lambda t: t.expand((A,) + t.shape).reshape((A * B,) + t.shape[1:])

    x = rep(x0)
    xs_c, us_c, cs = [], [], []
    for k in range(N):
        p = rep(ps[:, k])
        u = (rep(us[:, k]) + (al[:, None, None] * kffs[None, :, k]).reshape(
            A * B, nu)) + (rep(Ks[:, k]) @ (x - rep(xs[:, k]))[..., None])[..., 0]
        if cbv is not None:
            lb, ub = cbv(x, p, k)
            u = torch.clamp(u, lb, ub)
        xs_c.append(x)
        us_c.append(u)
        cs.append(l(x, u, p))
        x = F(x, u, p)
    xs_c.append(x)
    cost = torch.stack(cs, dim=-1).sum(-1)
    if ocp.terminal_cost is not None:
        cost = cost + vmap(ocp.terminal_cost)(x, rep(ps[:, N]))
    cost = cost.reshape(A, B)
    best = torch.argmin(cost, dim=0)              # first minimum, like jnp
    pick = best * B + torch.arange(B, device=x0.device)
    xs_b = torch.stack(xs_c, dim=1)[pick]
    us_b = torch.stack(us_c, dim=1)[pick]
    return xs_b, us_b, cost.reshape(-1)[pick], best.to(torch.int32)


linesearch_forward_torch.cuda_calls = 0


def linesearch_forward(x0, xs, us, ps, kffs, Ks, alphas: Sequence[float], *,
                       ocp, variant: Optional[str] = None):
    """Fused line search: the CUDA kernel for CUDA tensors.

    Same arguments and results as ``linesearch_forward_torch``, which is
    what runs when the tensors lie on the CPU.  On the card the kernel
    evaluates ``ocp.device_model`` (a ``UnicycleDeviceModel``), or for an
    OCP without one the model traced from its callables
    (``traced_device_model``, whose library builds at its first launch); a
    callable that does not lower raises ``NotImplementedError``, a failed
    build ``RuntimeError``.  CUDA tensors must be contiguous float32.
    The kernel's variant is ``linesearch_launch_plan``'s choice for the
    shape and the batch; ``variant`` forces another for a comparison on the card (the
    solvers never pass it).  ``launches`` counts every launch and
    ``launches_by_variant`` the launches of each variant.
    """
    if x0.device.type == "cpu":
        return linesearch_forward_torch(x0, xs, us, ps, kffs, Ks, alphas,
                                        ocp=ocp)
    if not x0.is_cuda:
        raise ValueError(f"linesearch_forward: unsupported device {x0.device}")
    B, N, nu = us.shape
    nx, npar = x0.shape[-1], ps.shape[-1]
    A = len(alphas)
    model = _checked_model(ocp, nx, nu, npar)
    plan = linesearch_launch_plan(N, A, npar, variant, nx=nx, nu=nu, B=B)
    named = [("x0", x0, (B, nx)), ("xs", xs, (B, N + 1, nx)),
             ("us", us, (B, N, nu)), ("ps", ps, (B, N + 1, npar)),
             ("kffs", kffs, (B, N, nu)), ("Ks", Ks, (B, N, nu, nx))]
    check_args("linesearch_forward", x0.device, named)

    launch = model_entry(model, "mv_linesearch_forward")
    opts = dict(dtype=torch.float32, device=x0.device)
    xs_o = torch.empty((B, N + 1, nx), **opts)
    us_o = torch.empty((B, N, nu), **opts)
    cost = torch.empty((B,), **opts)
    best = torch.empty((B,), dtype=torch.int32, device=x0.device)
    c_model, c_ints, c_tables = model.kernel_args(x0.device)
    c_alphas = (ctypes.c_float * A)(*map(float, alphas))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            B, N, npar, x0.data_ptr(), xs.data_ptr(),
            us.data_ptr(), ps.data_ptr(), kffs.data_ptr(), Ks.data_ptr(),
            c_model, c_ints, c_tables, c_alphas, A, xs_o.data_ptr(),
            us_o.data_ptr(), cost.data_ptr(), best.data_ptr(),
            LINESEARCH_VARIANTS.index(plan.variant), plan.problems,
            plan.c_layout(), stream)
    check_launch(rc, "mv_linesearch_forward")
    linesearch_forward.launches += 1
    linesearch_forward.launches_by_variant[plan.variant] += 1
    return xs_o, us_o, cost, best


linesearch_forward.launches = 0
linesearch_forward.launches_by_variant = dict.fromkeys(LINESEARCH_VARIANTS, 0)


def trajectory_cost_torch(xs, us, ps, *, ocp):
    """Plain PyTorch cost of (B) trajectories under ``ocp``'s callables,
    elementwise over the stages: the sum of the stage costs plus the
    terminal cost, (B,).  xs (B, N+1, nx), us (B, N, nu), ps (B, N+1,
    npar)."""
    N = ocp.N
    c = vmap(vmap(ocp.stage_cost))(xs[:, :N], us, ps[:, :N]).sum(-1)
    if ocp.terminal_cost is not None:
        c = c + vmap(ocp.terminal_cost)(xs[:, N], ps[:, N])
    return c


def trajectory_cost(xs, us, ps, mask, cost_in, *, ocp):
    """The rounds' cost re-base: the cost of trajectory b where ``mask[b]``,
    ``cost_in[b]`` elsewhere, (B,).

    xs (B, N+1, nx), us (B, N, nu) and ps (B, N+1, npar) as for
    ``trajectory_cost_torch``; mask (B,) bool; cost_in (B,).  On CPU tensors
    ``torch.where(mask, trajectory_cost_torch(...), cost_in)``.  On the card
    one launch of the kernel on ``kernel_model(ocp)``, as
    ``linesearch_forward`` evaluates it: each masked problem's stage costs
    summed in K2's order, no clip and no dynamics (the trajectories are
    rollouts already), and cost_in copied bit for bit elsewhere.  CUDA
    tensors must be contiguous, float32 but for the mask.  ``launches``
    counts every launch.
    """
    if xs.device.type == "cpu":
        return torch.where(mask, trajectory_cost_torch(xs, us, ps, ocp=ocp),
                           cost_in)
    if not xs.is_cuda:
        raise ValueError(f"trajectory_cost: unsupported device {xs.device}")
    B, N, nu = us.shape
    nx, npar = xs.shape[-1], ps.shape[-1]
    model = _checked_model(ocp, nx, nu, npar)
    check_args("trajectory_cost", xs.device,
               [("xs", xs, (B, N + 1, nx)), ("us", us, (B, N, nu)),
                ("ps", ps, (B, N + 1, npar)), ("cost_in", cost_in, (B,))])
    if (mask.device != xs.device or mask.dtype != torch.bool
            or tuple(mask.shape) != (B,) or not mask.is_contiguous()):
        raise ValueError(f"trajectory_cost: mask must be a contiguous bool "
                         f"tensor of shape ({B},) on {xs.device}")

    launch = model_entry(model, "mv_trajectory_cost")
    cost = torch.empty((B,), dtype=torch.float32, device=xs.device)
    c_model, c_ints, c_tables = model.kernel_args(xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(B, N, npar, xs.data_ptr(), us.data_ptr(),
                    ps.data_ptr(), mask.data_ptr(), cost_in.data_ptr(),
                    c_model, c_ints, c_tables, cost.data_ptr(), stream)
    check_launch(rc, "mv_trajectory_cost")
    trajectory_cost.launches += 1
    return cost


trajectory_cost.launches = 0

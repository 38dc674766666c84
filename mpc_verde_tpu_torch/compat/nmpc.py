"""mpctools-style ``nmpc`` front end over the box-DDP solver (port of
``mpc_verde_tpu.compat.nmpc``).

The surface the reference's mpctools scripts use:
  * ``getCasadiFunc(pyfunc, sizes, names, funcname=, rk4=, Delta=, M=)``
  * ``nmpc(f, l, N, x0, lb, ub, p=, funcargs=, inferargs=, uprev=, isQP=,
    verbosity=, Pf=)`` returning a solver object with ``.solve()``,
    ``.fixvar(name, t, value)``, ``.saveguess()``, ``.var["x", k, :]`` /
    ``.var["u", 0, :]``, ``.par["p", k] = v``, ``.stats["status"]`` and
    ``.varsym``
  * ``callSolver(solver)`` -> dict with "status" / "x" / "u" / "obj"
  * ``util.c2d``, ``mtimes``, ``DiscreteSimulator``

The functions a script writes are torch functions of one stage's tensors
(``x (nx,)``, ``u (nu,)``, ``p (np,)``); numpy constants mix in freely
(``mtimes`` turns numpy operands into tensors beside a tensor one).  Move
blocking and Du costs take the rate form (``ocp/rate.py``).

Every ``solve()`` is ``make_ilqr_solver(ocp, options, backend="torch")`` on
the OCP's device: a script's Python function has no device model for the
kernels, and the JAX ``nmpc`` reaches no Pallas kernel either (it jits the
single-problem lax solver).  ``nmpc`` takes one addition, ``device``
(None: the CUDA device, raising where there is none; ``device="cpu"`` for
the CPU).  It solves in float64, as mpctools does: the solver's default
tolerances are made for it.
"""
from __future__ import annotations

import inspect
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..ocp.rate import to_rate_form
from ..ocp.spec import OCP, box_bounds
from ..ops.integrators import DiscreteSimulator as _DiscreteSimulator
from ..ops.integrators import c2d as _c2d
from ..ops.integrators import rk4_step
from ..solver.ilqr import ILQROptions, make_ilqr_solver
from ..utils.platform import scenario_device

__all__ = [
    "getCasadiFunc", "nmpc", "callSolver", "util", "DiscreteSimulator",
    "mtimes", "NMPCSolver",
]

DiscreteSimulator = _DiscreteSimulator


def mtimes(*mats):
    """Chained matrix product (mpctools.mtimes).  With a tensor among the
    operands, numpy operands become tensors of its dtype and device."""
    like = next((m for m in mats if torch.is_tensor(m)), None)
    if like is not None:
        mats = [m if torch.is_tensor(m) else
                torch.as_tensor(np.asarray(m), dtype=like.dtype,
                                device=like.device) for m in mats]
    out = mats[0]
    for m in mats[1:]:
        out = out @ m
    return out


class util:
    """Namespace mirror of ``mpctools.util``."""

    c2d = staticmethod(_c2d)


class SymFunc:
    """A named-argument function wrapper, the ``getCasadiFunc`` product: it
    carries the declared argument names so that ``nmpc`` can route (x, u, p,
    Du) as mpctools' ``inferargs`` / ``funcargs`` machinery does."""

    def __init__(self, fn: Callable, argnames: Sequence[str], name: str = "f"):
        self.fn = fn
        self.argnames = [str(a) for a in argnames]
        self.name = name

    def __call__(self, *args):
        return self.fn(*args)


def getCasadiFunc(pyfunc, sizes=None, names=None, funcname: str = "f",
                  rk4: bool = False, Delta: float = None, M: int = 1):
    """Wrap an ode or a cost.  With ``rk4=True`` the result is the RK4
    discrete step over ``Delta`` with ``M`` substeps, as
    ``mpc.getCasadiFunc(ode, ..., rk4=True, Delta=Delta, M=1)``."""
    if names is None:
        names = list(inspect.signature(pyfunc).parameters)
    names = [str(n) for n in names]
    if not rk4:
        return SymFunc(pyfunc, names, funcname)
    if Delta is None:
        raise ValueError("rk4=True requires Delta")
    has_p = len(names) >= 3

    def rhs(x, u, p):
        return pyfunc(x, u, p) if has_p else pyfunc(x, u)

    step = rk4_step(rhs, Delta, M=M)
    if has_p:
        return SymFunc(lambda x, u, p: step(x, u, p), names, funcname)
    return SymFunc(lambda x, u: step(x, u, None), names, funcname)


def _argnames(func, funcargs_entry, inferargs, default=("x", "u", "p", "Du")):
    if funcargs_entry is not None:
        return [str(a) for a in funcargs_entry]
    if isinstance(func, SymFunc):
        return func.argnames
    if inferargs:
        return list(inspect.signature(func).parameters)
    # inferargs=False and no declared names: mpctools' positional convention
    n = len(inspect.signature(func).parameters)
    return list(default[:n])


def _stage_bound(b, Nt, nu, default):
    if b is None:
        return np.full((Nt, nu), default, dtype=float)
    b = np.asarray(b, dtype=float)
    if b.ndim == 0:
        b = b.reshape(1)
    if b.ndim == 1:
        if b.shape[0] == nu:
            return np.broadcast_to(b, (Nt, nu)).copy()
        if b.shape[0] == Nt:
            return np.broadcast_to(b[:, None], (Nt, nu)).copy()
    if b.ndim == 2:
        # the reference passes (Nt, 1) vstacks for Du move blocking
        return np.broadcast_to(b, (Nt, nu)).copy()
    raise ValueError(f"bad bound shape {b.shape}")


class VarDescriptor(NamedTuple):
    """A decision variable's shape and dtype (``NMPCSolver.varsym``)."""

    shape: tuple
    dtype: torch.dtype


class _VarView:
    """Read access mimicking mpctools' struct indexing: ``v["x", k]`` /
    ``v["x", k, :]`` -> (nx,) array; ``v["x", :, :]`` / ``v["x"]`` -> list
    of per-stage arrays."""

    def __init__(self, solver):
        self._s = solver

    def _tab(self, name):
        if name == "x":
            return self._s._last_xs
        if name == "u":
            return self._s._last_us
        raise KeyError(name)

    def __getitem__(self, key):
        if isinstance(key, str):
            name, rest = key, (slice(None),)
        else:
            name, rest = key[0], key[1:]
        tab = self._tab(name)
        if tab is None:
            raise RuntimeError("no solution yet; call solve() first")
        k = rest[0] if rest else slice(None)
        out = tab[k]
        if len(rest) > 1:
            out = out[..., rest[1]] if not isinstance(rest[1], slice) else out
        if isinstance(k, slice):
            return [np.asarray(row) for row in out]
        return np.asarray(out)


class _ParView:
    """Write access for per-stage parameters: ``solver.par["p", k] = vec``."""

    def __init__(self, solver):
        self._s = solver

    def __setitem__(self, key, value):
        name, k = key[0], key[1]
        if name != "p":
            raise KeyError(name)
        self._s._par[k] = np.asarray(value, dtype=float).ravel()

    def __getitem__(self, key):
        name, k = key[0], key[1]
        if name != "p":
            raise KeyError(name)
        return self._s._par[k]


class NMPCSolver:
    """The object ``nmpc`` returns: mpctools solver-object semantics."""

    def __init__(self, ocp: OCP, options: ILQROptions, x0, par, uprev,
                 rate_form: bool, nx_orig: int, nu: int, npar: int):
        self._ocp = ocp
        self._rate_form = rate_form
        self._nx = nx_orig
        self._nu = nu
        self._npar = npar
        self._x0 = np.asarray(x0, dtype=float).copy()
        self._uprev = (None if uprev is None
                       else np.asarray(uprev, dtype=float).copy())
        self._par = np.zeros((ocp.N, max(npar, 1)), dtype=float)
        if par is not None:
            p = np.asarray(par, dtype=float)
            if p.ndim == 1:
                p = np.broadcast_to(p, (ocp.N, p.shape[0]))
            self._par[:, : p.shape[1]] = p
        self._guess = np.zeros((ocp.N, nu), dtype=float)
        self._last_xs = None  # (N+1, nx_orig)
        self._last_us = None  # (N, nu)
        self._last_res_us = None
        self.stats = {"status": "NotSolved"}
        self.var = _VarView(self)
        self.par = _ParView(self)
        self._solve_fn = make_ilqr_solver(ocp, options, backend="torch")

    @property
    def varsym(self):
        """Decision-variable descriptors keyed like mpctools' CasADi symbol
        struct: per-stage ``VarDescriptor(shape, dtype)`` lists, the
        counterpart of the JAX package's ``jax.ShapeDtypeStruct`` lists."""
        dt, N = self._ocp.dtype, self._ocp.N
        out = {"x": [VarDescriptor((self._nx,), dt) for _ in range(N + 1)],
               "u": [VarDescriptor((self._nu,), dt) for _ in range(N)]}
        if self._rate_form:
            out["Du"] = [VarDescriptor((self._nu,), dt) for _ in range(N)]
        return out

    def fixvar(self, name: str, t: int, value) -> None:
        """``fixvar("x", 0, x0)`` pins the initial state (the only use in the
        reference scripts).  It is the receding-horizon advance signal, so it
        also rolls the rate-form ``uprev`` to the last applied control, which
        keeps ``solve()`` itself idempotent."""
        if name != "x" or t != 0:
            raise NotImplementedError("only fixvar('x', 0, value) is supported")
        self._x0 = np.asarray(value, dtype=float).ravel()[: self._nx].copy()
        if self._rate_form and self._last_us is not None:
            self._uprev = np.atleast_1d(self._last_us[0]).astype(float).copy()

    def saveguess(self) -> None:
        """Keep the last solution as the next warm start (used as it is)."""
        if self._last_res_us is not None:
            self._guess = self._last_res_us.copy()

    def solve(self):
        if self._rate_form:
            uprev = self._uprev if self._uprev is not None else np.zeros(self._nu)
            z0 = np.concatenate([self._x0, uprev])
        else:
            z0 = self._x0
        params = np.concatenate([self._par, self._par[-1:]], axis=0)  # stage N
        res = self._solve_fn(z0, params, self._guess)
        xs = res.xs.double().cpu().numpy()
        us = res.us.double().cpu().numpy()
        if self._rate_form:
            us_abs = xs[:-1, self._nx:] + us
            xs_out = xs[:, : self._nx]
        else:
            us_abs, xs_out = us, xs
        self._last_xs = xs_out
        self._last_us = us_abs
        self._last_res_us = us
        self.stats = {
            "status": ("Solve_Succeeded" if bool(res.converged)
                       else "Maximum_Iterations_Exceeded"),
            "obj": float(res.cost),
            "iterations": int(res.iterations),
        }
        return self.stats


def nmpc(f=None, l=None, N=None, x0=None, lb=None, ub=None, p=None,
         funcargs=None, inferargs=False, uprev=None, isQP=False,
         verbosity=0, Pf=None, device=None, **kwargs):
    """Build an MPC solver object, a drop-in for ``mpctools.nmpc``; returns
    an ``NMPCSolver``.  ``device``: where the OCP and its solves live (the
    port's addition; see the module docstring)."""
    if N is None or f is None or l is None:
        raise ValueError("f, l, N are required")
    dev = scenario_device(device, "nmpc")
    dtype = torch.float64
    Nx, Nu, Nt = int(N["x"]), int(N["u"]), int(N["t"])
    Np = int(N.get("p", 0))

    lb = dict(lb or {})
    ub = dict(ub or {})
    has_du = "Du" in lb or "Du" in ub
    f_args = _argnames(f, (funcargs or {}).get(getattr(f, "name", "f")),
                       inferargs)
    l_args = _argnames(l, (funcargs or {}).get("l"), inferargs)
    has_du_cost = "du" in [a.lower() for a in l_args]
    rate_form = has_du or has_du_cost or uprev is not None
    f_has_p = len(f_args) >= 3 and f_args[2].lower() == "p"

    def dynamics(x, u, pp):
        return f(x, u, pp[:Np]) if f_has_p else f(x, u)

    def call_l(x, u, pp, du):
        vals = {"x": x, "u": u, "p": pp[:Np], "du": du}
        return l(*[vals[a.lower()] for a in l_args])

    u_lb = _stage_bound(lb.get("u"), Nt, Nu, -np.inf)
    u_ub = _stage_bound(ub.get("u"), Nt, Nu, np.inf)

    def x_bound(b, fill):
        if b is None:
            return None
        b = np.asarray(b, float)
        b = np.where(np.isfinite(b), b, fill)
        return b if np.any(np.isfinite(b)) else None

    x_lb, x_ub = x_bound(lb.get("x"), -np.inf), x_bound(ub.get("x"), np.inf)

    terminal = None
    if Pf is not None:
        Pf_t = torch.as_tensor(np.asarray(Pf, dtype=float), dtype=dtype,
                               device=dev)
        terminal = lambda x, pp: x @ Pf_t @ x

    if rate_form:
        ocp = to_rate_form(
            dynamics, call_l, N=Nt, nx=Nx, nu=Nu, npar=max(Np, 0),
            terminal_cost=terminal, u_lb=u_lb, u_ub=u_ub,
            du_lb=_stage_bound(lb.get("Du"), Nt, Nu, -np.inf),
            du_ub=_stage_bound(ub.get("Du"), Nt, Nu, np.inf),
            x_lb=x_lb, x_ub=x_ub, device=dev, dtype=dtype)
    else:
        t = lambda b: None if b is None else torch.as_tensor(b, dtype=dtype,
                                                             device=dev)
        ocp = OCP(
            dynamics=dynamics,
            stage_cost=lambda x, u, pp: call_l(x, u, pp, torch.zeros_like(u)),
            terminal_cost=terminal, N=Nt, nx=Nx, nu=Nu, npar=max(Np, 0),
            control_bounds=box_bounds(u_lb, u_ub, device=dev, dtype=dtype),
            x_lb=t(x_lb), x_ub=t(x_ub), device=dev, dtype=dtype)

    options = ILQROptions(
        max_iters=30 if isQP else 80,
        al_iters=3 if (x_lb is not None or x_ub is not None) else 0,
    )
    return NMPCSolver(ocp, options, x0 if x0 is not None else np.zeros(Nx),
                      p, uprev, rate_form, Nx, Nu, max(Np, 0))


def callSolver(solver: NMPCSolver):
    """``mpc.callSolver(solver)`` -> {"status", "x", "u", "obj"}."""
    stats = solver.solve()
    return {
        "status": stats["status"],
        "x": np.asarray(solver._last_xs),
        "u": np.asarray(solver._last_us),
        "obj": stats["obj"],
    }

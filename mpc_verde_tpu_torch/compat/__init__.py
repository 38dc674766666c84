"""mpctools-compatible API surface (port of ``mpc_verde_tpu.compat``).

Code written against the reference's MPCTools contract runs on the port
with the same call shapes:

    import mpc_verde_tpu_torch.compat as mpc
    f = mpc.getCasadiFunc(ode, [Nx, Nu], ["x", "u"], rk4=True, Delta=dt)
    solver = mpc.nmpc(f, l, N, x0, lb, ub, p=p, uprev=uprev, funcargs=...)
    solver.fixvar("x", 0, x0); solver.solve(); u0 = solver.var["u", 0, :]

The CasADi-compatible symbolic layer (SX / DM / Function / nlpsol) is
``mpc_verde_tpu_torch.compat.casadi``, and ``mpc.plots.mpcplot`` /
``showandsave`` draw as ``mpctools.plots`` does (``viz``).
"""
from . import casadi, plots
from .nmpc import (DiscreteSimulator, NMPCSolver, callSolver, getCasadiFunc,
                   mtimes, nmpc, util)

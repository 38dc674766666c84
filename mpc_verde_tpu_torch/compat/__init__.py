"""mpctools-compatible API surface (port of ``mpc_verde_tpu.compat``).

Code written against the reference's MPCTools contract runs on the port
with the same call shapes:

    import mpc_verde_tpu_torch.compat as mpc
    f = mpc.getCasadiFunc(ode, [Nx, Nu], ["x", "u"], rk4=True, Delta=dt)
    solver = mpc.nmpc(f, l, N, x0, lb, ub, p=p, uprev=uprev, funcargs=...)
    solver.fixvar("x", 0, x0); solver.solve(); u0 = solver.var["u", 0, :]

The CasADi-compatible symbolic layer (SX / DM / Function / nlpsol) is
``mpc_verde_tpu_torch.compat.casadi``.  The JAX package's ``compat.plots``
waits for the port of ``viz/``.
"""
from . import casadi
from .nmpc import (DiscreteSimulator, NMPCSolver, callSolver, getCasadiFunc,
                   mtimes, nmpc, util)

"""``mpctools.plots`` namespace mirror (port of ``mpc_verde_tpu.compat.plots``).

The reference imports ``mpctools.plots as mpcplots`` and calls
``mpc.plots.mpcplot(...)`` / ``showandsave(fig, name)``
(``Casadi/single_shooting_v1.py:236-238``); route those to viz.
"""
from ..viz.plots import mpcplot, showandsave  # noqa: F401

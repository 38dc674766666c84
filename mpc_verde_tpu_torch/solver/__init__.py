from .boxqp import solve_boxqp
from .ilqr import ILQROptions, ILQRResult, make_ilqr_solver
from .batched import make_batched_ilqr_solver
from .streaming import make_streaming_solver
from .ipm import make_barrier_solver, make_streaming_barrier_solver

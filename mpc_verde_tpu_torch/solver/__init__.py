from .boxqp import solve_boxqp
from .ilqr import ILQROptions, ILQRResult
from .batched import make_batched_ilqr_solver
from .streaming import make_streaming_solver

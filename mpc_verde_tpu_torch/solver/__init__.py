from .boxqp import solve_boxqp
from .ilqr import ILQROptions, ILQRResult, make_ilqr_solver
from .batched import make_batched_ilqr_solver
from .streaming import make_streaming_solver
from .ipm import make_barrier_solver, make_streaming_barrier_solver
from .condensed import (blocking_matrix, condense, prediction_matrices,
                        solve_condensed, solve_dense_boxqp)
from .multiple_shooting import make_batched_ms_solver, make_ms_solver
from .warmstart import make_lqr_warm_start
from .nlp import NLPOptions, NLPResult, make_nlpsol

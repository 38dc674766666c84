from .integrators import (DiscreteSimulator, c2d, discretize, euler_step,
                          rk4_step, rk4_step_with_quadrature, rk45_step)
from .linearize import linearize_dynamics, quadratize_cost, linearize_trajectory
from .parallel_riccati import (lq_backward_parallel, lqt_backward_parallel,
                               lqt_gains, lqt_solve_parallel)

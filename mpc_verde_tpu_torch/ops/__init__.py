from .integrators import (DiscreteSimulator, c2d, discretize, euler_step,
                          rk4_step, rk4_step_with_quadrature, rk45_step)
from .linearize import linearize_dynamics, quadratize_cost, linearize_trajectory

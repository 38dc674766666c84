from .integrators import euler_step, rk4_step
from .linearize import linearize_dynamics, quadratize_cost, linearize_trajectory

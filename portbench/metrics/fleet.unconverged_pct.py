"""Share (%) of the window's robot-steps whose solve stopped unconverged
(``ClosedLoopResult.converged`` false): the stragglers that hold a
step at the iteration cap.  Such a step still applies its best
control; it is not a fault."""
from harness import readers


def read(ctx):
    return readers.unconverged_pct(ctx, "robot_steps")

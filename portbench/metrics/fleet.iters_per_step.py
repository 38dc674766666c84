"""Solver iterations per MPC step of the window: the batched loop runs until
its last robot stops, so a step costs the largest of its robots'
``ClosedLoopResult.iterations``; this is that largest, averaged over the
steps."""
from harness import readers


def read(ctx):
    return readers.per_op(ctx, "loop_iterations", "steps")

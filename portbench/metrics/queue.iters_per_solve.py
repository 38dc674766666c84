"""Solver iterations per solve of the window, restarts and rounds included
(``ILQRResult.iterations`` of every returned solve)."""
from harness import readers


def read(ctx):
    return readers.per_op(ctx, "iterations", "solves")

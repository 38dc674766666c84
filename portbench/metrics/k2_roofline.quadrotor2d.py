"""Share (%) of K2's least time in its device time over the traced block,
on the planar quadrotor's traced program: the line search of width x N x A
candidates a launch and one pre-roll (A = 1 over the rows of a call) a
call, counted from the shapes and the program's frozen operation count
(``harness/roofline_quadrotor2d.py``), over the time of the kernels named
here instantiated on a generated model.  None without a trace or without
a line search on such a model in it."""
from harness import roofline_quadrotor2d as rq

KERNELS = ("linesearch_lanes_kernel", "linesearch_thread_kernel")


def read(ctx):
    tr = ctx["trace"]
    t = rq.times(tr, KERNELS)
    n_search = len(t) - tr["calls"] if t else 0
    if n_search <= 0:
        return None
    least = (n_search * rq.k2_least_s(tr["width"], tr["N"], tr["A"], tr["nx"],
                                      tr["nu"], tr["npar"])
             + tr["calls"] * rq.k2_least_s(tr["rows_per_call"], tr["N"], 1,
                                           tr["nx"], tr["nu"], tr["npar"]))
    return 100.0 * least / sum(t)

"""Share (%) of K3's least time in its device time over the traced block,
on the planar quadrotor's traced program: the stage derivatives and
backward of width x N stages a launch, counted from the shapes and the
program's frozen operation count (``harness/roofline_quadrotor2d.py``),
over the time of the kernels named here instantiated on a generated model.
None without a trace or without such a kernel in it."""
from harness import roofline_quadrotor2d as rq

KERNELS = ("fused_staged_kernel", "fused_thread_kernel")


def read(ctx):
    tr = ctx["trace"]
    t = rq.times(tr, KERNELS)
    if not t:
        return None
    least = len(t) * rq.k3_least_s(tr["width"], tr["N"], tr["nx"], tr["nu"],
                                   tr["npar"])
    return 100.0 * least / sum(t)

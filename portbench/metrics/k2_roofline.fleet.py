"""Share (%) of K2's least time in its device time over the traced block:
the line search of width x N x A candidates a launch and one pre-roll a
call or step, counted from the shapes and the model's terms
(``harness/roofline.py``), over the time of the kernels named here."""
from harness import readers

KERNELS = ("linesearch_lanes_kernel", "linesearch_thread_kernel")


def read(ctx):
    return readers.k2_roofline(ctx, KERNELS)

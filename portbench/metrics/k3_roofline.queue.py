"""Share (%) of K3's least time in its device time over the traced block:
the stage derivatives and backward of width x N stages a launch, counted
from the shapes and the model's terms (``harness/roofline.py``), over
the time of the kernels named here."""
from harness import readers

KERNELS = ("fused_staged_kernel", "fused_thread_kernel")


def read(ctx):
    return readers.k3_roofline(ctx, KERNELS)

"""Device kernels of the traced block per K3 launch (one a solver
iteration): the refill, accept and restart glue launched around K3 and K2."""
from harness import readers


def read(ctx):
    return readers.launches_per_iter(ctx)

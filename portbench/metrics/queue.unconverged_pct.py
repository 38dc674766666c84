"""Share (%) of the window's solves that the solver returned unconverged
(``ILQRResult.converged`` false); not a fault, and not counted in
``solves_per_s``."""
from harness import readers


def read(ctx):
    return readers.unconverged_pct(ctx, "solves")

"""Share (%) of the traced block in which no operation ran on the card."""
from harness import readers


def read(ctx):
    return readers.idle_pct(ctx)

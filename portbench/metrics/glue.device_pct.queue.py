"""Share (%) of the traced block's kernel time outside K2 and K3."""
from harness import readers


def read(ctx):
    return readers.glue_device_pct(ctx)

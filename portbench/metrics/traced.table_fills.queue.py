"""Refills of the traced device models' table buffers over the whole run,
set-up included: the port's counter ``traced_table_fills``
(``utils.profiling.counters()``), read after the window.  The table is
filled once, at the first launch, and again only where a hoisted weight
changed in place: a sound run reads 1, a refill at every launch tens of
thousands.  None where the port keeps no such counter."""


def read(ctx):
    from mpc_verde_tpu_torch.utils.profiling import counters

    return counters().get("traced_table_fills")

"""Data-parallel scale-out over ``torch.distributed`` (port of
``mpc_verde_tpu.parallel``)."""
from .mesh import (BATCH_AXIS, batch_group, batch_mesh, distributed_init,
                   rank_device)
from .batch import BatchStats, gather_result, make_sharded_solver

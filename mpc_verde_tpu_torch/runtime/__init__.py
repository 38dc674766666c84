from .receding import (ClosedLoopResult, make_batched_receding_horizon,
                       make_receding_horizon, shift_warm_start)

"""Device time of a call, by CUDA events."""
from __future__ import annotations

import torch

_SPIN_CYCLES = 40_000_000   # about 20 ms at the H100's clock


def device_time_ms(fn, reps: int, warmup: int = 2, queued: bool = True) -> float:
    """Mean device time in ms of one ``fn()``, by CUDA events around ``reps`` calls.

    With ``queued`` the device first spins for about 20 ms, so that the host
    has queued every call by the time the first one starts: a kernel shorter
    than its wrapper's host time is then timed back to back, not at the
    host's pace.  Should the host still be queueing when the device has run
    dry (the end event is complete as soon as it is recorded), the time
    would be the host's, and the call raises instead of returning it.
    Without ``queued`` the calls are timed at whatever pace the host sets:
    the honest time of a function that is many launches, as an eager PyTorch
    version is.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(_SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if queued and end.query():
        raise RuntimeError(
            f"device_time_ms: the device finished {reps} calls before the "
            "host had queued them, so the events would time the host; use "
            "fewer reps or a longer spin")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

"""Device time of a call on the card, by kernel name, for the tools and
``chip_smoke.py``.

    from fvt_tpu_torch.tools.timing import device_ms

Plain Python beside ``torch``: ``tools/time_serving_kernels.py`` loads
this file from beside itself when it times another checkout's package.
"""
from __future__ import annotations

from typing import Optional

import torch


def device_ms(fn, kernels: tuple, passes: int = 20,
              tries: int = 3) -> Optional[float]:
    """Device time a call of ``fn`` spends in the kernels whose names hold
    one of ``kernels`` (``torch.profiler`` over ``passes`` calls, after
    one call).  The profiler now and then records no device activity for
    a window: the window is taken again, up to ``tries`` times, and None
    ("not measured") is returned if it never does."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(passes):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if any(k in e.key for k in kernels):
                t = getattr(e, 'device_time_total', None)
                total += e.cuda_time_total if t is None else t
        if total > 0:
            return total / passes / 1e3
    return None

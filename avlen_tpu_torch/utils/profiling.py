"""Profiling helpers.

PyTorch counterpart of ``avlen_tpu/utils/profiling.py``: the reference's
env_time/pth_time splits (av_nav/ppo/ppo_trainer.py:326-336) as
``Timings``, habitat's profiling_wrapper range contexts
(habitat/utils/profiling_wrapper.py:62) as ``torch.profiler``
record_function ranges, and a ``torch.profiler`` session around a training
window whose trace TensorBoard's profile plugin reads. Only ``Timings`` is
on the train path.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timings:
    """Accumulating named wall-clock splits (env_time / pth_time style)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0

    def summary(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in sorted(self.totals.items()))

    def reset(self) -> None:
        self.totals.clear()


@contextlib.contextmanager
def range_context(name: str) -> Iterator[None]:
    """profiling_wrapper.RangeContext equivalent: a named profiler range."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler session (CPU and, where there is one, CUDA) whose
    trace is written to ``log_dir`` for TensorBoard."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield

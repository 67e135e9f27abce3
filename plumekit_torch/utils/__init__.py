"""Shared utilities (``plumekit/utils``): logging, the metrics CSV, stage
timers with a profiler scope, and the NaN guard."""

from plumekit_torch.utils.debugging import checked
from plumekit_torch.utils.logging import get_logger
from plumekit_torch.utils.metrics import MetricsWriter
from plumekit_torch.utils.timers import StageTimes, Timer, profile_trace

__all__ = ["MetricsWriter", "StageTimes", "Timer", "checked", "get_logger",
           "profile_trace"]

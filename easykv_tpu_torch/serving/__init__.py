from .engine import ContinuousBatchEngine, Request
from .scheduled import ScheduledBatchEngine

__all__ = ["ContinuousBatchEngine", "Request", "ScheduledBatchEngine"]

from .scheduler import DECODE, PREFILL_CHUNK, Action, NativeScheduler

__all__ = ["Action", "DECODE", "NativeScheduler", "PREFILL_CHUNK"]

from . import attention, rope

__all__ = ["attention", "rope"]

from .loader import SafetensorsFile, load_safetensors_dir, save_safetensors
from .scheduler import DECODE, PREFILL_CHUNK, Action, NativeScheduler

__all__ = ["Action", "DECODE", "NativeScheduler", "PREFILL_CHUNK", "SafetensorsFile",
           "load_safetensors_dir", "save_safetensors"]

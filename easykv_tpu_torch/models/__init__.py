from . import convert, llama
from .llama import init_params

__all__ = ["convert", "init_params", "llama"]

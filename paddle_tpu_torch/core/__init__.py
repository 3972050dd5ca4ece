from .dtype import to_torch
from .flags import get_flag, set_flags
from .generator import seed
from .place import CPUPlace, CUDAPlace, resolve_device

__all__ = ["CPUPlace", "CUDAPlace", "get_flag", "resolve_device", "seed",
           "set_flags", "to_torch"]

from .dtype import to_torch
from .generator import seed
from .place import CPUPlace, CUDAPlace, resolve_device

__all__ = ["CPUPlace", "CUDAPlace", "resolve_device", "seed", "to_torch"]

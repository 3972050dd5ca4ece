from .auto_cast import auto_cast, decorate

__all__ = ["auto_cast", "decorate"]

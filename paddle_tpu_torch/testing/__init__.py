"""Helpers for tests and smoke runs. Counterpart of paddle_tpu/testing,
cut to the custom-op API's example op (``custom_scale``: K9)."""
from . import custom_scale

__all__ = ["custom_scale"]

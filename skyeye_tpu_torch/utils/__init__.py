"""Utilities of the port: the JAX weight bridge and small shared helpers."""
from .checkpoint import from_jax_variables
from .general import check_img_size, resolve_device

__all__ = ["from_jax_variables", "check_img_size", "resolve_device"]

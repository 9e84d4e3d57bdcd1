"""Decode loops over the port's models."""
from .generate import generate_kv

__all__ = ["generate_kv"]

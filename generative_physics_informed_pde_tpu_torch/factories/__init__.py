"""Named presets of the port."""

from .model import ModelFactory, highres32

__all__ = ["ModelFactory", "highres32"]

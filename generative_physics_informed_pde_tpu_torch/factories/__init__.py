"""Named presets of the port: models (``model.py``) and data
(``data.py``)."""

from .data import DataFactory
from .model import ModelFactory, highres, highres32, highres128

__all__ = ["DataFactory", "ModelFactory", "highres", "highres32",
           "highres128"]

"""Named presets of the port: models (``model.py``) and data
(``data.py``)."""

from .data import DataFactory
from .model import ModelFactory, fetch_dtype, highres, highres32, highres128

__all__ = ["DataFactory", "ModelFactory", "fetch_dtype", "highres",
           "highres32", "highres128"]

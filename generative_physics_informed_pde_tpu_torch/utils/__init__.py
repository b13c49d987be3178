"""Small helpers shared across the port: device resolution, timing,
experiment databases, string helpers."""

from .device import resolve_device
from .strings import ensure_file_extension
from .time import StopWatch, Timer
from .database import ParameterStudy, ResultsDatabase, ParallelStudyPoolBoy

__all__ = ["resolve_device", "ensure_file_extension", "StopWatch", "Timer",
           "ParameterStudy", "ResultsDatabase", "ParallelStudyPoolBoy"]

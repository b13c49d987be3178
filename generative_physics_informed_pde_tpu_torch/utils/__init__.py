"""Small helpers shared across the port: device resolution, timing and
spans, experiment databases, string helpers, parameter utilities.  Plotting
(``utils/plotting.py``) and the sparse conversions are imported from
their modules; the JAX package's ``utils/backend.py`` (JAX platform
probing) has no counterpart."""

from .device import resolve_device
from .strings import ensure_file_extension
from .time import (StopWatch, Timer, span, span_records, span_totals,
                   reset_spans)
from .database import ParameterStudy, ResultsDatabase, ParallelStudyPoolBoy
from .params import (count_parameters, global_norm, freeze_mask,
                     freeze_optimizer)

__all__ = ["resolve_device", "ensure_file_extension", "StopWatch", "Timer",
           "span", "span_records", "span_totals", "reset_spans",
           "ParameterStudy", "ResultsDatabase", "ParallelStudyPoolBoy",
           "count_parameters", "global_norm", "freeze_mask",
           "freeze_optimizer"]

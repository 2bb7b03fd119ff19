"""Shared infrastructure: types, logging, errors, dates, DB, GeoTIFF IO.

The port's copy of ``satellite_approximation_tpu/utils``, with the same
re-exports; replaces the reference's lib/utils (GDAL/SQLiteCpp/boost/spdlog).
"""

from .types import f32, f64, i32, u8, u16, percent_non_zero, count_non_zero
from .dates import Date
from .errors import IOError_, DBError, GenericError
from .log import create_logger, set_log_level, LogLevel

__all__ = [
    "f32",
    "f64",
    "i32",
    "u8",
    "u16",
    "percent_non_zero",
    "count_non_zero",
    "Date",
    "IOError_",
    "DBError",
    "GenericError",
    "create_logger",
    "set_log_level",
    "LogLevel",
]

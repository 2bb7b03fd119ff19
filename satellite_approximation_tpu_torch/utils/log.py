"""Structured logging: named loggers, console + per-logger file sinks.

Replaces the reference's lib/utils/{log.h,log.cpp} (spdlog): console sink at
WARNING, per-logger file ``logs/<name>.log`` at DEBUG, plus a Python-exposed
``set_log_level`` matching the pybind surface (reference src/main.cpp:24-34).
"""

from __future__ import annotations

import enum
import logging
import os
from pathlib import Path

_FORMAT = "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s"
_loggers: dict[str, logging.Logger] = {}
_console_handler: logging.StreamHandler | None = None


class LogLevel(enum.Enum):
    """Log levels exposed to users (reference src/main.cpp:24-29)."""

    Debug = logging.DEBUG
    Info = logging.INFO
    Warn = logging.WARNING
    Error = logging.ERROR
    Critical = logging.CRITICAL


def log_location() -> Path:
    """Directory where per-logger files go: ``cwd/logs`` (reference log.cpp:35-38)."""
    return Path(os.getcwd()) / "logs"


def _get_console_handler() -> logging.StreamHandler:
    global _console_handler
    if _console_handler is None:
        _console_handler = logging.StreamHandler()
        _console_handler.setLevel(logging.WARNING)
        _console_handler.setFormatter(logging.Formatter(_FORMAT))
    return _console_handler


def create_logger(name: str, file_sink: bool = False) -> logging.Logger:
    """Named logger with console sink at WARNING (reference log.cpp:10-32).

    File sinks are opt-in (unlike the reference, which always wrote
    ``logs/<name>.log`` — a surprise side effect in library code).
    """
    full = f"satapprox.{name}"
    if full in _loggers:
        return _loggers[full]
    logger = logging.getLogger(full)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.addHandler(_get_console_handler())
    if file_sink:
        loc = log_location()
        loc.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(loc / f"{name}.log")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    _loggers[full] = logger
    return logger


def set_log_level(level: LogLevel | int) -> None:
    """Set the console log level globally (reference src/main.cpp:30-34)."""
    value = level.value if isinstance(level, LogLevel) else int(level)
    _get_console_handler().setLevel(value)

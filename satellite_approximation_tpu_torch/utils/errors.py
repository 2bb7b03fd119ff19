"""Error types that log on construction.

Replaces the reference's lib/utils/{error.h,error.cpp}: IOError (logs the
offending path), DBError (sqlite context), GenericError.
"""

from __future__ import annotations

from pathlib import Path

from .log import create_logger

_logger = create_logger("utils.error")


class IOError_(RuntimeError):
    """IO failure carrying the offending path (reference error.cpp:7-15)."""

    def __init__(self, message: str, path: Path | str | None = None):
        self.path = Path(path) if path is not None else None
        full = f"{message}" + (f" (path: {self.path})" if self.path else "")
        _logger.error(full)
        super().__init__(full)


class DBError(RuntimeError):
    """Database failure (reference error.cpp:17-25)."""

    def __init__(self, message: str):
        _logger.error(message)
        super().__init__(message)


class GenericError(RuntimeError):
    """Generic failure, logged at construction (reference error.cpp:27-35)."""

    def __init__(self, message: str):
        _logger.error(message)
        super().__init__(message)

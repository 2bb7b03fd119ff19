"""Pick the best replacement date for Poisson gap filling.

Rebuild of ``approx::find_good_close_image`` (poisson.cpp:323-349): among
dates within ±1 calendar month, minimize weight*days + (1-weight)*invalid%;
if the current date already has fewer invalid pixels than the best
candidate, keep the current date (use Laplace instead of Poisson there).
"""

from __future__ import annotations

from ..utils.dates import Date
from ..utils.db import DataBase
from ..utils.errors import GenericError
from ..utils.log import create_logger

_logger = create_logger("approx.closest")


def find_good_close_image(date_string: str, distance_weight: float, db: DataBase) -> str:
    if distance_weight < 0 or distance_weight > 1:
        raise GenericError("Could not find close image: distance weight not between 0 and 1")

    date = Date.from_string(date_string)
    info = db.select_close_images(date)
    if not info:
        _logger.warning("Could not find any good images close by. Date: %s", date)
        return ""

    info.sort(key=lambda d: d.distance(date, distance_weight))
    current = db.select_info_about_date(date)
    if current.percent_invalid < info[0].percent_invalid:
        _logger.debug(
            "The current date has fewer invalid pixels than the date we found. "
            "Use laplace approximation"
        )
        return date_string

    best = info[0]
    _logger.debug("Found image: %s %.2f%% invalid", best.date, 100 * best.percent_invalid)
    return str(best.date)

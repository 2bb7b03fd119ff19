"""Calendar date type with the reference's conventions.

Replaces lib/utils/{date.h,date.cpp} (boost::gregorian): construction from
``YYYY-MM-DD`` strings, ordering, hashing, SQL binding order (year, month,
day), and the ±1-month window arithmetic used by ``select_close_images``
(lib/approx/source/db.cpp:92-133).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re

_DATE_RE = re.compile(r"^(\d{4})-(\d{2})-(\d{2})$")


@dataclasses.dataclass(frozen=True, order=True)
class Date:
    year: int = 0
    month: int = 0
    day: int = 0

    @classmethod
    def from_string(cls, date_string: str) -> "Date":
        """Parse ``YYYY-MM-DD`` (reference date.cpp:12-19)."""
        m = _DATE_RE.match(date_string.strip())
        if not m:
            # boost::from_simple_string also accepts e.g. "2019-May-22";
            # fall back to fromisoformat for robustness.
            d = _dt.date.fromisoformat(date_string.strip())
            return cls(d.year, d.month, d.day)
        return cls(int(m.group(1)), int(m.group(2)), int(m.group(3)))

    @classmethod
    def from_date(cls, d: _dt.date) -> "Date":
        return cls(d.year, d.month, d.day)

    def to_date(self) -> _dt.date:
        return _dt.date(self.year, self.month, self.day)

    def __str__(self) -> str:  # reference date.cpp:31-36
        return f"{self.year}-{self.month:02d}-{self.day:02d}"

    def days_between(self, other: "Date") -> int:
        """|self - other| in days (reference approx/db.cpp:12-16)."""
        return abs((self.to_date() - other.to_date()).days)

    def add_months(self, months: int) -> "Date":
        """Shift by whole months, clamping the day like boost's month
        arithmetic (snap-to-end-of-month)."""
        total = self.year * 12 + (self.month - 1) + months
        year, month = divmod(total, 12)
        month += 1
        # clamp day to the target month's length
        if month == 12:
            nxt = _dt.date(year + 1, 1, 1)
        else:
            nxt = _dt.date(year, month + 1, 1)
        last_day = (nxt - _dt.timedelta(days=1)).day
        return Date(year, month, min(self.day, last_day))

    def sql_params(self) -> tuple[int, int, int]:
        """Binding order for SQL statements (reference date.cpp:38-46)."""
        return (self.year, self.month, self.day)

"""SQLite status database with the reference's schemas and resume semantics.

Replaces three reference layers with one module:
* lib/utils/{db.h,db.cpp} — base ``dates`` table + ``get_status``;
* lib/cloud_shadow_detection/source/db.cpp — detection Status upserts,
  ``find_downloaded_dates``, ``get_detection_results``;
* lib/approx/source/db.cpp — ``approximated_data`` table, approximation
  status caching, ``select_close_images`` (±1 calendar month).

Reference bugs fixed rather than replicated (SURVEY.md §7): missing return in
``get_status`` no-row path (utils/db.cpp:16-27), un-reset prepared statements,
and the bind-index off-by-one in ``write_approx_results`` (approx/db.cpp:51-56).
"""

from __future__ import annotations

import dataclasses
import enum
import sqlite3
from pathlib import Path

from .dates import Date
from .log import create_logger

_logger = create_logger("utils.db")

_DATES_SCHEMA = """
CREATE TABLE IF NOT EXISTS dates(
    year INTEGER NOT NULL,
    month INTEGER NOT NULL,
    day INTEGER NOT NULL,
    clouds_computed INTEGER,
    shadows_computed INTEGER,
    percent_cloudy REAL,
    percent_shadows REAL,
    percent_invalid REAL,
    PRIMARY KEY(year, month, day));
"""

_APPROX_SCHEMA = """
CREATE TABLE IF NOT EXISTS approximated_data(
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    band_name TEXT,
    method TEXT,
    year INTEGER NOT NULL,
    month INTEGER NOT NULL,
    day INTEGER NOT NULL,
    FOREIGN KEY(year, month, day) REFERENCES dates(year, month, day));
"""

_UPSERT_SQL = """
INSERT INTO dates (year, month, day, clouds_computed, shadows_computed,
                   percent_cloudy, percent_shadows, percent_invalid)
VALUES(?, ?, ?, ?, ?, ?, ?, ?)
ON CONFLICT(year, month, day) DO UPDATE SET
    clouds_computed = excluded.clouds_computed,
    shadows_computed = excluded.shadows_computed,
    percent_cloudy = excluded.percent_cloudy,
    percent_shadows = excluded.percent_shadows,
    percent_invalid = excluded.percent_invalid;
"""


class ApproxMethod(enum.Enum):
    """Approximation method tag (reference approx/db.h:21-24)."""

    Laplace = "Laplace"
    Poisson = "Poisson"


@dataclasses.dataclass
class CloudShadowStatus:
    """Row of the ``dates`` table seen by the fill side (utils/db.h:13-17)."""

    clouds_exist: bool = False
    shadows_exist: bool = False
    percent_invalid: float = 0.0


@dataclasses.dataclass
class DayInfo:
    """Candidate replacement day (reference approx/db.h:12-18)."""

    date: Date
    percent_invalid: float = 0.0

    def distance(self, other: Date, weight: float) -> float:
        """weight*days + (1-weight)*percent_invalid (approx/db.cpp:12-16)."""
        return weight * self.date.days_between(other) + (1.0 - weight) * self.percent_invalid


class DataBase:
    """Status DB at ``<base_path>/approximation.db`` (utils/db.cpp:8-14)."""

    def __init__(self, base_path: Path | str):
        self.base_path = Path(base_path)
        self.path = self.base_path / "approximation.db"
        self._conn = sqlite3.connect(self.path)
        self._conn.execute(_DATES_SCHEMA)
        self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----- base status (utils/db.cpp:16-27) -----

    def get_status(self, date: Date | str) -> CloudShadowStatus:
        date = Date.from_string(date) if isinstance(date, str) else date
        row = self._conn.execute(
            "SELECT clouds_computed, shadows_computed, percent_invalid "
            "FROM dates WHERE year=? AND month=? AND day=?;",
            date.sql_params(),
        ).fetchone()
        if row is None:
            return CloudShadowStatus()
        return CloudShadowStatus(bool(row[0]), bool(row[1]), float(row[2] or 0.0))

    # ----- detection side (cloud_shadow_detection/db.cpp:13-85) -----

    def write_detection_result(self, date: Date | str, status) -> None:
        """Upsert a detection Status (cloud_shadow_detection/db.cpp:38-69)."""
        date = Date.from_string(date) if isinstance(date, str) else date
        self._conn.execute(
            _UPSERT_SQL,
            (
                *date.sql_params(),
                int(status.clouds_computed),
                int(status.shadows_computed),
                status.percent_clouds,
                status.percent_shadows,
                status.percent_invalid,
            ),
        )
        self._conn.commit()

    def write_detection_results(self, results: dict) -> None:
        for date, status in results.items():
            self.write_detection_result(date, status)

    def find_downloaded_dates(self) -> list[tuple[Date, bool]]:
        """(date, clouds_computed) rows (cloud_shadow_detection/db.cpp:71-85)."""
        rows = self._conn.execute(
            "SELECT year, month, day, clouds_computed FROM dates"
        ).fetchall()
        return [(Date(r[0], r[1], r[2]), bool(r[3])) for r in rows]

    # ----- approximation side (approx/db.cpp:23-156) -----

    def _ensure_approx_table(self) -> None:
        self._conn.execute(_APPROX_SCHEMA)
        self._conn.commit()

    def write_approx_results(self, date: Date | str, band_name: str, method: ApproxMethod) -> int:
        """Record that a band was approximated; returns the row id
        (approx/db.cpp:39-62 — with the bind-index bug fixed)."""
        self._ensure_approx_table()
        date = Date.from_string(date) if isinstance(date, str) else date
        cur = self._conn.execute(
            "INSERT OR REPLACE INTO approximated_data (band_name, method, year, month, day) "
            "VALUES(?, ?, ?, ?, ?);",
            (band_name, method.value, *date.sql_params()),
        )
        self._conn.commit()
        return int(cur.lastrowid)

    def get_approx_status(self, date: Date | str, method: ApproxMethod) -> dict[str, int]:
        """band_name -> row id for already-approximated bands
        (approx/db.cpp:64-90)."""
        self._ensure_approx_table()
        date = Date.from_string(date) if isinstance(date, str) else date
        rows = self._conn.execute(
            "SELECT id, band_name FROM approximated_data "
            "WHERE method = ? AND year = ? AND month = ? AND day = ?;",
            (method.value, *date.sql_params()),
        ).fetchall()
        return {r[1]: int(r[0]) for r in rows}

    def select_close_images(self, date: Date | str) -> list[DayInfo]:
        """Dates within the same/adjacent calendar month, excluding the date
        itself (approx/db.cpp:92-133 — same year/month OR-filter semantics)."""
        date = Date.from_string(date) if isinstance(date, str) else date
        nxt = date.add_months(1)
        prv = date.add_months(-1)
        rows = self._conn.execute(
            "SELECT year, month, day, percent_invalid FROM dates WHERE "
            "(year = ? OR year = ? OR year = ?) AND "
            "(month = ? OR month = ? OR month = ?) AND NOT "
            "(year = ? AND month = ? AND day = ?) ORDER BY year, month, day",
            (
                date.year, nxt.year, prv.year,
                date.month, nxt.month, prv.month,
                date.year, date.month, date.day,
            ),
        ).fetchall()
        return [
            DayInfo(Date(r[0], r[1], r[2]), float(r[3]) if r[3] is not None else 0.0)
            for r in rows
        ]

    def select_info_about_date(self, date: Date | str) -> DayInfo:
        """percent_invalid of one date (approx/db.cpp:135-156)."""
        date = Date.from_string(date) if isinstance(date, str) else date
        row = self._conn.execute(
            "SELECT percent_invalid FROM dates WHERE year = ? AND month = ? AND day = ?",
            date.sql_params(),
        ).fetchone()
        return DayInfo(date, float(row[0]) if row and row[0] is not None else 0.0)

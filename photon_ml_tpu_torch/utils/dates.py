"""Date-range input expansion.

Rebuild of ``util/DateRange.scala`` + ``util/IOUtils.getInputPathsWithinDateRange``:
training inputs laid out in daily directories (``<base>/yyyy/MM/dd``) are
selected by an inclusive date range, specified either as explicit dates
("20240101-20240131") or as days-ago offsets ("90-1").

A copy of ``photon_ml_tpu/utils/dates.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

_DATE_FMT = "%Y%m%d"


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] date range."""

    start: datetime.date
    end: datetime.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"invalid date range: {self.start} after {self.end}"
            )

    @staticmethod
    def from_dates(spec: str) -> "DateRange":
        """"yyyymmdd-yyyymmdd" (``DateRange.fromDates``)."""
        try:
            lo, hi = spec.split("-")
            return DateRange(
                datetime.datetime.strptime(lo, _DATE_FMT).date(),
                datetime.datetime.strptime(hi, _DATE_FMT).date(),
            )
        except ValueError as e:
            raise ValueError(f"bad date range {spec!r}: {e}") from None

    @staticmethod
    def from_days_ago(spec: str, today: Optional[datetime.date] = None) -> "DateRange":
        """"N-M" days ago, N >= M (``DateRange.fromDaysAgo``)."""
        today = today or datetime.date.today()
        try:
            lo, hi = (int(p) for p in spec.split("-"))
        except ValueError:
            raise ValueError(f"bad days-ago range {spec!r}") from None
        return DateRange(
            today - datetime.timedelta(days=lo),
            today - datetime.timedelta(days=hi),
        )

    def days(self):
        cur = self.start
        while cur <= self.end:
            yield cur
            cur += datetime.timedelta(days=1)


def expand_date_paths(
    base_dirs: Sequence[str],
    date_range: Optional[DateRange],
    require_exists: bool = True,
) -> List[str]:
    """``IOUtils.getInputPathsWithinDateRange``: expand base dirs to their
    existing daily subdirectories within the range. With no range, the base
    dirs pass through unchanged."""
    if date_range is None:
        return list(base_dirs)
    out: List[str] = []
    for base in base_dirs:
        for day in date_range.days():
            p = os.path.join(
                base, f"{day.year:04d}", f"{day.month:02d}", f"{day.day:02d}"
            )
            if not require_exists or os.path.isdir(p):
                out.append(p)
    if require_exists and not out:
        raise FileNotFoundError(
            f"no input paths found in {base_dirs} for "
            f"{date_range.start}..{date_range.end}"
        )
    return out

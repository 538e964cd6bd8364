"""Logging, statistics counters and a progress bar (a copy of the subset of
``mitsuba_tpu/utils/logging.py`` that the command line uses).

The reference's Logger (logger.h: five levels ETrace..EError), its
StatsCounter registry (statistics.h) and its ProgressReporter, as host-side
Python objects.
"""
from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict
from dataclasses import dataclass

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_logger = logging.getLogger("mitsuba_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s mitsuba_tpu_torch: %(message)s",
        "%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def get_logger() -> logging.Logger:
    return _logger


def set_log_level(level) -> None:
    _logger.setLevel(level)


@dataclass
class StatsCounter:
    name: str
    category: str
    value: float = 0.0

    def incr(self, amount: float = 1.0) -> None:
        self.value += amount


class Statistics:
    """Process-wide registry of counters (Statistics::getInstance)."""

    _counters: dict = {}

    @classmethod
    def counter(cls, category: str, name: str) -> StatsCounter:
        key = (category, name)
        if key not in cls._counters:
            cls._counters[key] = StatsCounter(name=name, category=category)
        return cls._counters[key]

    @classmethod
    def print_stats(cls, out=None) -> str:
        """statistics.h printStats: every counter by category."""
        out = out or sys.stderr
        by_cat = defaultdict(list)
        for (cat, _), c in sorted(cls._counters.items()):
            by_cat[cat].append(c)
        lines = ["  * Statistics:"]
        for cat, cs in by_cat.items():
            lines.append(f"    - {cat}:")
            lines.extend(f"        {c.name}: {c.value:.6g}" for c in cs)
        text = "\n".join(lines)
        print(text, file=out)
        return text


class ProgressReporter:
    """Console progress with an ETA (statistics.h ProgressReporter)."""

    def __init__(self, title: str, total: int, quiet: bool = False):
        self.title = title
        self.total = max(total, 1)
        self.t0 = time.time()
        self.quiet = quiet

    def update(self, done: int) -> None:
        if self.quiet:
            return
        frac = done / self.total
        elapsed = time.time() - self.t0
        eta = elapsed / max(frac, 1e-9) * (1 - frac)
        bar = "#" * int(32 * frac)
        sys.stderr.write(f"\r{self.title}: [{bar:<32}] {100 * frac:5.1f}% "
                         f"({elapsed:.1f}s, ETA {eta:.1f}s)")
        if done >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()

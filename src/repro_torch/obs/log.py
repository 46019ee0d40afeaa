"""Structured logging: leveled JSON-lines records.

Every emitted line is one JSON object (``json.loads``-able on its own):

    {"ts": ..., "level": "info", "logger": "serve", "event": "stats",
     "p50_ms": 1.2, ...}

Loggers replace the ad-hoc ``print()`` lines in the launchers and the
training loop, so run output is machine-parseable (and greppable by
``"event": "..."``) without losing anything a human read before. The
default level comes from ``REPRO_LOG_LEVEL`` (debug|info|warning|error,
default info).

A copy of the JAX package's ``obs/log.py`` (which is framework-free), so
that the port imports nothing of that package: the same levels, the same
record keys (``ts``, ``level``, ``logger``, ``event``), the same
``REPRO_LOG_LEVEL``.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}
_DEFAULT_LEVEL = os.environ.get("REPRO_LOG_LEVEL", "info").lower()


def set_level(level: str):
    """Set the level for every logger that has no explicit override."""
    global _DEFAULT_LEVEL
    if level not in _LEVELS:
        raise ValueError(f"unknown level {level!r} (one of {list(_LEVELS)})")
    _DEFAULT_LEVEL = level


class Logger:
    """One named JSON-lines logger. ``stream=None`` -> stdout at emit
    time (so pytest capture and test-injected StringIO both work)."""

    def __init__(self, name: str, level: Optional[str] = None, stream=None):
        self.name = name
        self.level = level
        self.stream = stream

    def _threshold(self) -> int:
        return _LEVELS[self.level if self.level is not None
                       else _DEFAULT_LEVEL]

    def log(self, level: str, event: str, **fields):
        if _LEVELS[level] < self._threshold():
            return
        rec: Dict = {"ts": round(time.time(), 6), "level": level,
                     "logger": self.name, "event": event}
        rec.update(fields)
        out = self.stream if self.stream is not None else sys.stdout
        print(json.dumps(rec, default=str), file=out, flush=True)

    def debug(self, event: str, **fields):
        self.log("debug", event, **fields)

    def info(self, event: str, **fields):
        self.log("info", event, **fields)

    def warning(self, event: str, **fields):
        self.log("warning", event, **fields)

    def error(self, event: str, **fields):
        self.log("error", event, **fields)


_LOGGERS: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    lg = _LOGGERS.get(name)
    if lg is None:
        lg = _LOGGERS[name] = Logger(name)
    return lg

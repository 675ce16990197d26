"""Named hierarchical loggers with per-module levels (port of
``spacemesh_tpu/utils/logging.py``).

Thin stdlib wrapper: ``get(name)`` returns a child of the package's root
logger; ``configure(levels={"health": "DEBUG"})`` sets per-module levels.

Structured mode: ``SPACEMESH_LOG_JSON=1`` (or ``configure(json_lines=
True)``) switches the handler to one JSON object per line carrying the
current span id from the tracer's contextvars (utils/tracing.py). A
health-engine breach line logged inside a ``health.tick`` span then
carries ``"span": <id>``: search that id among the args of a
``/debug/trace/export`` capture in Perfetto and the log line lands on its
exact spot in the timeline.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

ROOT = "spacemesh_tpu_torch"


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}")


class JsonFormatter(logging.Formatter):
    """One JSON object per line; stable keys, span-id correlated."""

    def format(self, record: logging.LogRecord) -> str:
        from . import tracing

        doc = {
            "ts": round(record.created, 6),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%S",
                                 time.gmtime(record.created))
                   + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        span = tracing.current_id()
        if span is not None:
            doc["span"] = span
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, ensure_ascii=False)


def json_mode_enabled() -> bool:
    return os.environ.get("SPACEMESH_LOG_JSON", "").lower() not in (
        "", "0", "off", "false")


def configure(level: str = "INFO", levels: dict[str, str] | None = None,
              stream=None, json_lines: bool | None = None) -> None:
    """``json_lines=None`` defers to ``SPACEMESH_LOG_JSON``; an explicit
    value wins. Re-calling reformats the existing handler, so flipping
    modes mid-process (tests) works."""
    if json_lines is None:
        json_lines = json_mode_enabled()
    root = logging.getLogger(ROOT)
    root.setLevel(level.upper())
    if not root.handlers:
        root.addHandler(logging.StreamHandler(stream or sys.stderr))
    fmt = (JsonFormatter() if json_lines else logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s"))
    for h in root.handlers:
        h.setFormatter(fmt)
    for module, lvl in (levels or {}).items():
        get(module).setLevel(lvl.upper())

"""Minimal structured logging.

Counterpart of ``repro.utils.logging``. Two output modes, chosen by the
``REPRO_LOG_FORMAT`` environment variable when a logger is created:

* default: one human-readable line (``HH:MM:SS L name :: message``);
* ``json``: one strict-JSON object a line (``ts``, ``level``, ``logger``,
  ``msg`` and the process log context), so host logs join against the obs
  run log: :func:`set_log_context` stamps ``run_id`` / ``step`` (the run log
  and the training loop keep them current), and every later record carries
  them.
"""
from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict

_FMT = "%(asctime)s %(levelname).1s %(name)s :: %(message)s"

# process-wide fields merged into every JSON log record (run_id, step, ...)
_LOG_CONTEXT: Dict[str, Any] = {}


def set_log_context(**fields: Any) -> None:
    """Merge fields into the process log context; ``None`` removes a key."""
    for k, v in fields.items():
        if v is None:
            _LOG_CONTEXT.pop(k, None)
        else:
            _LOG_CONTEXT[k] = v


def get_log_context() -> Dict[str, Any]:
    return dict(_LOG_CONTEXT)


class JsonFormatter(logging.Formatter):
    """One strict-JSON object a line, joinable with the obs run log."""

    def format(self, record: logging.LogRecord) -> str:
        obj: Dict[str, Any] = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        obj.update(_LOG_CONTEXT)
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        # default=str: a context value JSON cannot hold must not kill the
        # line; allow_nan=False keeps consumers strict
        return json.dumps(obj, default=str, allow_nan=False)


def _make_formatter() -> logging.Formatter:
    if os.environ.get("REPRO_LOG_FORMAT", "").lower() == "json":
        return JsonFormatter()
    return logging.Formatter(_FMT, datefmt="%H:%M:%S")


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_make_formatter())
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("REPRO_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger

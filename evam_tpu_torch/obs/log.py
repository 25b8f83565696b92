"""Structured logging for evam_tpu_torch.

Counterpart of ``evam_tpu/obs/log.py`` (a copy, under the
``evam_tpu_torch`` logger). Replicates the env-driven logging surface
of the reference EII service
(reference: evas/log.py:35-60, evas/__main__.py:36-46): a global level
set by ``PY_LOG_LEVEL``, a ``DEV_MODE`` flag that switches to
human-readable output, and per-component logger names.
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARN": logging.WARNING,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
}

_FMT_DEV = "%(asctime)s %(levelname)-7s [%(name)s] %(message)s"
_FMT_PROD = (
    '{"ts":"%(asctime)s","level":"%(levelname)s","logger":"%(name)s",'
    '"msg":"%(message)s"}'
)


def configure_logging(level: str | None = None, dev_mode: bool | None = None) -> None:
    """Configure root logging once, from args or env.

    ``PY_LOG_LEVEL`` and ``DEV_MODE`` env vars mirror the reference's
    contract (evas/__main__.py:36-46).
    """
    global _CONFIGURED
    if level is None:
        level = os.environ.get("PY_LOG_LEVEL", "INFO").upper()
    if dev_mode is None:
        dev_mode = os.environ.get("DEV_MODE", "true").lower() == "true"

    root = logging.getLogger("evam_tpu_torch")
    root.setLevel(_LEVELS.get(level, logging.INFO))
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT_DEV if dev_mode else _FMT_PROD))
        root.addHandler(handler)
        root.propagate = False
        _CONFIGURED = True

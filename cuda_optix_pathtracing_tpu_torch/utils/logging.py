"""Structured logging (counterpart of the reference ``utils/logging.py``).

Python logging with the reference's level set (``trace`` below ``debug``,
and ``warn``) and an ANSI console handler. In a ``torch.distributed``
group of more than one rank every record carries the rank as ``[h<rank>]``,
so the ranks' logs interleave legibly. The tag is read when a record is
written, so a logger made before the group joins tags its later records.
"""

from __future__ import annotations

import logging
import sys

TRACE = 5

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_COLORS = {
    TRACE: "\x1b[90m",
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
}

logging.addLevelName(TRACE, "TRACE")


class _AnsiFormatter(logging.Formatter):
    def format(self, record):
        record.rank_tag = rank_tag()
        color = _COLORS.get(record.levelno, "") if sys.stderr.isatty() else ""
        reset = "\x1b[0m" if color else ""
        return f"{color}{super().format(record)}{reset}"


def rank_tag() -> str:
    """``[h<rank>]`` inside an initialised group of more than one rank,
    else empty."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return f"[h{dist.get_rank()}]"
    return ""


def get_logger(name: str = "dtpt", level: str = "info") -> logging.Logger:
    """The logger ``name`` at ``level``; its stderr handler is installed
    once, and tags each record with the rank as it stands when the record
    is written."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            _AnsiFormatter(
                "%(asctime)s %(levelname)-5s %(rank_tag)s%(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(_LEVELS.get(level, logging.INFO))
    return logger

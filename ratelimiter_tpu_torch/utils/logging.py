"""Structured logging (SURVEY.md §5.5 parity).

The reference logs debug/trace throughout via Slf4j with a console
pattern configured in application.properties (lines 9-11: DEBUG for the
app package, a timestamped pattern).  This module is the analog: one
``ratelimiter_tpu_torch`` logger hierarchy, level and pattern set from props
(``logging.level`` / ``logging.pattern``, env-overridable like every
other key).

Call sites use lazy %-formatting so a disabled level costs one enum
compare on the hot path.
"""

from __future__ import annotations

import logging

ROOT = "ratelimiter_tpu_torch"

# The reference's console pattern (application.properties):
# %d{HH:mm:ss} - %msg%n with logger context; rendered in logging idiom.
DEFAULT_PATTERN = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}")


def setup_logging(props=None) -> logging.Logger:
    """Configure the package logger from props; idempotent."""
    level_name = "INFO"
    pattern = DEFAULT_PATTERN
    if props is not None:
        level_name = (props.get("logging.level") or "INFO").upper()
        pattern = props.get("logging.pattern") or DEFAULT_PATTERN
    logger = logging.getLogger(ROOT)
    logger.setLevel(getattr(logging, level_name, logging.INFO))
    if not any(getattr(h, "_ratelimiter", False) for h in logger.handlers):
        handler = logging.StreamHandler()
        handler._ratelimiter = True  # type: ignore[attr-defined]
        logger.addHandler(handler)
    for handler in logger.handlers:
        if getattr(handler, "_ratelimiter", False):
            handler.setFormatter(logging.Formatter(pattern))
    logger.propagate = False
    return logger

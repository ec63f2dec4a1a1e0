"""Log callback plumbing (copy of whisper_tpu.utils.logging; reference:
src/whisper.cpp:977-983, 7518-7551).

`log_set(cb)` mirrors whisper_log_set: all library output funnels through a
single replaceable callback (default: stderr).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

LOG_LEVEL_NONE = 0
LOG_LEVEL_DEBUG = 1
LOG_LEVEL_INFO = 2
LOG_LEVEL_WARN = 3
LOG_LEVEL_ERROR = 4

_callback: Optional[Callable[[int, str], None]] = None
_verbosity: int = LOG_LEVEL_INFO


def log_set(callback: Optional[Callable[[int, str], None]]) -> None:
    global _callback
    _callback = callback


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def _emit(level: int, msg: str) -> None:
    if _callback is not None:
        _callback(level, msg)
    elif level >= _verbosity:
        print(f"whisper_tpu_torch: {msg}", file=sys.stderr)


def log_debug(msg: str) -> None:
    _emit(LOG_LEVEL_DEBUG, msg)


def log_info(msg: str) -> None:
    _emit(LOG_LEVEL_INFO, msg)


def log_warn(msg: str) -> None:
    _emit(LOG_LEVEL_WARN, msg)


def log_error(msg: str) -> None:
    _emit(LOG_LEVEL_ERROR, msg)

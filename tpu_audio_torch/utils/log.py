"""Timestamped, ANSI-colored, leveled logging (port of
tpu_audio/utils/log.py, the same TPU_AUDIO_LOG levels).

Capability equivalent of the reference logger (reference src/log.h:39-43,
src/log.cu:10-67): printf-style ``info/warn/error(id, fmt, *args)`` with a
timestamped, color-styled prefix and ``newline()`` continuation lines.

Differences from the reference (deliberate):
  - no fixed 256-char truncation buffer (reference src/log.cu:14);
  - thread-safe via a module lock (the reference declares Log::lock/unlock
    but never defines them, src/log.h:44-45);
  - level filtering + quiet mode via env ``TPU_AUDIO_LOG`` (0/quiet,
    1/error, 2/warn, 3/info[default], 4/debug) so the real-time host loop
    can silence logging without code changes.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_ESC = "\x1b["
_RESET = "\x1b[0m"

_LEVELS = {"quiet": 0, "error": 1, "warn": 2, "info": 3, "debug": 4}

_CONTINUATION_PAD = 22  # width of the "I YYYY-MM-DD HH:MM:SS " prefix


def _env_level() -> int:
    raw = os.environ.get("TPU_AUDIO_LOG", "info").strip().lower()
    if raw in _LEVELS:
        return _LEVELS[raw]
    try:
        return int(raw)
    except ValueError:
        return _LEVELS["info"]


def _supports_color(stream) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    try:
        return stream.isatty()
    except Exception:
        return False


class Log:
    """Static logging facade. ``Log.info("wav", "IR [%0.2f s] %s", secs, path)``."""

    level: int = _env_level()
    _lock = threading.Lock()
    force_color: bool | None = None  # None = auto-detect per stream

    @classmethod
    def _emit(cls, stream, type_style: str, type_char: str, id_style: str,
              msg_style: str, ident: str, msg: str) -> None:
        color = cls.force_color if cls.force_color is not None else _supports_color(stream)
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        if color:
            line = (f"{_ESC}37;2m{type_style}{type_char}{_RESET} {_ESC}37;2m{ts}{_RESET} "
                    f"{id_style}[{ident}]{_RESET} {msg_style}{msg}{_RESET}\n")
        else:
            line = f"{type_char} {ts} [{ident}] {msg}\n"
        with cls._lock:
            stream.write(line)
            stream.flush()

    @staticmethod
    def _fmt(fmt: str, args: tuple) -> str:
        if not args:
            return str(fmt)
        try:
            return fmt % args
        except (TypeError, ValueError):
            return f"{fmt} {args!r}"

    @classmethod
    def info(cls, ident: str, fmt: str, *args) -> None:
        if cls.level >= _LEVELS["info"]:
            cls._emit(sys.stdout, "", "I", f"{_ESC}37;1m",
                      f"{_ESC}37m", ident, cls._fmt(fmt, args))

    @classmethod
    def warn(cls, ident: str, fmt: str, *args) -> None:
        if cls.level >= _LEVELS["warn"]:
            cls._emit(sys.stderr, f"{_ESC}33m", "W", f"{_ESC}33;1m",
                      f"{_ESC}33m", ident, cls._fmt(fmt, args))

    @classmethod
    def error(cls, ident: str, fmt: str, *args) -> None:
        if cls.level >= _LEVELS["error"]:
            cls._emit(sys.stderr, f"{_ESC}31;1m", "E", f"{_ESC}31;1m",
                      f"{_ESC}31m", ident, cls._fmt(fmt, args))

    @classmethod
    def debug(cls, ident: str, fmt: str, *args) -> None:
        if cls.level >= _LEVELS["debug"]:
            cls._emit(sys.stdout, f"{_ESC}36m", "D", f"{_ESC}36;1m",
                      f"{_ESC}36;2m", ident, cls._fmt(fmt, args))

    @classmethod
    def newline(cls, fmt: str = "", *args) -> None:
        """Continuation line aligned under the message column (src/log.cu:69-90)."""
        if cls.level >= _LEVELS["info"]:
            with cls._lock:
                out = sys.stdout
                out.write(" " * _CONTINUATION_PAD + cls._fmt(fmt, args) + "\n")
                out.flush()

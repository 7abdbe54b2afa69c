"""Settings-file configuration system (port of tpu_audio/io/settings.py).

File-format compatible with the reference (reference src/settings.cu:4-24):
whitespace-separated ``key value`` tokens, ``#`` starts a comment that runs
to end of line, values are single tokens. Typed getters take printf-style
key templates exactly like the reference API (reference src/settings.h:27-36,
e.g. ``settings.u32("conv[%d].fftSize", n)``).

Extensions over the reference:
  - ``save()`` is implemented (the reference's is ``assert(false)``,
    src/settings.cu:26-29);
  - getters accept a ``default=`` keyword; without it a missing key raises
    ``KeyError`` (the reference std::map auto-inserts an empty Setting and
    then throws from std::stoi);
  - ``isTrue``/``isFalse`` keep reference semantics: true iff the value is
    exactly "yes" or "true" (src/settings.h:14-15).
"""

from __future__ import annotations

import os
from typing import Iterator

from tpu_audio_torch.utils.log import Log

_MISSING = object()


class Setting:
    __slots__ = ("key", "value")

    def __init__(self, key: str, value: str):
        self.key = key
        self.value = value

    def is_true(self) -> bool:
        return self.value in ("yes", "true")

    def is_false(self) -> bool:
        return not self.is_true()

    def _int(self) -> int:
        # the reference parses with std::stoi (base 10: zero-padded
        # values like '010' are decimal 10, settings.h:17-19); int(x, 0)
        # would reject them as malformed octal. Explicit 0x/0b/0o
        # prefixes are accepted as an extension.
        v = self.value.strip().lower()
        base = 0 if v.startswith(("0x", "0b", "0o", "-0x", "-0b", "-0o")) \
            else 10
        return int(v, base)

    def u8(self) -> int:
        return self._int() & 0xFF

    def u16(self) -> int:
        return self._int() & 0xFFFF

    def u32(self) -> int:
        return self._int() & 0xFFFFFFFF

    def f32(self) -> float:
        return float(self.value)

    def str(self) -> str:
        return self.value

    def __repr__(self):
        return f"Setting({self.key!r}, {self.value!r})"


class Settings:
    """Ordered key→Setting map with printf-template typed getters."""

    def __init__(self):
        self._map: dict[str, Setting] = {}

    # -- file I/O ------------------------------------------------------------

    def open(self, path: str | os.PathLike, verbose: bool = True) -> "Settings":
        """Parse a settings file (token stream; '#' comments to end of line)."""
        with open(path, "r") as fh:
            text = fh.read()
        self.parse(text, verbose=verbose)
        return self

    def parse(self, text: str, verbose: bool = False) -> "Settings":
        # Token-stream semantics matching the reference's `is >> key >> value`
        # loop with '#'-prefixed-token comment skipping (src/settings.cu:8-22).
        i, n = 0, len(text)
        tokens: list[str] = []
        while i < n:
            while i < n and text[i].isspace():
                i += 1
            if i >= n:
                break
            if text[i] == "#":
                while i < n and text[i] != "\n":
                    i += 1
                continue
            j = i
            while j < n and not text[j].isspace():
                j += 1
            tokens.append(text[i:j])
            i = j
        if len(tokens) % 2 != 0:
            Log.warn("settings", "odd token count; last key '%s' has no value",
                     tokens[-1])
            tokens = tokens[:-1]
        for k in range(0, len(tokens), 2):
            key, value = tokens[k], tokens[k + 1]
            self._map[key] = Setting(key, value)
            if verbose:
                Log.info("settings", "%-24s %s", key, value)
        return self

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "w") as fh:
            fh.write("# tpu-audio settings\n")
            for key, s in self._map.items():
                fh.write(f"{key}\t{s.value}\n")

    # -- dict-like -------------------------------------------------------------

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def __getitem__(self, key: str) -> Setting:
        return self._map[key]

    def __setitem__(self, key: str, value) -> None:
        self._map[key] = value if isinstance(value, Setting) else Setting(key, str(value))

    def __len__(self) -> int:
        return len(self._map)

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def keys(self):
        return self._map.keys()

    def items(self):
        return self._map.items()

    # -- typed printf-template getters ----------------------------------------

    def _resolve(self, fmt: str, args: tuple):
        key = (fmt % args) if args else fmt
        setting = self._map.get(key)
        if setting is None:
            return key, None
        return key, setting

    def _typed(self, conv: str, fmt: str, args: tuple, default):
        key, setting = self._resolve(fmt, args)
        if setting is None:
            if default is not _MISSING:
                return default
            Log.error("settings", "missing key %s", key)
            raise KeyError(key)
        try:
            return getattr(setting, conv)()
        except ValueError:
            Log.error("settings", "bad value for key %s: %r", key, setting.value)
            raise

    def is_true(self, fmt: str, *args, default=_MISSING) -> bool:
        return self._typed("is_true", fmt, args, default)

    def is_false(self, fmt: str, *args, default=_MISSING) -> bool:
        return self._typed("is_false", fmt, args, default)

    def u8(self, fmt: str, *args, default=_MISSING) -> int:
        return self._typed("u8", fmt, args, default)

    def u16(self, fmt: str, *args, default=_MISSING) -> int:
        return self._typed("u16", fmt, args, default)

    def u32(self, fmt: str, *args, default=_MISSING) -> int:
        return self._typed("u32", fmt, args, default)

    def f32(self, fmt: str, *args, default=_MISSING) -> float:
        return self._typed("f32", fmt, args, default)

    def str(self, fmt: str, *args, default=_MISSING) -> str:
        return self._typed("str", fmt, args, default)

"""IR bank index files (port of tpu_audio/io/index.py).

Capability equivalent of the reference's `.index` playlists (reference
ir/*.index, loaded one path per line at src/main.cu:72-81) and the
`scripts/makeindex.sh` generator (find every .wav under a directory).

Paths in an index are resolved first relative to the current working
directory (the reference's behaviour) and then relative to the index file's
own directory, so banks are relocatable.
"""

from __future__ import annotations

import os

from tpu_audio_torch.utils.log import Log


def load_index(path: str | os.PathLike, must_exist: bool = True,
               root: str | os.PathLike | None = None) -> list[str]:
    """Read an index file into an ordered list of WAV paths.

    Each entry is resolved against, in order: ``root`` (if given), the
    current working directory, the index file's directory, and the index
    file's parent directory (reference indices live in ir/ but list paths
    like ``ir/1/x.wav`` relative to the repo root).
    """
    path = os.fspath(path)
    base = os.path.dirname(os.path.abspath(path))
    bases = ([os.fspath(root)] if root is not None else []) + \
        ["", base, os.path.dirname(base)]
    out: list[str] = []
    with open(path, "r") as fh:
        for line in fh:
            entry = line.strip()
            if not entry or entry.startswith("#"):
                continue
            resolved = next(
                (os.path.join(b, entry) if b else entry
                 for b in bases if os.path.exists(os.path.join(b, entry))),
                None,
            )
            if resolved is None:
                if must_exist:
                    # raising preserves bank numbering: silently skipping
                    # would shift every later index, so settings select
                    # values (and MIDI CC scalings) address the WRONG IRs
                    # (the reference also dies here: wav.cu asserts)
                    raise FileNotFoundError(
                        f"index {path}: missing IR file {entry!r} "
                        f"(searched {[b or '.' for b in bases]}); pass "
                        f"must_exist=False to keep the raw entry")
                resolved = entry
            out.append(resolved)
    return out


def make_index(root: str | os.PathLike) -> list[str]:
    """Recursively list .wav files under root, sorted for determinism.

    (The reference's makeindex.sh uses unsorted `find` output,
    scripts/makeindex.sh:3; sorting keeps bank indices stable across
    filesystems.)
    """
    root = os.fspath(root)
    found: list[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name.lower().endswith(".wav"):
                found.append(os.path.join(dirpath, name))
    return sorted(found)


def write_index(path: str | os.PathLike, entries: list[str]) -> None:
    with open(path, "w") as fh:
        for e in entries:
            fh.write(e + "\n")

"""Content-addressed raw-.npy disk cache for derived bank tensors (port of
tpu_audio/utils/diskcache.py, the same file naming, so either package reads
the other's entries).

One cache entry = ``{base}_{field}.npy`` per tensor plus a ``{base}.ok``
manifest (written LAST) naming the fields that exist — multi-tensor
entries stay atomic without zip framing. Raw .npy + mmap is deliberate:
``np.savez``'s zipfile layer reads multi-GB entries at single-digit MB/s
(CRC + small-chunk copies), while ``np.load(mmap_mode='r')`` hands the
consumer pages straight from the file cache.

``save_array`` is the atomic single-file write both the entries here and
``IRBank.cached_partitioned_spectra`` (engine/bank.py, which keeps its own
``bank_<key>.npy`` naming) go through.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np


def content_key(kind: str, geometry: tuple, *arrays) -> str:
    """sha256 over ``repr((kind,) + geometry)`` + the raw array bytes,
    truncated to 24 hex chars (the JAX package's keys)."""
    h = hashlib.sha256()
    h.update(repr((kind,) + tuple(geometry)).encode())
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:24]


def save_array(path: str, arr: np.ndarray) -> None:
    """np.save to `path` through a pid-unique tmp file and ``os.replace``:
    two processes missing the same key (an app and the tools sharing a
    cache dir) never interleave writes into one file, and a crash mid-save
    leaves no torn file under the final name."""
    tmp = f"{path.removesuffix('.npy')}.tmp{os.getpid()}.npy"
    np.save(tmp, arr)   # (np.save would append .npy to a name without it)
    os.replace(tmp, path)


def load(cache_dir, base: str, fields) -> dict | None:
    """mmap-load an entry's tensors; ``None`` on miss.

    Returns ``{field: array-or-None}`` for every requested field (a field
    the manifest omits was ``None`` at store time). Entries written
    before the manifest existed are accepted when EVERY requested field's
    file is present."""
    root = os.path.join(os.fspath(cache_dir), base)
    names = None
    if os.path.exists(root + ".ok"):
        with open(root + ".ok") as fh:
            names = [ln.strip() for ln in fh if ln.strip()]
    elif all(os.path.exists(f"{root}_{f}.npy") for f in fields):
        names = list(fields)
    if names is None:
        return None
    out = {f: None for f in fields}
    for f in names:
        p = f"{root}_{f}.npy"
        if not os.path.exists(p):          # torn entry: treat as a miss
            return None
        out[f] = np.load(p, mmap_mode="r")
    return out


def store(cache_dir, base: str, arrays: dict) -> None:
    """Write an entry: each tensor via save_array, then the ``.ok``
    manifest last (a crash mid-store leaves a miss, never a torn hit).
    ``None``-valued fields are recorded absent."""
    os.makedirs(cache_dir, exist_ok=True)
    root = os.path.join(os.fspath(cache_dir), base)
    present = []
    for f, a in arrays.items():
        if a is None:
            continue
        save_array(f"{root}_{f}.npy", a)
        present.append(f)
    tmp = f"{root}.ok.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write("\n".join(present) + "\n")
    os.replace(tmp, root + ".ok")

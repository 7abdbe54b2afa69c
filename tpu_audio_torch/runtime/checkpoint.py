"""Checkpoint/resume: engine state and control plane in one file (port of
tpu_audio/runtime/checkpoint.py).

The reference has none of this (its Settings::save is ``assert(false)``,
reference src/settings.cu:26-29). A checkpoint captures everything needed
to resume a live session bit-exactly: the engine state (delay lines, wet
rings, crossfade state, the cascade's host block counter), the control
plane (every live parameter, countdown and speed, and the auxiliary
runtime state in ``control.aux``, such as the working set's residency
map), and geometry to validate compatibility on load. Banks are not
stored: they are rebuilt from the IRs.

The file is an uncompressed ``.npz`` written to ``<path>.tmp.<pid>`` and
renamed onto `path` (a crash mid-save never truncates the previous good
checkpoint, and the name is never changed to ``.npz``). Entries:

  - ``state.<field>``: one per dataclass field of the state, keyed by NAME,
    so adding a field to a state class makes old checkpoints fail to load
    with a message that names it instead of silently shifting every later
    leaf. A bfloat16 field (ring mode's ``base``) is stored as its int16
    view and comes back bit for bit; a Python int field (``CascadeState.
    step``) as an int64 scalar;
  - ``cp_<name>``: the control-plane fields (select, predelay, vsteps,
    speed, dry, wet, pan_dry, pan_wet, level), and ``aux_<name>`` for each
    entry of ``control.aux``, as the JAX package stores them;
  - ``header``: JSON with the state class, each field's dtype and shape in
    field order, num_voices, bank_size, max_predelay, aux_keys and meta.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import fields, replace

import numpy as np
import torch

from tpu_audio_torch.engine.params import ControlPlane

_CP_FIELDS = ("select", "predelay", "vsteps", "speed", "dry", "wet",
              "pan_dry", "pan_wet", "level")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(value) -> tuple[np.ndarray, str]:
    """One state field on the host (a synchronous copy from the device)
    and the dtype name the header records."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        name = _dtype_name(value.dtype)
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        return value.cpu().numpy(), name
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        return np.asarray(value, np.int64), "int"
    raise TypeError(f"cannot checkpoint a {type(value).__name__} field")


def save_checkpoint(path: str | os.PathLike, state, control: ControlPlane,
                    meta: dict | None = None) -> dict:
    """Serialise engine state + control plane to one file. The state is
    copied to the host before this returns (the steps update delay lines
    and wet rings in place, so the copy must finish before the next step is
    queued). A mesh's ShardedState (parallel/mesh.py) is gathered first,
    so the file holds the single-device format and loads into a session on
    one device or on a mesh (which places it at run start). Returns the
    save's figures: seconds of the device-to-host copy, the gather
    included (``d2h_s``), and of the file write (``write_s``), and
    ``bytes``."""
    t0 = time.perf_counter()
    if hasattr(state, "gather"):
        state = state.gather()
    arrays: dict[str, np.ndarray] = {}
    specs = []
    for f in fields(state):
        host, dtype = _to_host(getattr(state, f.name))
        arrays[f"state.{f.name}"] = host
        specs.append({"name": f.name, "dtype": dtype,
                      "shape": list(host.shape)})
    t1 = time.perf_counter()
    for name in _CP_FIELDS:
        arrays[f"cp_{name}"] = getattr(control, name)
    # auxiliary runtime state registered on the control plane (e.g. the
    # working set's slot -> IR residency map, without which a restored
    # `select` would point at a slot holding a DIFFERENT IR)
    for name, value in control.aux.items():
        arrays[f"aux_{name}"] = np.asarray(value)
    header = {
        "state_class": type(state).__name__,
        "fields": specs,
        "num_voices": control.num_voices,
        "bank_size": control.bank_size,
        "max_predelay": control.max_predelay,
        "aux_keys": sorted(control.aux),
        "meta": meta or {},
    }
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    # writing through a file object stops np.savez appending '.npz'
    tmp = f"{os.fspath(path)}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return {"d2h_s": t1 - t0, "write_s": time.perf_counter() - t1,
            "bytes": sum(a.nbytes for a in arrays.values())}


def load_checkpoint(path: str | os.PathLike, state_template,
                    control: ControlPlane):
    """Restore (state, meta) from a checkpoint into `control`.

    state_template: a state of the engine that will resume (e.g.
    engine.init_state()); it gives the class, the fields, their shapes,
    dtypes and device. Raises ValueError naming the mismatch when the
    checkpoint holds another state class, another voice count, a missing
    or extra field, or a field of another shape or dtype. Fires
    ``control.on_aux_restored`` after a load that carries aux."""
    cls = type(state_template).__name__
    with np.load(path) as data:
        header = json.loads(bytes(data["header"]).decode())
        if header["state_class"] != cls:
            raise ValueError(f"checkpoint holds a {header['state_class']}, "
                             f"the engine's state is a {cls}")
        if header["num_voices"] != control.num_voices:
            raise ValueError(
                f"checkpoint is for {header['num_voices']} voices, "
                f"control plane has {control.num_voices}")
        saved = {spec["name"]: spec for spec in header["fields"]}
        want = [f.name for f in fields(state_template)]
        missing = [name for name in want if name not in saved]
        if missing:
            raise ValueError(f"checkpoint lacks {cls} field(s) "
                             f"{', '.join(missing)}")
        extra = [name for name in saved if name not in want]
        if extra:
            raise ValueError(f"checkpoint has field(s) {', '.join(extra)} "
                             f"that {cls} does not")
        restored = {}
        for name in want:
            leaf = getattr(state_template, name)
            spec = saved[name]
            arr = data[f"state.{name}"]
            if not isinstance(leaf, torch.Tensor):
                restored[name] = int(arr)
                continue
            dtype = _dtype_name(leaf.dtype)
            if tuple(spec["shape"]) != tuple(leaf.shape):
                raise ValueError(
                    f"state field {name}: checkpoint shape "
                    f"{tuple(spec['shape'])} != engine shape "
                    f"{tuple(leaf.shape)}")
            if spec["dtype"] != dtype:
                raise ValueError(f"state field {name}: checkpoint dtype "
                                 f"{spec['dtype']} != engine dtype {dtype}")
            host = torch.from_numpy(arr)
            if leaf.dtype == torch.bfloat16:
                host = host.view(torch.bfloat16)
            restored[name] = host.to(leaf.device)
        if "step" in restored and "t" in restored:
            # the cascade's host block counter must agree with the device's
            t = int(restored["t"])
            if restored["step"] != t:
                raise ValueError(f"checkpoint's host block counter step="
                                 f"{restored['step']} disagrees with the "
                                 f"device counter t={t}")
        state = replace(state_template, **restored)
        for name in _CP_FIELDS:
            getattr(control, name)[...] = data[f"cp_{name}"]
        for name in header["aux_keys"]:
            control.aux[name] = data[f"aux_{name}"]
        if header["aux_keys"] and control.on_aux_restored is not None:
            control.on_aux_restored()
        return state, header["meta"]

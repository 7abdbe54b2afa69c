"""Device mesh: voice and IR-partition sharding over CUDA devices (port of
tpu_audio/parallel/mesh.py).

The JAX package shards with GSPMD: every leaf carries a PartitionSpec over a
('voice', 'part') mesh and XLA places the collectives. PyTorch has no
GSPMD, so the port runs a SINGLE CONTROLLER, which is what shard_map and
GSPMD amount to on one host: one process holds a [voice, part] grid of
``torch.device`` (``Mesh``), every shard holds contiguous tensors of its
own on its own device, and one host loop enqueues every shard's work.

  - ``voice``: data parallelism over concurrent voices. A voice row runs a
    LOCAL engine with num_voices / voice voices, cloned with the engine's
    own ``with_voices`` (which carries every behaviour knob: mode,
    strategy, MAC dtype, predelay side, fade snapshot), on the row's
    device. Voices are independent: this axis needs no communication.
  - ``part``: sequence parallelism over the IR partition axis (fmajor roll
    mode, the partitioned engine). The delay line, the fade snapshot and
    the partition-sized bank leaves split over partitions; each step runs
    in two stages (the engines' ``mac_stage`` / ``finish_stage`` seam):
    every part shard shifts its slice of the line and sums its partitions'
    MAC products, then the row's part-0 shard adds the partial sums and
    runs the rest. The two exchanges XLA inserts from the shardings are
    explicit peer copies here (``tensor.to(device, non_blocking=True)``,
    stream-ordered on both devices): the roll's boundary column, from part
    shard p-1 (taken before its own shift) to part shard p, and the
    partial sums onto part 0. ``Mesh.exchanges`` counts them.

Leaves sized per voice only (coefficients, span provenance, input and wet
rings, the block counter) live on the part-0 shard of their voice row;
the other part shards hold None there. Rare per-partition operations
(collapse, materialize_base, regather_selection) run on every part shard
with those leaves copied over; collapse_pure is [V, 2, K]-sized and runs on
part 0.

A device may repeat in the mesh (virtual shards: the counterpart of the
JAX tests' eight virtual CPU devices): every shard still holds its own
tensors, the bank is replicated once per distinct device (per partition
slice), and one card then checks the mesh's arithmetic and plumbing, not
its scaling. Ring-mode fmajor and the cascade shard voices only, as in the
JAX package (their doubled-rhs window straddles partition shards).

``donate`` has no meaning in eager PyTorch, and the factories take none:
the steps update the line and rings of the shards passed in IN PLACE, as
the engines' own steps do, so a sharded state passed to a step is
consumed.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from tpu_audio_torch.engine.cascade import (
    CascadeBank, CascadeConvolution, CascadeState,
)
from tpu_audio_torch.engine.fmajor import (
    FMajorBank, FMajorPartitionedConvolution, FMajorState,
)
from tpu_audio_torch.engine.params import VoiceParams
from tpu_audio_torch.engine.partitioned import (
    PartitionedConvolution, PartitionedState,
)
from tpu_audio_torch.ops import mac_shift as _mac_shift
from tpu_audio_torch.utils.log import Log


class Mesh:
    """A [voice, part] grid of torch devices; a device may repeat (virtual
    shards). ``shape`` is {"voice": n, "part": m}, like JAX's mesh.shape;
    ``exchanges`` counts the part-axis copies the steps made."""

    def __init__(self, devices):
        rows = [[_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("mesh devices must be a non-empty [voice, "
                             "part] grid")
        types = sorted({d.type for row in rows for d in row})
        if len(types) > 1:
            raise ValueError(f"mesh devices mix device types {types}")
        self.devices = rows
        self.shape = {"voice": len(rows), "part": len(rows[0])}
        self.exchanges = 0

    @property
    def distinct(self) -> list[torch.device]:
        """The mesh's distinct devices, in order of first appearance."""
        out = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self):
        return (f"Mesh(voice={self.shape['voice']}, part={self.shape['part']}"
                f", {len(self.distinct)} distinct device(s): "
                f"{', '.join(map(str, self.distinct))})")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, part: int | None = None,
              devices=None) -> Mesh:
    """Build a ('voice', 'part') mesh over the first n devices (default:
    every CUDA device). `devices` may repeat one device, e.g. ``["cuda:0"]
    * 2`` or ``["cpu"] * 8`` (virtual shards). `part` defaults to 1 (pure
    voice data parallelism); part > 1 shards the IR partition axis."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device visible: pass devices=[...] "
                               "(e.g. ['cpu'] * 8 for virtual shards on the "
                               "CPU)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    part = part or 1
    if n % part:
        raise ValueError(f"part axis {part} does not divide {n} devices")
    voice = n // part
    mesh = Mesh([devices[r * part:(r + 1) * part] for r in range(voice)])
    Log.info("mesh", "%d shard(s): voice=%d x part=%d on %d %s device(s)",
             n, voice, part, len(mesh.distinct), devices[0].type)
    return mesh


# -- layouts ------------------------------------------------------------------------

@dataclass(frozen=True)
class Layout:
    """How an engine's state (or bank) class splits over a mesh: ``voice``
    maps each field to its voice axis (None: the same on every voice row,
    e.g. the block counter, or a size-1 placeholder), ``part`` maps the
    fields split over partitions to their partition axis. ``cls`` None
    means the object is a single tensor (the partitioned engine's bank),
    split as the field ``""``."""

    cls: type | None
    voice: dict
    part: dict

    def names(self):
        return [""] if self.cls is None else [f.name for f in fields(self.cls)]


def state_layout(engine, mesh: Mesh) -> Layout:
    """The state Layout of `engine` (fmajor, cascade or partitioned) over
    `mesh` (the JAX package's state PartitionSpecs)."""
    split = mesh.shape["part"] > 1
    if isinstance(engine, FMajorPartitionedConvolution):
        snap = 1 if engine.swap_snapshot else None   # [1]*6 placeholder
        selected = engine.mac_strategy == "selected"
        part = {}
        if split:
            part = {"fdl": 3}
            if engine.swap_snapshot:
                part["base"] = 5
            if selected:
                part["sel_spectra"] = 5
        return Layout(FMajorState, dict(
            fdl=1, prev_in=0, wet_ring=0, base=snap, coef_a=0, coef_c=0,
            wptr=None, sel_spectra=1, base_g=0, base_pure=0), part)
    if isinstance(engine, CascadeConvolution):
        return cascade_layout(engine.mac_strategy == "selected")
    if isinstance(engine, PartitionedConvolution):
        part = {}
        if split:
            part = {"fdl": 2,
                    "base" if engine.variant == "coef" else "active": 3}
        return Layout(PartitionedState, dict(
            fdl=0, prev_in=0, wet_ring=0, base=0, coef_a=0, coef_c=0,
            active=0), part)
    raise TypeError(f"no mesh layout for {type(engine).__name__}")


def cascade_layout(selected: bool = False) -> Layout:
    """CascadeState over the voice axis: [M, Vg, ...] leaves split Vg
    (axis 1), [M, F2, 2*Vg, ...] leaves their row axis (axis 2); a
    contiguous split of either is a contiguous voice split that keeps each
    voice's stagger group (voice v sits at group v % M, and every shard's
    voice count is a multiple of M). The 'selected' per-voice leaves are
    size-1 placeholders under 'allk'."""
    head, tail = (1, 2) if selected else (None, None)
    return Layout(CascadeState, dict(
        t=None, step=None, fdl1=1, prev_in=0, inbuf2=1, fdl2=2, wet_ring=0,
        tail_ring=1, coef_a=0, coef_c=0, base_g=0, base_pure=0,
        sel_head=head, sel_tail=tail, base_head=head, base_tail=tail,
        pd_q=0, pd_m=0), {})


def bank_layout(engine, mesh: Mesh) -> Layout:
    """Banks replicate over voices; roll mode's mac_rhs ('allk') and
    planar spectra, and the partitioned engine's [K, 2, P, F] spectra,
    split over partitions."""
    split = mesh.shape["part"] > 1
    if isinstance(engine, FMajorPartitionedConvolution):
        part = {}
        if split:
            part = {"spectra": 2}
            if engine.mac_strategy == "allk":
                part["mac_rhs"] = 2
        return Layout(FMajorBank, {}, part)
    if isinstance(engine, CascadeConvolution):
        return Layout(CascadeBank, {}, {})
    if isinstance(engine, PartitionedConvolution):
        return Layout(None, {}, {"": 2} if split else {})
    raise TypeError(f"no mesh layout for {type(engine).__name__}")


def _narrow(t: torch.Tensor, axis, n: int, i: int) -> torch.Tensor:
    if axis is None or n == 1:
        return t
    size = t.shape[axis] // n
    return t.narrow(axis, i * size, size)


def _copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of `t` on `device` (always a copy)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _get(obj, name):
    return obj if name == "" else getattr(obj, name)


def _build(layout: Layout, leaves: dict):
    return leaves[""] if layout.cls is None else layout.cls(**leaves)


class ShardedState:
    """An engine state over a mesh: ``shards[r][p]`` is an instance of the
    engine's state class holding voice row r's voices and, for the leaves
    the layout splits over partitions, part shard p's partitions, on
    ``mesh.devices[r][p]``. Leaves without a partition axis live on the
    row's part-0 shard only (None on the others).

    ``gather()`` joins the shards into the exact single-device state, and
    ``leaf(name)`` joins one field (a copy: writing into it changes no
    shard)."""

    def __init__(self, mesh: Mesh, layout: Layout, shards):
        self.mesh, self.layout, self.shards = mesh, layout, shards

    @classmethod
    def place(cls, state, mesh: Mesh, layout: Layout) -> "ShardedState":
        """Split a single-device state (a fresh init or a restored
        checkpoint) over the mesh: every shard a copy of its slice."""
        vn, pn = mesh.shape["voice"], mesh.shape["part"]
        shards = []
        for r in range(vn):
            row = []
            for p in range(pn):
                dev = mesh.devices[r][p]
                leaves = {}
                for name in layout.names():
                    value = getattr(state, name)
                    if p > 0 and name not in layout.part:
                        leaves[name] = None
                    elif isinstance(value, torch.Tensor):
                        piece = _narrow(value, layout.voice.get(name), vn, r)
                        piece = _narrow(piece, layout.part.get(name), pn, p)
                        leaves[name] = _copy(piece, dev)
                    else:
                        leaves[name] = value     # the cascade's host counter
                row.append(layout.cls(**leaves))
            shards.append(row)
        return cls(mesh, layout, shards)

    def leaf(self, name: str, device=None):
        """One field joined over the mesh, on `device` (default the mesh's
        first), as a new tensor."""
        dev = self.mesh.devices[0][0] if device is None else device
        v_axis = self.layout.voice.get(name)
        p_axis = self.layout.part.get(name)

        def joined(row):
            if p_axis is None:
                return getattr(row[0], name)
            return torch.cat([getattr(s, name).to(dev) for s in row],
                             dim=p_axis)

        if v_axis is None:      # the same on every voice row: row 0's
            value = joined(self.shards[0])
            return (value.to(dev).clone() if isinstance(value, torch.Tensor)
                    else value)
        return torch.cat([joined(row).to(dev) for row in self.shards],
                         dim=v_axis)

    def gather(self, device=None):
        """The single-device state (the exact layout of the engine's own
        state) on `device`, default the mesh's first."""
        return self.layout.cls(**{name: self.leaf(name, device)
                                  for name in self.layout.names()})

    def with_leaves(self, **full) -> "ShardedState":
        """A copy with some fields replaced by full-size (single-device)
        tensors, split as place() splits them."""
        vn, pn = self.mesh.shape["voice"], self.mesh.shape["part"]
        shards = []
        for r, row in enumerate(self.shards):
            new = []
            for p, s in enumerate(row):
                ups = {}
                for name, value in full.items():
                    if p > 0 and name not in self.layout.part:
                        continue
                    piece = _narrow(value, self.layout.voice.get(name), vn, r)
                    piece = _narrow(piece, self.layout.part.get(name), pn, p)
                    ups[name] = _copy(piece, self.mesh.devices[r][p])
                new.append(replace(s, **ups))
            shards.append(new)
        return ShardedState(self.mesh, self.layout, shards)


class ShardedBank:
    """A bank over a mesh: ``shards[r][p]`` is the bank (the engine's bank
    class, or the partitioned engine's tensor) of part shard p on
    ``mesh.devices[r][p]``, whole or, for the layout's partition leaves, p's
    slice. One replica per distinct (device, partition slice): virtual
    shards share it, and a replica on the bank's own device reuses the
    bank's tensors where it is not split (so a slot write through this
    object reaches the original bank too)."""

    def __init__(self, mesh: Mesh, layout: Layout, shards):
        self.mesh, self.layout, self.shards = mesh, layout, shards

    @classmethod
    def place(cls, bank, mesh: Mesh, layout: Layout) -> "ShardedBank":
        pn = mesh.shape["part"]
        replicas = {}
        shards = []
        for row in mesh.devices:
            out = []
            for p, dev in enumerate(row):
                if (dev, p) not in replicas:
                    leaves = {}
                    for name in layout.names():
                        value = _get(bank, name)
                        axis = layout.part.get(name)
                        if axis is None and value.device == dev:
                            leaves[name] = value
                        else:
                            leaves[name] = _copy(_narrow(value, axis, pn, p),
                                                 dev)
                    replicas[(dev, p)] = _build(layout, leaves)
                out.append(replicas[(dev, p)])
            shards.append(out)
        return cls(mesh, layout, shards)

    def replicas(self):
        """[(device, bank)] once per distinct replica."""
        seen, out = set(), []
        for row in self.shards:
            for b in row:
                if id(b) not in seen:
                    seen.add(id(b))
                    out.append((_get(b, self.layout.names()[0]).device, b))
        return out

    def gather(self, device=None):
        """The single-device bank on `device` (default the mesh's first)."""
        dev = self.mesh.devices[0][0] if device is None else device
        row = self.shards[0]
        leaves = {}
        for name in self.layout.names():
            axis = self.layout.part.get(name)
            if axis is None:
                leaves[name] = _get(row[0], name).to(dev)
            else:
                leaves[name] = torch.cat([_get(b, name).to(dev) for b in row],
                                         dim=axis)
        return _build(self.layout, leaves)

    def write_slot(self, engine, slot: int, packed):
        """Write one packed IR slot (engine.pack_bank_slot's BankSlot or
        CascadeSlot, built on the engine's device) into every replica, each
        on its own device's current stream: the replica on the packing
        device takes the packed tensors, another device a copy made after
        the packing stream's event. Working sets serve ring-mode fmajor and
        the cascade, whose banks no mesh splits over partitions. Returns
        self (the working set's update contract, runtime/working_set.py)."""
        if self.layout.part:
            raise ValueError("slot writes reach whole-bank replicas only: "
                             "this bank is split over the part axis")
        src = engine.device
        waited = False
        for dev, bank in self.replicas():
            local = packed
            if dev != src:
                if packed.done is not None and not waited:
                    torch.cuda.current_stream(src).wait_event(packed.done)
                    waited = True
                local = replace(packed, done=None, **{
                    f.name: _copy(getattr(packed, f.name), dev)
                    for f in fields(packed)
                    if f.name not in ("host", "done")
                    and getattr(packed, f.name) is not None})
            engine.write_bank_slot(bank, slot, local, device=dev)
        return self


class VoiceShards(list):
    """A sharded step's output: one [V / voice, 2, B] tensor per voice row,
    row r's on mesh.devices[r][0]."""

    def gather(self, device=None) -> torch.Tensor:
        dev = self[0].device if device is None else device
        return torch.cat([t.to(dev) for t in self], dim=0)


def _rows(arr, v0: int, v1: int, device: torch.device):
    """Rows [v0, v1) of a per-voice tensor or array on `device` (a view
    where it already lies there)."""
    if isinstance(arr, torch.Tensor):
        return arr[v0:v1].to(device, non_blocking=True)
    return torch.tensor(np.asarray(arr)[v0:v1], device=device)


# -- validation ---------------------------------------------------------------------

def validate(engine, mesh: Mesh) -> None:
    """Raise, with the JAX package's words, on a mesh the engine cannot be
    sharded over; the kernels' per-shard shape rules are checked here too,
    so a bad mesh fails when it is built, not mid-stream."""
    voice_n, part_n = mesh.shape["voice"], mesh.shape["part"]
    if isinstance(engine, CascadeConvolution):
        if part_n > 1:
            raise ValueError(
                "the cascade engine shards voices only (both stages use the "
                "windowed doubled-rhs ring MAC, whose dynamic window "
                "straddles partition shards — same restriction as fmajor "
                "ring mode); use part=1, or fmajor roll mode for sequence "
                "sharding")
        local_v = engine.num_voices // voice_n
        if engine.num_voices % voice_n or local_v % engine.ratio:
            raise ValueError(
                f"{engine.num_voices} voices over a voice={voice_n} mesh "
                f"leaves {local_v} per shard, which must be a positive "
                f"multiple of the stagger ratio {engine.ratio}")
        return
    if engine.num_voices % voice_n:
        raise ValueError(f"{engine.num_voices} voices not divisible by "
                         f"voice axis {voice_n}")
    if isinstance(engine, PartitionedConvolution):
        if engine.partitions % part_n:
            raise ValueError(f"{engine.partitions} partitions not divisible "
                             f"by part axis {part_n}")
        return
    if not isinstance(engine, FMajorPartitionedConvolution):
        raise TypeError(f"no mesh sharding for {type(engine).__name__}")
    if part_n > 1 and engine.ring_mode:
        raise ValueError(
            "ring-mode fmajor cannot shard partitions (dynamic window "
            "straddles shards); build the engine with ring=False for a "
            "part-sharded mesh, or use part=1")
    if engine.pp % part_n:
        raise ValueError(f"padded partition axis {engine.pp} not divisible "
                         f"by part axis {part_n}")
    local_pp = engine.pp // part_n
    _, multiple = _mac_shift.ENTRIES[engine.mac_dtype]
    if part_n > 1 and engine.mac_strategy == "allk" and local_pp % multiple:
        raise ValueError(
            f"a part shard's padded partition axis {local_pp} (= {engine.pp}"
            f" / part axis {part_n}) breaks the mac_shift kernel's rule: "
            f"its Pp must be a multiple of {multiple} in "
            f"{engine.mac_dtype_name}")


# -- the sharded engine -------------------------------------------------------------

class ShardedEngine:
    """An engine's steps and rare-path operations over a mesh, with the
    engine's own signatures on ShardedState / ShardedBank (params and the
    input block may lie on any device: each voice row takes its rows).
    Steps return (ShardedState, VoiceShards). Attributes the session reads
    (num_voices, block, fade_protocol, swap_snapshot, ...) are the
    engine's; ``device`` is the mesh's first."""

    def __init__(self, engine, mesh: Mesh):
        validate(engine, mesh)
        self.engine, self.mesh = engine, mesh
        self.device = mesh.devices[0][0]
        self.local_voices = engine.num_voices // mesh.shape["voice"]
        clones = {}

        def local(dev):
            if dev not in clones:
                clones[dev] = (engine if (dev == engine.device
                                          and self.local_voices
                                          == engine.num_voices)
                               else engine.with_voices(self.local_voices,
                                                       device=dev))
            return clones[dev]

        self.locals = [[local(d) for d in row] for row in mesh.devices]
        # the mesh has not run over real cards: its local engines keep the
        # eager steady step (no CUDA graph)
        for eng in clones.values():
            if isinstance(eng, FMajorPartitionedConvolution):
                eng.steady_graphs = False
        self.state_layout = state_layout(engine, mesh)
        self.bank_layout = bank_layout(engine, mesh)
        # leaves the part shards do not hold; the small ones are copied
        # over for the per-partition rare path
        self._row_only = [n for n in self.state_layout.names()
                          if n not in self.state_layout.part]
        self._hydrate = [n for n in self._row_only
                         if n not in ("prev_in", "wet_ring")]
        self._params = (None, {})

    def __getattr__(self, name):
        engine = self.__dict__.get("engine")
        if engine is None:
            raise AttributeError(name)
        return getattr(engine, name)

    # -- placement -------------------------------------------------------------------

    def place_state(self, state) -> ShardedState:
        """`state` split over this mesh; a state placed over another mesh
        (or layout) is gathered and placed anew."""
        if isinstance(state, ShardedState):
            if state.mesh is self.mesh and state.layout == self.state_layout:
                return state
            state = state.gather(self.device)
        return ShardedState.place(state, self.mesh, self.state_layout)

    def place_bank(self, bank) -> ShardedBank:
        """`bank` replicated (and split) over this mesh; a bank placed over
        another mesh (or layout) is gathered and placed anew."""
        if isinstance(bank, ShardedBank):
            if bank.mesh is self.mesh and bank.layout == self.bank_layout:
                return bank
            bank = bank.gather(self.device)
        return ShardedBank.place(bank, self.mesh, self.bank_layout)

    # -- helpers -------------------------------------------------------------------

    def _row_params(self, params: VoiceParams, r: int, dev) -> VoiceParams:
        """Voice row r's parameters on `dev`, cached for the params object
        (the control plane re-uploads only on change)."""
        if self._params[0] is not params:
            self._params = (params, {})
        cache = self._params[1]
        if (r, dev) not in cache:
            v0 = r * self.local_voices
            cache[(r, dev)] = VoiceParams(**{
                f.name: _rows(getattr(params, f.name), v0,
                              v0 + self.local_voices, dev)
                for f in fields(params)})
        return cache[(r, dev)]

    def _row(self, arr, r: int, dev):
        v0 = r * self.local_voices
        return _rows(arr, v0, v0 + self.local_voices, dev)

    def _exchange(self, t: torch.Tensor, dev, copy: bool) -> torch.Tensor:
        """One part-axis exchange: `t` onto `dev` (a peer copy, queued on
        both devices' current streams), or, on the same device, a
        contiguous copy where `copy` (the boundary column, which its
        shard's shift overwrites next)."""
        self.mesh.exchanges += 1
        if t.device == dev:
            return (t.clone(memory_format=torch.contiguous_format) if copy
                    else t)
        return t.to(dev, non_blocking=True).contiguous()

    def _reduce(self, sums: list, dev) -> tuple:
        """Add the part shards' partial sums onto part 0's device, in part
        order."""
        out = []
        for i, first in enumerate(sums[0]):
            if first is None:
                out.append(None)
                continue
            acc = first
            for s in sums[1:]:
                acc = acc + self._exchange(s[i], dev, copy=False)
            out.append(acc)
        return tuple(out)

    # -- steps --------------------------------------------------------------------

    def _step(self, mode: str, state: ShardedState, bank: ShardedBank,
              params: VoiceParams, x):
        rows, outs = [], VoiceShards()
        for r, row in enumerate(state.shards):
            dev0 = self.mesh.devices[r][0]
            x_r = self._row(x, r, dev0)
            if len(row) == 1:
                local = self.locals[r][0]
                fn = {"steady": local.step_coef_steady,
                      "indexed": getattr(local, "step_coef_indexed", None),
                      "full": (local.step if local.fade_protocol == "slew"
                               else local.step_coef)}[mode]
                st, out = fn(row[0], bank.shards[r][0],
                             self._row_params(params, r, dev0), x_r)
                new = [st]
            elif isinstance(self.engine, FMajorPartitionedConvolution):
                new, out = self._fmajor_part_step(mode, r, row,
                                                  bank.shards[r], params, x_r)
            else:
                new, out = self._partitioned_part_step(mode, r, row,
                                                       bank.shards[r], params,
                                                       x_r)
            rows.append(new)
            outs.append(out)
        return ShardedState(self.mesh, self.state_layout, rows), outs

    def _fmajor_part_step(self, mode, r, row, brow, params, x_r):
        """Roll-mode fmajor over part shards: every shard's mac_stage on its
        partitions (its new column the previous shard's last one, taken
        before that shard's shift), the sums added on part 0, then part 0's
        finish_stage."""
        devs, local = self.mesh.devices[r], self.locals[r]
        if mode == "full" and not self.engine.swap_snapshot:
            raise ValueError(
                "engine was built with swap_snapshot=False: there is no "
                "materialized fade snapshot to read — fades ride "
                "step_coef_indexed (span provenance)")
        s0 = row[0]
        xn = local[0]._input_spectrum(s0, x_r)
        cols = [xn] + [self._exchange(row[p - 1].fdl[..., -1:], devs[p], True)
                       for p in range(1, len(row))]
        sums = [local[p].mac_stage(s.fdl, brow[p], cols[p],
                                   s0.wptr if p == 0 else None,
                                   s.sel_spectra, s.base,
                                   with_base=mode == "full")
                for p, s in enumerate(row)]
        st0, out = local[0].finish_stage(
            s0, self._row_params(params, r, devs[0]), x_r,
            self._reduce(sums, devs[0]), indexed_base=mode == "indexed")
        return [st0] + row[1:], out

    def _partitioned_part_step(self, mode, r, row, brow, params, x_r):
        """The partitioned engine over part shards: each shard shifts its
        slice of the line by the previous shard's last column and sums its
        partitions' MACs (slewing its slice of the active spectra in the
        'materialized' variant); part 0 adds the sums and finishes."""
        devs, e0, s0 = self.mesh.devices[r], self.locals[r][0], row[0]
        col0 = e0.input_column(s0, x_r)
        cols = [col0] + [self._exchange(row[p - 1].fdl[:, :, -1:], devs[p],
                                        True)
                         for p in range(1, len(row))]
        fdls = [PartitionedConvolution.shift_line(s.fdl, cols[p])
                for p, s in enumerate(row)]
        p0 = self._row_params(params, r, devs[0])
        if self.engine.fade_protocol == "slew":
            res = [PartitionedConvolution.slew_stage(
                fdls[p], brow[p], self._row_params(params, r, devs[p]),
                s.active) for p, s in enumerate(row)]
            (mac,) = self._reduce([(m,) for _, m in res], devs[0])
            st0, out = e0.slew_finish(s0, p0, x_r, fdls[0], res[0][0], mac)
            rest = [replace(s, fdl=fdls[p], active=res[p][0])
                    for p, s in enumerate(row) if p > 0]
        else:
            with_base = mode == "full"
            sums = [PartitionedConvolution.coef_stage(
                fdls[p], brow[p],
                self._row_params(params, r, devs[p]).select,
                s.base if with_base else None) for p, s in enumerate(row)]
            st0, out = e0.coef_finish(s0, p0, x_r, fdls[0],
                                      self._reduce(sums, devs[0]))
            rest = [replace(s, fdl=fdls[p])
                    for p, s in enumerate(row) if p > 0]
        return [st0] + rest, out

    def step_coef_steady(self, state, bank, params, x):
        return self._step("steady", state, bank, params, x)

    def step_coef(self, state, bank, params, x):
        return self._step("full", state, bank, params, x)

    def step_coef_indexed(self, state, bank, params, x):
        return self._step("indexed", state, bank, params, x)

    def step(self, state, bank, params, x):
        return self._step("full", state, bank, params, x)

    # -- rare path -------------------------------------------------------------------

    def _per_partition(self, state: ShardedState, bank: ShardedBank, op
                       ) -> ShardedState:
        """op(local engine, shard state, shard bank, row, device) on every
        shard; part shards > 0 first get their row's small per-voice leaves
        (the values before the op), and keep only their partition leaves
        after it."""
        rows = []
        for r, row in enumerate(state.shards):
            devs, new = self.mesh.devices[r], []
            for p, s in enumerate(row):
                if p > 0:
                    s = replace(s, **{
                        n: (getattr(row[0], n).to(devs[p])
                            if isinstance(getattr(row[0], n), torch.Tensor)
                            else getattr(row[0], n))
                        for n in self._hydrate})
                s = op(self.locals[r][p], s, bank.shards[r][p], r, devs[p])
                if p > 0:
                    s = replace(s, **{n: None for n in self._row_only})
                new.append(s)
            rows.append(new)
        return ShardedState(self.mesh, self.state_layout, rows)

    def collapse(self, state, bank, old_select, changed, new_select=None,
                 params=None):
        def op(e, s, b, r, dev):
            return e.collapse(
                s, b, self._row(old_select, r, dev),
                self._row(changed, r, dev),
                new_select=(None if new_select is None
                            else self._row(new_select, r, dev)),
                params=(None if params is None
                        else self._row_params(params, r, dev)))
        return self._per_partition(state, bank, op)

    def materialize_base(self, state, bank):
        return self._per_partition(
            state, bank, lambda e, s, b, r, dev: e.materialize_base(s, b))

    def regather_selection(self, state, bank, select):
        return self._per_partition(
            state, bank, lambda e, s, b, r, dev: e.regather_selection(
                s, b, self._row(select, r, dev)))

    def collapse_pure(self, state, old_select, changed, params=None):
        rows = []
        for r, row in enumerate(state.shards):
            dev0 = self.mesh.devices[r][0]
            extra = (() if params is None
                     else (self._row_params(params, r, dev0),))
            rows.append([self.locals[r][0].collapse_pure(
                row[0], self._row(old_select, r, dev0),
                self._row(changed, r, dev0), *extra)] + row[1:])
        return ShardedState(self.mesh, self.state_layout, rows)


def sharded(engine, mesh: Mesh) -> ShardedEngine:
    """The ShardedEngine of (engine, mesh) for the factories below and the
    bounce: the engine keeps the last one it was sharded with (so a step
    and its collapse share their local engines), and another mesh
    replaces it."""
    last = engine.__dict__.get("_sharded")
    if last is None or last.mesh is not mesh:
        last = engine.__dict__["_sharded"] = ShardedEngine(engine, mesh)
    return last


# -- the JAX package's factories ---------------------------------------------------

def shard_partitioned_step(engine: PartitionedConvolution, mesh: Mesh,
                           steady: bool = False):
    """The partitioned engine's step over the mesh: step_coef (or its
    steady form) for 'coef', step_materialized for 'materialized'."""
    if not isinstance(engine, PartitionedConvolution):
        raise TypeError("shard_partitioned_step takes a "
                        "PartitionedConvolution")
    sh = sharded(engine, mesh)
    return sh.step_coef_steady if steady and engine.variant == "coef" \
        else sh.step


def shard_collapse(engine: PartitionedConvolution, mesh: Mesh):
    """engine.collapse over the mesh (coef variant)."""
    return sharded(engine, mesh).collapse


def shard_fmajor_step(engine, mesh: Mesh, steady: bool = False,
                      mode: str | None = None):
    """The fmajor step over the mesh: voice data parallelism, and
    partition (sequence) sharding in roll mode when part > 1. mode:
    "steady" | "full" | "indexed" (default "steady" if `steady` else
    "full")."""
    if not isinstance(engine, FMajorPartitionedConvolution):
        raise TypeError("shard_fmajor_step takes an "
                        "FMajorPartitionedConvolution")
    sh = sharded(engine, mesh)
    mode = mode or ("steady" if steady else "full")
    return {"steady": sh.step_coef_steady, "full": sh.step_coef,
            "indexed": sh.step_coef_indexed}[mode]


def shard_fmajor_collapse(engine, mesh: Mesh):
    """The materializing collapse over the mesh (per partition shard; the
    'selected' strategy takes new_select too)."""
    return sharded(engine, mesh).collapse


def shard_fmajor_collapse_pure(engine, mesh: Mesh):
    """The span collapse ([V, 2, K]-sized) over the mesh, on part 0."""
    return sharded(engine, mesh).collapse_pure


def shard_cascade_step(engine, mesh: Mesh, mode: str = "steady"):
    """The cascade step over the voice axis, each voice shard an
    independent cascade over its local voices (its own stagger groups).
    mode: "steady" | "indexed" ('allk') | "full" ('selected')."""
    if not isinstance(engine, CascadeConvolution):
        raise TypeError("shard_cascade_step takes a CascadeConvolution")
    sh = sharded(engine, mesh)
    return {"steady": sh.step_coef_steady, "indexed": sh.step_coef_indexed,
            "full": sh.step_coef}[mode]


def shard_cascade_collapse_pure(engine, mesh: Mesh):
    """The cascade's span collapse (with the in-flight tail rescale, which
    takes the new fade's params) over the voice axis."""
    if not isinstance(engine, CascadeConvolution):
        raise TypeError("shard_cascade_collapse_pure takes a "
                        "CascadeConvolution")
    return sharded(engine, mesh).collapse_pure


def shard_cascade_collapse(engine, mesh: Mesh):
    """The 'selected' cascade's materializing collapse over the voice
    axis."""
    if not isinstance(engine, CascadeConvolution):
        raise TypeError("shard_cascade_collapse takes a CascadeConvolution")
    return sharded(engine, mesh).collapse


def place_state(state, mesh: Mesh, engine) -> ShardedState:
    """Split a single-device state of `engine` over the mesh."""
    return sharded(engine, mesh).place_state(state)


def place_bank(bank, mesh: Mesh, engine) -> ShardedBank:
    """Replicate (and, over part, split) a single-device bank of `engine`
    over the mesh."""
    return sharded(engine, mesh).place_bank(bank)


def place_cascade_state(state, mesh: Mesh, selected: bool = False
                        ) -> ShardedState:
    return ShardedState.place(state, mesh, cascade_layout(selected))


def place_cascade_bank(bank, mesh: Mesh) -> ShardedBank:
    return ShardedBank.place(bank, mesh, Layout(CascadeBank, {}, {}))


def place_cascade(state, bank, mesh: Mesh, selected: bool = False):
    """(state, bank) of the cascade over the mesh (the bank replicated)."""
    return (place_cascade_state(state, mesh, selected),
            place_cascade_bank(bank, mesh))

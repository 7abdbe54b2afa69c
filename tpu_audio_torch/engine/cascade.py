"""Two-stage non-uniform partitioned convolution, the voice-scaling engine
(port of tpu_audio/engine/cascade.py: the 'allk' and 'selected' strategies,
in f32 or bf16).

The uniform fmajor engine reads its whole frequency-domain delay line every
block. The cascade (Gardner 1995) splits each IR in two:

  - **head**: the first ``2*ratio`` block-sized partitions run the exact
    fmajor ring MAC every block, ``ring_mac`` on fmajor's layouts
    (``fdl1 [F1, VI, 2, P1p]``, ``head_rhs2 [F1, 2, 2*P1p, KOD]``);
  - **tail**: the rest is partitioned at ``B2 = ratio * block`` samples and
    needs one rfft(2*B2) + MAC + irfft per voice once every ``ratio``
    blocks. Voice i belongs to stagger group ``i % ratio`` and group
    ``t mod ratio`` computes its tail at block t, so every block does the
    same work: the head for all voices and one group's tail.

A tail chunk completing at block t lands ``ratio + 1 .. 2*ratio + 1``
blocks later (plus predelay) in a modular tail ring; every block emits head
and tail together before the clamp. A tail chunk's fade weights are
projected over the blocks it spans. Steady-state output equals the uniform
engine's.

Two MAC strategies (``mac_strategy``, fmajor's semantics):

  - ``allk``: both stages run the all-K ``ring_mac`` and fades ride the
    span representation only (``base_g``; there is no materialized
    snapshot, so a ``swap_bank`` waits until fades decay);
  - ``selected`` (banks of more than 16 IRs under 'auto', the reference's
    152-IR ``all.index``): each voice's selected MAC columns of both stages
    stay materialized in state (``sel_head``, ``sel_tail``), and so does
    the fade snapshot (``base_head``, ``base_tail``): the MAC is linear in
    its rhs, so the affine crossfade a*base + c*sel rides the materialized
    tensors. The hot loop contracts the delay lines against them per voice
    (a batched ``bmm`` over each voice's window; the tail reads only the
    current group's slice), so a step's cost does not grow with K; the
    bank is read only at a re-select (``collapse``) or a bank swap
    (``regather_selection``). ``ring_mac`` does not launch on this path.

``mac_dtype='bf16'`` stores both delay lines, the bank and the 'selected'
tensors in bfloat16 (the input rings and the wet rings stay f32). Both
MAC stages launch the bf16 ``ring_mac``: exact bf16 products summed in
f32, which is the JAX engine's ``tail_mac='mxu'``; its ``'vpu'`` form
rounds each tail product to bf16 before the sum, which the port does not
copy. The 'selected' per-voice MACs upcast their bf16 windows and take
exact products too, where the JAX engine's rounds each product to bf16.

Layouts that differ from the JAX engine's, where F2 is minor only to ride
the TPU's 128 lanes:

  - ``fdl2 [M, F2, 2*Vg, 2, P2p]`` (M = ratio, Vg = V / ratio), group-major
    and frequency-major: row ``2*j + i`` of group g is input channel i of
    voice ``j*ratio + g``;
  - ``tail_rhs2 [F2, 2, 2*P2p, KOD]``, fmajor's doubled, time-reversed pack;
  - ``sel_tail`` and ``base_tail [M, F2, 2*Vg, d, 2*P2p, OD]`` ('selected'),
    row ``2*j + i`` as in fdl2 (the JAX leaf is [M, Vg, I, d, 2P2p, OD,
    F2]); ``sel_head`` and ``base_head [F1, V, I, d, 2*P1p, OD]`` are the
    JAX layout.

Group g's tail MAC is then ``ring_mac(w2, fdl2[g], tail_rhs2)`` with
``w2 = (t // ratio) mod P2p``: the kernel's own contract, so both MAC stages
launch ``ring_mac`` (twice per block on the card; ``ring_mac_reference``
twice on the CPU). The JAX engine runs the tail MAC on the line from before
the fresh column's write plus a correction for that column, to avoid an
XLA copy; here the column is written in place first. The sum is the same,
its f32 rounding not.

The block counter lives twice in the state: ``t`` on the device (the JAX
leaf) and ``step`` on the host. The host copy picks the stagger group, the
ring slots and the MAC windows, so group slices are views, slot writes land
in place and no step function reads the device. Capturing a step as a CUDA
graph therefore bakes in one group phase.

Like the port's fmajor engine, a step updates ``fdl1``, ``fdl2``,
``inbuf2``, ``tail_ring`` and (write side) ``wet_ring`` IN PLACE and returns
a new CascadeState sharing them, and ``collapse`` rescales ``tail_ring`` in
place: the state passed in is consumed.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from tpu_audio_torch.engine import device_prep
from tpu_audio_torch.engine.fmajor import (
    MAC_DTYPES, _pad_p, _tensor, bmm_f32, double_reversed, pack_mac_rhs,
)
from tpu_audio_torch.engine.params import VoiceParams
from tpu_audio_torch.ops.fft import SpectralTransform
from tpu_audio_torch.ops.mix import add_dry, wet_scale
from tpu_audio_torch.ops.ring_mac import ring_mac
from tpu_audio_torch.utils import diskcache
from tpu_audio_torch.utils.device import resolve_device
from tpu_audio_torch.utils.log import Log

_SPAN_ONLY = ("the 'allk' cascade is span-only: collapse in the span "
              "(collapse_pure); bank swaps defer until fades decay")


@dataclass
class CascadeBank:
    """Device bank: the doubled, time-reversed MAC tensors of both stages,
    both in fmajor's ring-mode layout."""

    head_rhs2: torch.Tensor  # mac [F1, 2, 2*P1p, KOD]
    tail_rhs2: torch.Tensor  # mac [F2, 2, 2*P2p, KOD] (mac: the mac_dtype)

    @property
    def num_irs(self) -> int:
        return self.head_rhs2.shape[-1] // 4


@dataclass
class CascadeState:
    t: torch.Tensor          # i32 [] block counter (mod t_modulus)
    step: int                # the same counter on the host
    fdl1: torch.Tensor       # mac [F1, VI, 2, P1p] head delay line
    prev_in: torch.Tensor    # f32 [V, 2, B]
    inbuf2: torch.Tensor     # f32 [M, Vg, 2, 4*M, B] doubled input ring
    fdl2: torch.Tensor       # mac [M, F2, 2*Vg, 2, P2p] tail delay line
    wet_ring: torch.Tensor   # f32 [V, NH, 2, B] head block-slot ring
    tail_ring: torch.Tensor  # f32 [M, Vg, I, O, NB, B] tail accumulator,
                             # input-channel-resolved for collapse_pure
    coef_a: torch.Tensor     # f32 [V, 2]
    coef_c: torch.Tensor     # f32 [V, 2]
    base_g: torch.Tensor     # f32 [V, 2, K] span fade provenance
                             # ('selected': [V, 2, 1] placeholder)
    base_pure: torch.Tensor  # bool [V, 2] ('allk': always True, span-only;
                             # 'selected': True = the zero snapshot, False
                             # after the first materializing collapse)
    # 'selected' only (size-1 placeholders under 'allk'): each voice's
    # selected MAC columns and its materialized fade snapshot, in mac
    sel_head: torch.Tensor   # [F1, V, I, d, 2*P1p, OD]
    sel_tail: torch.Tensor   # [M, F2, 2*Vg, d, 2*P2p, OD]
    base_head: torch.Tensor  # [F1, V, I, d, 2*P1p, OD]
    base_tail: torch.Tensor  # [M, F2, 2*Vg, d, 2*P2p, OD]
    pd_q: torch.Tensor       # i32 [V] last block's block-granular predelay
    pd_m: torch.Tensor       # i32 [V] live margin of the read-side FIFO


@dataclass
class CascadeSlot:
    """One IR packed for one bank slot (CascadeConvolution.pack_bank_slot):
    the slot's 4 MAC columns of each stage, built on the engine's device.
    `done` (CUDA only) marks the end of that work; `host` is the pinned
    staging buffer of the upload, kept alive until the slot is written."""

    head: torch.Tensor      # mac [F1, 2, 2*P1p, 4]
    tail: torch.Tensor      # mac [F2, 2, 2*P2p, 4]
    host: torch.Tensor      # f32 [O, 2*B2 + tail_parts*B2]
    done: torch.cuda.Event | None = None


def cascade_bank_from_numpy(engine: "CascadeConvolution", head_rhs2,
                            tail_rhs2) -> CascadeBank:
    """The port's bank from a JAX CascadeBank's leaves as numpy arrays: the
    head as it is, the frequency-minor tail [2, 2P2p, KOD, F2] moved to
    [F2, 2, 2P2p, KOD]; bf16 leaves bit for bit."""
    tail = np.ascontiguousarray(np.transpose(np.asarray(tail_rhs2),
                                             (3, 0, 1, 2)))
    return CascadeBank(head_rhs2=_tensor(head_rhs2, engine.device),
                       tail_rhs2=_tensor(tail, engine.device))


def cascade_state_from_numpy(engine: "CascadeConvolution", leaves
                             ) -> CascadeState:
    """The port's state from a JAX CascadeState's leaves, a mapping of
    field name -> numpy array, in either strategy and MAC dtype (bf16
    leaves bit for bit). The JAX fdl2 [M, Vg, I, d, P2p, F2] moves to
    [M, F2, 2*Vg, d, P2p] and a 'selected' sel_tail / base_tail [M, Vg, I,
    d, 2P2p, OD, F2] to [M, F2, 2*Vg, d, 2P2p, OD]; the host counter is
    set from ``t``."""
    dev = engine.device
    fdl2 = np.asarray(leaves["fdl2"])
    m, vg, i, d, pp2, f2 = fdl2.shape
    fdl2 = np.ascontiguousarray(np.transpose(fdl2, (0, 5, 1, 2, 3, 4))
                                ).reshape(m, f2, vg * i, d, pp2)

    def tail_leaf(arr):
        arr = np.asarray(arr)
        if arr.size > 1:
            m_, vg_, i_, d_, q_, od_, f_ = arr.shape
            arr = np.ascontiguousarray(np.transpose(
                arr, (0, 6, 1, 2, 3, 4, 5))).reshape(m_, f_, vg_ * i_, d_,
                                                     q_, od_)
        else:
            arr = arr.reshape((1,) * 6)
        return _tensor(arr, dev)

    t = int(np.asarray(leaves["t"]))
    f32 = {name: _tensor(leaves[name], dev, torch.float32)
           for name in ("prev_in", "inbuf2", "wet_ring", "tail_ring",
                        "coef_a", "coef_c", "base_g")}
    return CascadeState(
        t=_tensor(t, dev, torch.int32).reshape(()), step=t,
        fdl1=_tensor(leaves["fdl1"], dev), fdl2=_tensor(fdl2, dev),
        sel_head=_tensor(leaves["sel_head"], dev),
        base_head=_tensor(leaves["base_head"], dev),
        sel_tail=tail_leaf(leaves["sel_tail"]),
        base_tail=tail_leaf(leaves["base_tail"]),
        base_pure=_tensor(leaves["base_pure"], dev, torch.bool),
        pd_q=_tensor(leaves["pd_q"], dev, torch.int32),
        pd_m=_tensor(leaves["pd_m"], dev, torch.int32), **f32)


class CascadeConvolution:
    """V stereo voices, two-stage non-uniform partitioned OLS, span fades.

    `device`: None or "cuda" selects the best CUDA device (select_gpu,
    which raises without CUDA); "cpu" runs the plain PyTorch path.

    `tail_mac` ("auto", "vpu" or "mxu") is kept for the JAX engine's
    signature, where it picks between two TPU lowerings of the tail MAC.
    Here all three run the same sum on the same kernel (ring_mac), with
    exact products in bf16: the JAX "mxu" form."""

    # the in-flight tail rescale of both collapses needs the post-change
    # vsteps / predelay (StreamSession passes them)
    collapse_pure_takes_params = True
    ALLK_MAX_COLUMNS = 64            # K <= 16 stereo IRs (fmajor threshold)

    def __init__(self, num_voices: int, block: int, partitions: int,
                 ratio: int = 16, max_predelay: int = 8192,
                 num_irs: int | None = None, mac_dtype: str = "f32",
                 predelay_side: str = "write", tail_mac: str = "auto",
                 mac_strategy: str = "allk", device=None):
        if num_voices % ratio:
            raise ValueError(f"{num_voices} voices not divisible by the "
                             f"stagger ratio {ratio} (one voice group's "
                             f"tail chunk runs per block)")
        if partitions <= 2 * ratio:
            raise ValueError(f"IR has {partitions} block partitions <= head "
                             f"length 2*ratio={2 * ratio}; use the uniform "
                             f"fmajor engine for short IRs")
        self.num_voices = num_voices
        self.block = block
        self.partitions = partitions          # total, at block granularity
        self.ratio = ratio
        self.b2 = ratio * block               # tail partition size
        self.head_parts = 2 * ratio           # the head covers [0, 2*B2)
        self.tail_parts = -(-(partitions - self.head_parts) // ratio)
        self.pp1 = -(-self.head_parts // 8) * 8
        self.pp2 = -(-self.tail_parts // 8) * 8
        self.max_predelay = max_predelay
        self.num_irs = num_irs
        if mac_dtype not in MAC_DTYPES:
            raise ValueError(f"unknown mac_dtype {mac_dtype!r}")
        self.mac_dtype_name = mac_dtype
        self.mac_dtype = MAC_DTYPES[mac_dtype]
        # predelay_side="read": the head ring is a FIFO written at two slots
        # per block and read at slot (t - q) per voice; a predelay edit
        # re-times the buffered wet so that both sides give the same output
        if predelay_side not in ("write", "read"):
            raise ValueError(f"unknown predelay_side {predelay_side!r}")
        self.predelay_side = predelay_side
        if tail_mac not in ("auto", "vpu", "mxu"):
            raise ValueError(f"unknown tail_mac {tail_mac!r}")
        self._tail_mac_requested = tail_mac
        self.tail_mac = (tail_mac if tail_mac != "auto" else
                         ("mxu" if (num_voices // ratio) * 2 >= 128
                          else "vpu"))
        if mac_strategy == "auto":
            if num_irs is None:
                raise ValueError("mac_strategy='auto' needs num_irs")
            mac_strategy = ("allk" if num_irs * 4 <= self.ALLK_MAX_COLUMNS
                            else "selected")
        if mac_strategy not in ("allk", "selected"):
            raise ValueError(f"unknown mac_strategy {mac_strategy!r}")
        self.mac_strategy = mac_strategy
        # StreamSession (runtime/stream.py): 'allk' fades ride the span and
        # its swaps defer until they decay; 'selected' materializes its fade
        # snapshot, so a swap mid-fade keeps the old bank's tail
        self.fade_protocol = "spans" if mac_strategy == "allk" else "selected"
        self.swap_snapshot = mac_strategy == "selected"
        self.device = resolve_device(device)
        self.xf1 = SpectralTransform(2 * block)
        self.xf2 = SpectralTransform(2 * self.b2)
        self.f1 = self.xf1.num_bins
        self.f2 = self.xf2.num_bins
        # a tail chunk's earliest output lands ratio+1 blocks after its
        # final input block; its pieces span ratio+1 slots, plus predelay
        self.tail_slot0 = ratio + 1
        self.ring_slots = max_predelay // block + 2 * ratio + 3
        self.head_slots = max_predelay // block + 2   # predelay + spill + emit
        # the block counter wraps at the lcm of every modulus derived from
        # it, so the slot indices stay continuous across the wrap
        self.t_modulus = math.lcm(self.pp1, ratio * self.pp2, 2 * ratio,
                                  self.ring_slots, self.head_slots)
        if self.t_modulus >= 2 ** 31:
            Log.warn("cascade", "block-counter modulus %d overflows int32; "
                     "sessions longer than ~2^31 blocks will corrupt "
                     "ring indices", self.t_modulus)
            self.t_modulus = 0
        self._constants()

    def _constants(self) -> None:
        """Index tensors the steps read, built once on the device so that a
        step uploads nothing. `_w` holds every ring slot a MAC window can
        start at: ring_mac takes a one-element view of it."""
        dev, b, m = self.device, self.block, self.ratio
        v, vg, nb, nh = (self.num_voices, self.num_voices // m,
                         self.ring_slots, self.head_slots)

        def arange(n, dtype=torch.long):
            return torch.arange(n, dtype=dtype, device=dev)

        self._w = arange(max(self.pp1, self.pp2), torch.int32)
        self._bins1 = arange(self.f1, torch.float32)
        self._bins2 = arange(self.f2, torch.float32)
        self._offs = arange(b)
        self._offs2 = arange(self.b2)
        self._slots_h = arange(nh)
        self._head_rows = arange(v) * nh                 # rows of [V*NH, 2B]
        # row of piece 0 of (voice j, channel i, output o) in group g's
        # tail ring viewed as [Vg*I*O*NB, B]
        self._tail_rows = (arange(vg * 4) * nb).reshape(vg, 2, 2, 1)
        self._pieces = arange(m + 1)
        self._proj_steps = arange(self.tail_slot0 + m, torch.float32) + 1.0
        self._ring_steps = arange(nb, torch.float32)
        self._ring_slots = arange(nb)

    # -- offline / cloning interface ------------------------------------------------

    def with_voices(self, num_voices: int, device=None
                    ) -> "CascadeConvolution":
        """Same geometry at another voice count (divisible by the ratio),
        on this engine's device or on `device`. Banks are
        voice-independent."""
        clone = CascadeConvolution(
            num_voices, self.block, self.partitions, ratio=self.ratio,
            max_predelay=self.max_predelay, num_irs=self.num_irs,
            mac_dtype=self.mac_dtype_name, predelay_side=self.predelay_side,
            tail_mac=self._tail_mac_requested,
            mac_strategy=self.mac_strategy,
            device=self.device if device is None else device)
        clone.xf1, clone.xf2 = self.xf1, self.xf2
        return clone

    @property
    def history_blocks(self) -> int:
        """Trailing input blocks that fully determine the next output block
        at converged params: the tail line's span plus the stagger window,
        the head and the deepest ring deferral."""
        return ((self.tail_parts + 2) * self.ratio + self.head_parts
                + self.ring_slots + 2)

    # -- bank ---------------------------------------------------------------------

    def _pack_bank_host(self, head_spec: np.ndarray, tail_spec: np.ndarray):
        """Host complex partition spectra [K, O, P, F] of each stage -> the
        numpy MAC tensors head [F1, 2, 2*P1p, KOD] and tail [F2, 2, 2*P2p,
        KOD], doubling before packing (fmajor.double_reversed)."""
        head = double_reversed(_pad_p(head_spec, 2, self.pp1), 2)
        tail = double_reversed(_pad_p(tail_spec, 2, self.pp2), 2)
        return (pack_mac_rhs(head, 2 * self.pp1),
                pack_mac_rhs(tail, 2 * self.pp2))

    def prepare_bank(self, bank, cache_dir: str | os.PathLike | None = None
                     ) -> CascadeBank:
        """IRBank -> CascadeBank from host spectra: the head takes the IRs'
        first 2*B2 samples at block granularity, the tail the rest at B2
        granularity (the tail spectra at the bank's natural length, cut or
        zero-padded to tail_parts, as the JAX engine computes them).

        cache_dir: the bank's spectra disk cache
        (IRBank.cached_partitioned_spectra) and a content-addressed cache
        of the PACKED tensors, ``cascpack_<key>`` entries keyed and stored
        as the JAX package stores them (utils/diskcache.py; the tail in
        its frequency-minor layout [2, 2*P2p, KOD, F2], transposed here),
        so either package reads the other's."""
        if cache_dir:
            head_spec = bank.cached_partitioned_spectra(
                self.block, cache_dir, max_partitions=self.head_parts)
            tail_spec = bank.cached_partitioned_spectra(
                self.b2, cache_dir, offset=2 * self.b2)
        else:
            head_spec = bank.partitioned_spectra(
                self.block, max_partitions=self.head_parts)
            tail_spec = bank.partitioned_spectra(self.b2,
                                                 offset=2 * self.b2)
        if tail_spec.shape[2] < self.tail_parts:
            pad = self.tail_parts - tail_spec.shape[2]
            tail_spec = np.pad(tail_spec, ((0, 0), (0, 0), (0, pad), (0, 0)))
        tail_spec = tail_spec[:, :, : self.tail_parts]
        k = head_spec.shape[0]
        if self.num_irs is not None and k != self.num_irs:
            raise ValueError(f"bank has {k} IRs, engine was built for "
                             f"num_irs={self.num_irs}")
        self.num_irs = k
        head_rhs2 = tail_rhs2 = base = None
        if cache_dir:
            base = "cascpack_" + diskcache.content_key(
                "cascade-pack", (self.pp1, self.pp2, head_spec.shape,
                                 tail_spec.shape), head_spec, tail_spec)
            hit = diskcache.load(cache_dir, base, ("head", "tail"))
            if hit is not None:
                Log.info("cascade", "packed-bank cache hit: %s/%s*",
                         os.fspath(cache_dir), base)
                head_rhs2 = hit["head"]
                tail_rhs2 = np.ascontiguousarray(
                    np.transpose(hit["tail"], (3, 0, 1, 2)))
        if head_rhs2 is None:
            head_rhs2, tail_rhs2 = self._pack_bank_host(head_spec, tail_spec)
            if base is not None:
                diskcache.store(cache_dir, base, {
                    "head": head_rhs2,
                    "tail": np.ascontiguousarray(
                        np.transpose(tail_rhs2, (1, 2, 3, 0)))})
        dt = self.mac_dtype
        return CascadeBank(head_rhs2=_tensor(head_rhs2, self.device).to(dt),
                           tail_rhs2=_tensor(tail_rhs2, self.device).to(dt))

    def update_bank_slot(self, bank: CascadeBank, slot: int,
                         ir: np.ndarray) -> CascadeBank:
        """Replace ONE IR slot of a device bank (working-set residency) with
        the time-domain IR `ir` [O, L]: both stages' partition FFTs and
        packs run on the device (pack_bank_slot) and the slot's columns are
        written in place (write_bank_slot). Returns the same bank object.
        'allk' only: the 'selected' strategy reads per-voice materialized
        columns, which a bank-slot write would silently miss."""
        return self.write_bank_slot(bank, slot, self.pack_bank_slot(ir))

    def pack_bank_slot(self, ir: np.ndarray) -> CascadeSlot:
        """Host [O, L] IR -> its CascadeSlot on the engine's device: one
        zero-pad to both stages' partition grids on the host, one upload
        (through a pinned buffer on CUDA), then the partition FFTs and
        packs on the current stream. Reads no bank, so it may run on a
        side stream while blocks stream."""
        self._require_allk()
        ir = np.asarray(ir)
        if ir.ndim != 2 or np.iscomplexobj(ir):
            raise ValueError(f"a slot update takes a time-domain [O, L] "
                             f"IR, got {ir.dtype} {ir.shape}")
        lp = (2 + self.tail_parts) * self.b2
        pad = np.zeros((ir.shape[0], lp), np.float32)
        pad[:, : min(ir.shape[1], lp)] = ir[:, :lp]
        host = torch.from_numpy(pad)
        if self.device.type == "cuda":
            host = host.pin_memory()
        td = host.to(self.device, non_blocking=True)[None]
        head, tail = device_prep.cascade_columns(self, td)
        head, tail = head.to(self.mac_dtype), tail.to(self.mac_dtype)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return CascadeSlot(head=head, tail=tail, host=host, done=done)

    def write_bank_slot(self, bank: CascadeBank, slot: int,
                        packed: CascadeSlot, device: torch.device | None = None
                        ) -> CascadeBank:
        """Write a packed slot into `bank` in place on the current stream
        (columns 4k:4k+4 of both stages). On CUDA the current stream first
        waits for the stream that packed the slot, and the packed tensors
        are marked in use by it until the copies ran. `device` is the
        bank's (default the engine's): its current stream takes the
        copies."""
        self._require_allk()
        col0 = 4 * int(slot)
        device = self.device if device is None else device
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            if packed.done is not None:
                stream.wait_event(packed.done)
            for t in (packed.head, packed.tail):
                t.record_stream(stream)
        bank.head_rhs2[..., col0: col0 + 4].copy_(packed.head)
        bank.tail_rhs2[..., col0: col0 + 4].copy_(packed.tail)
        return bank

    def _require_allk(self) -> None:
        if self.mac_strategy != "allk":
            raise ValueError("working-set slot updates require the 'allk' "
                             "MAC strategy (the 'selected' MAC reads "
                             "per-voice materialized columns, not bank "
                             "slots)")

    # -- state ---------------------------------------------------------------------

    def _sel_shapes(self):
        """(head, tail) shapes of the 'selected' strategy's per-voice
        columns; size-1 placeholders under 'allk'."""
        if self.mac_strategy != "selected":
            return (1,) * 6, (1,) * 6
        v, m = self.num_voices, self.ratio
        return ((self.f1, v, 2, 2, 2 * self.pp1, 4),
                (m, self.f2, 2 * (v // m), 2, 2 * self.pp2, 4))

    def init_state(self) -> CascadeState:
        if self.num_irs is None:
            raise ValueError("pass num_irs= or call prepare_bank before "
                             "init_state (base_g is bank-sized)")
        v, b, m = self.num_voices, self.block, self.ratio
        vg = v // m
        dt = self.mac_dtype
        kg = self.num_irs if self.mac_strategy == "allk" else 1
        hsh, tsh = self._sel_shapes()

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return CascadeState(
            t=zeros(dtype=torch.int32), step=0,
            fdl1=zeros(self.f1, v * 2, 2, self.pp1, dtype=dt),
            prev_in=zeros(v, 2, b),
            inbuf2=zeros(m, vg, 2, 4 * m, b),
            fdl2=zeros(m, self.f2, vg * 2, 2, self.pp2, dtype=dt),
            wet_ring=zeros(v, self.head_slots, 2, b),
            tail_ring=zeros(m, vg, 2, 2, self.ring_slots, b),
            coef_a=zeros(v, 2), coef_c=zeros(v, 2),
            base_g=zeros(v, 2, kg),
            base_pure=torch.ones((v, 2), dtype=torch.bool, device=self.device),
            sel_head=zeros(*hsh, dtype=dt), sel_tail=zeros(*tsh, dtype=dt),
            base_head=zeros(*hsh, dtype=dt), base_tail=zeros(*tsh, dtype=dt),
            # pd_q = pd_m = 0 is safe at any predelay: the first read-side
            # step then re-times an all-zero ring
            pd_q=zeros(v, dtype=torch.int32), pd_m=zeros(v, dtype=torch.int32))

    def init_converged(self, bank: CascadeBank, params: VoiceParams
                       ) -> CascadeState:
        state = replace(self.init_state(),
                        coef_c=params.wet.to(torch.float32).clone())
        if self.mac_strategy == "selected":
            state = replace(state,
                            sel_head=self._gather_head(bank, params.select),
                            sel_tail=self._gather_tail(bank, params.select))
        return state

    def _gather_head(self, bank: CascadeBank, select: torch.Tensor
                     ) -> torch.Tensor:
        """Per-voice head columns [F1, V, I, d, 2*P1p, OD] gathered from the
        all-K tensor by each (voice, channel)'s selection."""
        k = bank.num_irs
        r = bank.head_rhs2.reshape(self.f1, 2, 2 * self.pp1, k, 4)
        g = r.index_select(3, select.reshape(-1).long())  # [F1,d,2P1p,VI,OD]
        g = g.reshape(self.f1, 2, 2 * self.pp1, self.num_voices, 2, 4)
        return g.permute(0, 3, 4, 1, 2, 5).to(self.mac_dtype).contiguous()

    def _gather_tail(self, bank: CascadeBank, select: torch.Tensor
                     ) -> torch.Tensor:
        """Per-voice tail columns [M, F2, 2*Vg, d, 2*P2p, OD], group-major
        (voice j*ratio + g at [g, row 2*j + i], as fdl2)."""
        k, m = bank.num_irs, self.ratio
        vg = self.num_voices // m
        r = bank.tail_rhs2.reshape(self.f2, 2, 2 * self.pp2, k, 4)
        order = select.reshape(vg, m, 2).transpose(0, 1).reshape(-1)
        g = r.index_select(3, order.long())               # [F2,d,2P2p,M*2Vg,OD]
        g = g.reshape(self.f2, 2, 2 * self.pp2, m, 2 * vg, 4)
        return g.permute(3, 0, 4, 1, 2, 5).to(self.mac_dtype).contiguous()

    # -- shared pieces ---------------------------------------------------------------

    def _group(self, arr: torch.Tensor, g: int) -> torch.Tensor:
        """[V, ...] -> group g's [Vg, ...] (voice j*ratio + g at row j): a
        strided view."""
        return arr.reshape((-1, self.ratio) + arr.shape[1:])[:, g]

    @staticmethod
    def _per_voice(fdl: torch.Tensor, cols: torch.Tensor, w: int
                   ) -> torch.Tensor:
        """The 'selected' MAC of one stage: the line fdl [F, R, d, Pp]
        against each row's own doubled, reversed columns cols [F, R, d,
        2Pp, OD] over the window [Pp - w, 2Pp - w) (a strided view), both
        in the MAC dtype: a batched [1, Pp] x [Pp, OD] product per (f, row,
        d) summed in f32 (bmm_f32), then over d. -> [F, R // 2, I, O, d]."""
        f, rows, _, pp = fdl.shape
        win = cols[..., pp - w: 2 * pp - w, :]              # [F,R,d,Pp,OD]
        lhs = fdl.reshape(f * rows * 2, 1, pp)
        mv = bmm_f32(lhs, win.reshape(f * rows * 2, pp, 4))
        mv = mv.reshape(f, rows, 2, 4).sum(dim=2)           # [F, R, OD]
        return mv.reshape(f, rows // 2, 2, 2, 2)

    @staticmethod
    def _allk_terms(m: torch.Tensor, select: torch.Tensor,
                    base_g: torch.Tensor, with_base: bool):
        """All-K MAC output m [F, 2*Vr, KOD] -> each voice's selected
        products [F, Vr, I, O, d] and, with_base, its span snapshot's
        sum_k base_g[k] * m[k] (the same layout)."""
        f, vi, kod = m.shape
        nv, k = vi // 2, kod // 4
        m = m.reshape(f, nv, 2, k, 2, 2)                      # [F,V,I,K,O,d]
        sel = select.long()[None, :, :, None, None, None]
        y_sel = torch.gather(m, 3, sel.expand(f, nv, 2, 1, 2, 2))[:, :, :, 0]
        y_base = (torch.einsum("fvikod,vik->fviod", m, base_g)
                  if with_base else None)
        return y_sel, y_base

    def _project(self, vsteps: torch.Tensor) -> torch.Tensor:
        """The fade decay factors prod_{j=1..n} (1 - r_j) at n = tail_slot0
        .. tail_slot0 + ratio (the blocks a tail chunk's pieces land in),
        with r_j = 1 / (max(vsteps - j, 0) + 5) the slew recursion's rate
        j blocks ahead (reference src/conv.cu:15-32). The JAX engine runs
        the recursion as a scan; a_n = a * P_n and c_n = wet + (c - wet) *
        P_n is its closed form. [..., 2] -> [..., 2, ratio + 1]."""
        r = 1.0 / (torch.clamp_min(vsteps.to(torch.float32)[..., None]
                                   - self._proj_steps, 0.0) + 5.0)
        return torch.cumprod(1.0 - r, dim=-1)[..., self.tail_slot0 - 1:]

    # -- the step -------------------------------------------------------------------

    def _step(self, state: CascadeState, bank: CascadeBank,
              params: VoiceParams, x: torch.Tensor, with_base: bool):
        b = self.block
        h = state.step
        pd = params.predelay[:, 0].long()    # channel-0 quirk (conv.cu:411)
        q = pd // b
        r_pd = pd % b
        # coefficient slew (this block)
        r = 1.0 / (params.vsteps.to(torch.float32) + 5.0)
        a = state.coef_a * (1.0 - r)
        c = state.coef_c * (1.0 - r) + params.wet * r
        scale = wet_scale(params)                                 # [V, I, O]

        head_now, ring = self._head_stage(state, bank, params, x, with_base,
                                          h, a, c, scale, q, r_pd)
        tail_now = self._tail_stage(state, bank, params, x, with_base, h,
                                    a, c, scale, q, r_pd)
        out = add_dry(torch.clamp(head_now + tail_now, -1.0, 1.0), x, params)

        h_next = (h + 1) % self.t_modulus if self.t_modulus else h + 1
        q32 = q.to(torch.int32)
        return replace(
            state, t=torch.full((), h_next, dtype=torch.int32,
                                device=self.device),
            step=h_next, prev_in=x, wet_ring=ring, coef_a=a, coef_c=c,
            pd_q=q32, pd_m=torch.maximum(state.pd_m - 1, q32)), out

    def _head_stage(self, state, bank, params, x, with_base, h, a, c, scale,
                    q, r_pd):
        """The exact fmajor 'allk' ring block over the head partitions:
        slot write, ring_mac, selection and span fade, predelay. Returns
        the head's wet for this block [V, O, B] and the new head ring."""
        b, v, f1 = self.block, self.num_voices, self.f1
        seg = torch.cat([state.prev_in, x], dim=-1)               # [V, 2, 2B]
        spec1 = self.xf1.rfft(seg)                                # [V, 2, F1]
        xn1 = torch.stack([spec1.real, spec1.imag], dim=-1)       # [V,2,F1,2]
        w1 = h % self.pp1
        fdl1 = state.fdl1
        fdl1[..., w1] = xn1.reshape(v * 2, f1, 2).permute(1, 0, 2)
        if self.mac_strategy == "selected":
            def head(cols):                          # [F1, 2V, d, 2P1p, OD]
                return self._per_voice(fdl1, cols.reshape(f1, v * 2, 2, -1,
                                                          4), w1)

            y_sel = head(state.sel_head)
            y_base = head(state.base_head) if with_base else None
        else:
            m1 = ring_mac(self._w[w1], fdl1, bank.head_rhs2)      # [F1,VI,KOD]
            y_sel, y_base = self._allk_terms(m1, params.select, state.base_g,
                                             with_base)
        y = torch.einsum("fviod,vio->fvod", y_sel, c[..., None] * scale)
        if with_base:
            y = y + torch.einsum("fviod,vio->fvod", y_base,
                                 a[..., None] * scale)

        # predelay: the sub-block part as a spectral phase ramp, the block
        # part as the ring slot (fmajor._finish)
        ang = (2.0 * math.pi / (2 * b)) * (
            self._bins1[:, None] * r_pd.to(torch.float32)[None, :])  # [F1, V]
        cs, sn = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        spec = torch.complex(y[..., 0] * cs + y[..., 1] * sn,
                             y[..., 1] * cs - y[..., 0] * sn)
        ys1 = self.xf1.irfft(spec.permute(1, 2, 0))               # [V, O, 2B]
        rr = r_pd[:, None, None]
        head_main = torch.where(self._offs >= rr, ys1[..., b:], 0.0)
        head_tail = torch.where(self._offs < rr, ys1[..., :b], 0.0)

        nh = self.head_slots
        if self.predelay_side == "write":
            # scatter at (t + q) and (t + q + 1) mod NH, emit slot t, clear it
            ring = state.wet_ring
            rows = ring.view(v * nh, 2 * b)
            slot = (q + h) % nh
            rows.index_add_(0, self._head_rows + slot,
                            head_main.reshape(v, 2 * b))
            rows.index_add_(0, self._head_rows + (slot + 1) % nh,
                            head_tail.reshape(v, 2 * b))
            emit = h % nh
            head_now = ring[:, emit].clone()
            ring[:, emit] = 0.0
            return head_now, ring
        return self._read_side(state, h, q, head_main, head_tail)

    def _read_side(self, state, h, q, head_main, head_tail):
        """The head ring as a FIFO (predelay_side='read'): slot t holds
        tail_{t-1} + main_t and each voice emits slot (t - q) mod NH.

        A predelay edit q_prev -> q re-times the buffered wet: each edited
        voice's ring rolls forward by delta = q_prev - q, so content keeps
        its absolute emit time (the write side's semantics, the
        reference's residual buffer, src/conv.cu:89-100). The JAX engine
        runs that roll under lax.cond on the blocks with an edit; here it
        runs every block on the device, and a device-side any(delta != 0)
        selects it, so no host branch reads the device. Liveness: content
        at slot s is live iff its offset from the window origin t - q_prev
        is <= pd_m, the live margin (after a decrease the window reaches
        into future slots for delta blocks, and the spill slot is then
        accumulated into, not cleared). Every remainder keeps the JAX
        engine's + 2*NH / + NH offsets, so the arguments are non-negative
        and torch's floored % equals lax.rem."""
        v, b, nh = self.num_voices, self.block, self.head_slots
        ring = state.wet_ring
        hn = h % nh
        pd_q, m_prev = state.pd_q.long(), state.pd_m.long()
        delta = pd_q - q                                          # [V]
        edit = (delta != 0).any()
        src = (self._slots_h[None, :] - delta[:, None] + 2 * nh) % nh
        # reduce t mod NH before subtracting: the JAX bug fixed at
        # cascade.py:750-758 appeared once t > 4*NH
        origin = (hn - pd_q + 2 * nh) % nh
        off = (src - origin[:, None] + nh) % nh
        live = (off <= m_prev[:, None]) | ~edit
        src = torch.where(edit, src, self._slots_h[None, :])
        rolled = torch.gather(ring, 1, src[:, :, None, None].expand(v, nh, 2,
                                                                    b))
        ring = torch.where(live[:, :, None, None], rolled, 0.0)

        # emit from the ring before this block's slot writes; only slot t
        # changes under them, read by q == 0 voices: add head_main there
        emit = (hn - q + nh) % nh
        head_now = torch.gather(ring, 1, emit[:, None, None, None].expand(
            v, 1, 2, b))[:, 0]
        head_now = head_now + torch.where((q == 0)[:, None, None], head_main,
                                          0.0)
        ring[:, hn] += head_main
        # the spill slot: overwritten in steady state (its old content is
        # already emitted), accumulated while the margin exceeds q
        s1 = (h + 1) % nh
        keep = (m_prev > q)[:, None, None]
        ring[:, s1] = torch.where(keep, ring[:, s1], 0.0) + head_tail
        return head_now, ring

    def _tail_stage(self, state, bank, params, x, with_base, h, a, c, scale,
                    q, r_pd):
        """One voice group's tail chunk: input ring, rfft(2*B2), the tail
        ring_mac, selection and span fade, projected fade weights, irfft,
        the scatter into the group's tail-ring rows; then every voice's
        tail for this block is read and its slot cleared. Returns the tail
        wet for this block [V, O, B]."""
        b, v, m, b2 = self.block, self.num_voices, self.ratio, self.b2
        vg, f2, nb = v // m, self.f2, self.ring_slots
        g = h % m
        # every group's doubled input ring takes this block at slot t and
        # t + 2M; group g's window [t+1, t+1+2M) is its last 2*B2 samples
        s2 = h % (2 * m)
        inbuf2 = state.inbuf2
        xg = x.reshape(vg, m, 2, b).transpose(0, 1)               # [M,Vg,2,B]
        inbuf2[:, :, :, s2] = xg
        inbuf2[:, :, :, s2 + 2 * m] = xg
        t1 = (h + 1) % (2 * m)
        seg2 = inbuf2[g, :, :, t1: t1 + 2 * m].reshape(vg, 2, 2 * b2)
        spec2 = self.xf2.rfft(seg2)                               # [Vg, 2, F2]
        xn2 = torch.stack([spec2.real, spec2.imag], dim=-1)       # [Vg,2,F2,2]
        w2 = (h // m) % self.pp2
        fdl2 = state.fdl2[g]                                      # view
        fdl2[..., w2] = xn2.reshape(vg * 2, f2, 2).permute(1, 0, 2)
        if self.mac_strategy == "selected":
            # the current group's slice of the per-voice columns only
            y_sel = self._per_voice(fdl2, state.sel_tail[g], w2)
            y_base = (self._per_voice(fdl2, state.base_tail[g], w2)
                      if with_base else None)
        else:
            m2 = ring_mac(self._w[w2], fdl2, bank.tail_rhs2)      # [F2,2Vg,KOD]
            y_sel, y_base = self._allk_terms(
                m2, self._group(params.select, g),
                self._group(state.base_g, g), with_base)
        ys = torch.stack([y_sel] + ([y_base] if with_base else []))
        ys = ys * self._group(scale, g)[:, :, :, None]          # [S,F2,Vg,I,O,d]

        # sub-block predelay phase ramp, irfft(2*B2), the shifted window cut
        # into ratio + 1 block pieces (main B2 samples, then the spill)
        rg = self._group(r_pd, g)                                 # [Vg]
        ang = (2.0 * math.pi / (2 * b2)) * (
            rg.to(torch.float32)[:, None] * self._bins2[None, :])  # [Vg, F2]
        cs, sn = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
        yt = ys.permute(0, 2, 3, 4, 1, 5)                         # [S,Vg,I,O,F2,d]
        yre, yim = yt[..., 0], yt[..., 1]
        ys2 = self.xf2.irfft(torch.complex(yre * cs + yim * sn,
                                           yim * cs - yre * sn))  # [S,Vg,I,O,2B2]
        rgb = rg[:, None, None, None]
        main = torch.where(self._offs2 >= rgb, ys2[..., b2:], 0.0)
        spill = torch.where(self._offs < rgb, ys2[..., :b], 0.0)
        pieces = torch.cat([main.reshape(-1, vg, 2, 2, m, b),
                            spill[..., None, :]], dim=-2)         # [S,Vg,I,O,M+1,B]

        # fade weights at each piece's block t + tail_slot0 + k, projected
        # from this block's (already updated) coefficients
        proj = self._project(self._group(params.vsteps, g))       # [Vg, I, M+1]
        wet = self._group(params.wet, g)[..., None]
        c_proj = wet + (self._group(c, g)[..., None] - wet) * proj
        weighted = pieces[0] * c_proj[:, :, None, :, None]
        if with_base:
            a_proj = self._group(a, g)[..., None] * proj
            weighted = weighted + pieces[1] * a_proj[:, :, None, :, None]

        # every voice's tail for this block (slot t mod NB) before the
        # scatter; the scatter's slots t + tail_slot0 + q + k never reach it
        tail_ring = state.tail_ring
        emit = h % nb
        tail_now = tail_ring[:, :, :, :, emit].sum(dim=2)         # [M,Vg,O,B]
        tail_now = tail_now.transpose(0, 1).reshape(v, 2, b)
        # scatter into group g's rows at (t + tail_slot0 + q + k) mod NB
        slot = (self._group(q, g)[:, None] + (h + self.tail_slot0)
                + self._pieces[None, :]) % nb                     # [Vg, M+1]
        rows = self._tail_rows + slot[:, None, None, :]           # [Vg,I,O,M+1]
        tail_ring[g].view(-1, b).index_add_(0, rows.reshape(-1),
                                            weighted.reshape(-1, b))
        tail_ring[:, :, :, :, emit] = 0.0
        return tail_now

    # -- coef-engine interface (StreamSession) ---------------------------------------

    def step_coef(self, state, bank, params, x, with_base: bool = True,
                  indexed_base: bool = False):
        """One block, fade-capable: 'allk' takes the span fade term
        (indexed_base), 'selected' the materialized snapshot's."""
        if (with_base and not indexed_base
                and self.mac_strategy != "selected"):
            raise ValueError(
                "the 'allk' cascade is span-only (no materialized fade "
                "snapshot); fades ride step_coef_indexed")
        return self._step(state, bank, params, x, with_base=with_base)

    def step_coef_steady(self, state, bank, params, x):
        """Steady-state hot path: base term elided (coef_a ~ 0)."""
        return self._step(state, bank, params, x, with_base=False)

    def step_coef_indexed(self, state, bank, params, x):
        """The crossfading step: the span snapshot's term comes from the
        same all-K MAC outputs of both stages ('allk' only)."""
        if self.mac_strategy != "allk":
            raise ValueError("indexed fade requires the 'allk' MAC strategy "
                             "('selected' fades read the materialized "
                             "snapshot through step_coef)")
        return self._step(state, bank, params, x, with_base=True)

    def step(self, state, bank, params, x):
        return self._step(state, bank, params, x, with_base=True)

    def collapse(self, state: CascadeState, bank: CascadeBank,
                 old_select: torch.Tensor, changed: torch.Tensor,
                 new_select: torch.Tensor | None = None,
                 params: VoiceParams | None = None) -> CascadeState:
        """'selected' re-base (fmajor.collapse's semantics): the MAC is
        linear in its columns, so the affine snapshot materializes directly
        on them, base := a*base_eff + c*sel for changed voices (the OLD
        selection's columns are exactly sel_*), base := base_eff for the
        others, then sel_* re-gathers `new_select` for changed voices.
        base_eff honours purity (pure: the zero snapshot). The in-flight
        tail rescale is collapse_pure's and needs `params`, the post-change
        snapshot. The 'allk' cascade stays span-only: collapse_pure."""
        if self.mac_strategy != "selected":
            raise ValueError(_SPAN_ONLY)
        if new_select is None:
            raise ValueError("'selected' strategy collapse needs new_select")
        if params is None:
            raise ValueError("cascade collapse needs params (the post-"
                             "change snapshot) for the in-flight tail "
                             "rescale")
        a, c = state.coef_a, state.coef_c

        def mix(base, sel, brd):
            base_eff = torch.where(brd(state.base_pure), 0.0, base.float())
            out = brd(a) * base_eff + brd(c) * sel.float()
            return torch.where(brd(changed), out, base_eff).to(base.dtype)

        new_head = self._gather_head(bank, new_select)
        new_tail = self._gather_tail(bank, new_select)
        return replace(
            state,
            base_head=mix(state.base_head, state.sel_head, self._bh),
            base_tail=mix(state.base_tail, state.sel_tail, self._bt),
            sel_head=torch.where(self._bh(changed), new_head, state.sel_head),
            sel_tail=torch.where(self._bt(changed), new_tail, state.sel_tail),
            tail_ring=self._rescale_inflight(state, changed, params),
            base_pure=torch.zeros_like(state.base_pure),
            coef_a=torch.where(changed, 1.0, state.coef_a),
            coef_c=torch.where(changed, 0.0, state.coef_c),
        )

    @staticmethod
    def _bh(x2: torch.Tensor) -> torch.Tensor:
        """[V, 2] -> broadcast over a head column leaf [F1,V,I,d,2P1p,OD]."""
        return x2[None, :, :, None, None, None]

    def _bt(self, x2: torch.Tensor) -> torch.Tensor:
        """[V, 2] -> broadcast over a tail column leaf [M,F2,2Vg,d,2P2p,OD]
        (voice j*ratio + g at [g, row 2*j + i])."""
        m = self.ratio
        g2 = x2.reshape(-1, m, 2).transpose(0, 1).reshape(m, -1)
        return g2[:, None, :, None, None, None]

    def materialize_base(self, state: CascadeState, bank: CascadeBank
                         ) -> CascadeState:
        """'selected': materialize purity with no re-select, base_* :=
        base_eff (purity only ever holds the zero snapshot, so no bank
        read), purity cleared; selection, coefficients and the tail ring
        untouched."""
        if self.mac_strategy != "selected":
            raise ValueError("the 'allk' cascade is span-only: snapshots "
                             "cannot materialize — defer bank swaps until "
                             "fades decay")

        def eff(base, brd):
            return torch.where(brd(state.base_pure), 0.0,
                               base.float()).to(base.dtype)

        return replace(state,
                       base_head=eff(state.base_head, self._bh),
                       base_tail=eff(state.base_tail, self._bt),
                       base_pure=torch.zeros_like(state.base_pure))

    def regather_selection(self, state: CascadeState, bank: CascadeBank,
                           select: torch.Tensor) -> CascadeState:
        """'selected': re-point the per-voice columns at a (new) bank's
        content for the current selection (StreamSession's bank swap)."""
        if self.mac_strategy != "selected":
            raise ValueError(_SPAN_ONLY)
        return replace(state, sel_head=self._gather_head(bank, select),
                       sel_tail=self._gather_tail(bank, select))

    def collapse_pure(self, state: CascadeState, old_select: torch.Tensor,
                      changed: torch.Tensor, params: VoiceParams
                      ) -> CascadeState:
        """Span collapse (fmajor.collapse_pure) plus the in-flight fix: a
        changed voice's tail content already scattered for future blocks
        carries pre-collapse weights, so it is rescaled by the new fade-out
        trajectory (_rescale_inflight). `params` is the post-change
        snapshot (the new fade's vsteps and the predelay that maps ring
        slots to compute blocks)."""
        if self.mac_strategy != "allk":
            raise ValueError("span collapse requires the 'allk' MAC "
                             "strategy ('selected' collapses materialize: "
                             "collapse)")
        k = state.base_g.shape[-1]
        oh = (old_select.long()[..., None]
              == torch.arange(k, device=old_select.device)).to(torch.float32)
        prev = torch.where(state.base_pure[..., None], state.base_g, 0.0)
        g = state.coef_a[..., None] * prev + state.coef_c[..., None] * oh
        return replace(
            state,
            tail_ring=self._rescale_inflight(state, changed, params),
            base_g=torch.where(changed[..., None], g, state.base_g),
            base_pure=changed | state.base_pure,
            coef_a=torch.where(changed, 1.0, state.coef_a),
            coef_c=torch.where(changed, 0.0, state.coef_c),
        )

    def _rescale_inflight(self, state: CascadeState, changed: torch.Tensor,
                          params: VoiceParams) -> torch.Tensor:
        """Scale a changed voice's tail-ring content, IN PLACE, by the
        post-collapse fade-out factor a'_d = prod_{j=0..d} (1 - r_j) of the
        block d = n - q that slot distance n maps to (d < 0: computed before
        the collapse, factor 1)."""
        v, nb = self.num_voices, self.ring_slots
        r = 1.0 / (torch.clamp_min(params.vsteps.to(torch.float32)[..., None]
                                   - self._ring_steps, 0.0) + 5.0)  # [V,2,NB]
        traj = torch.cat([torch.ones_like(r[..., :1]),
                          torch.cumprod(1.0 - r, dim=-1)], dim=-1)
        q = params.predelay[:, 0].long() // self.block
        idx = torch.clamp(self._ring_slots[None, :] - q[:, None] + 1, 0, nb)
        factor = torch.gather(traj, 2, idx[:, None, :].expand(v, 2, nb))
        factor = torch.where(changed[..., None], factor, 1.0)
        # the ring is modular: distance n lives at slot (t + n) mod NB
        factor = torch.roll(factor, state.step % nb, dims=-1)
        factor = factor.reshape(-1, self.ratio, 2, nb).transpose(0, 1)
        return state.tail_ring.mul_(factor[:, :, :, None, :, None])

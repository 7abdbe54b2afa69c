"""Production engine: f-major planar partitioned overlap-save (port of
tpu_audio/engine/fmajor.py, in f32 or bf16, either per-voice MAC form).

Layouts are the JAX engine's, so the two compare like with like:

  - the frequency-domain delay line is f-MAJOR planar f32
    ``fdl [F, V*I, 2, Pp]`` (re/im plane pairs; each row [2*Pp] is one
    contiguous run);
  - complex products are encoded as 2x2 real blocks (pack_mac_rhs): plane
    c=0 of the bank carries (br, bi) columns, plane c=1 (-bi, br).

Two delay-line modes (``ring``, equivalence-tested against the JAX engine):

  - ``ring=True`` (default): nothing shifts. The new block spectrum lands in
    slot w = t mod Pp and slot s pairs with bank partition (w - s) mod Pp
    through a window [Pp-w, 2Pp-w) of DOUBLED, time-REVERSED tensors
    (``rhs2``, ``spectra_rev2``); the window start is read from the device
    block counter, never from the host. The fade snapshot ``base`` is
    stored the same way in bfloat16: a transient whose weight coef_a decays
    to zero by construction;
  - ``ring=False`` (roll mode): the line shifts by one partition per block,
    everything in natural order, fade snapshot in f32. Under 'allk' the
    shift and the MAC are one kernel (ops/mac_shift.py).

Two MAC strategies (``mac_strategy``):

  - ``allk``: the MAC computes every bank entry's contribution for every
    voice (ops/ring_mac.py in ring mode, ops/mac_shift.py in roll mode:
    the hand-written CUDA kernels on the card) and a [V, 2]-indexed gather
    picks each voice's selection;
  - ``selected`` (banks of more than 16 IRs under 'auto'; a working set
    serves larger banks on 'allk' instead, runtime/working_set.py): each
    voice's selected spectra stay materialized in state (``sel_spectra``, the
    snapshot's layout), refreshed at collapse; the hot loop contracts the
    delay line against them per voice (per_voice_mac).

Crossfades use the affine-coefficient form (active = a*base + c*bank[sel],
the reference's slew recursion, src/conv.cu:15-32, applied to two
scalars). While every fading voice's snapshot is in the bank's SPAN
(base == sum_k base_g[k]*bank[k], provenance carried in ``base_g`` /
``base_pure``), a mid-fade block is the steady block plus a K-sized
contraction of the same MAC output (step_coef_indexed) and a re-select is a
[V, 2, K]-sized update (collapse_pure). A live bank swap mid-fade breaks
the span: the snapshot is then MATERIALIZED (materialize_base, collapse)
and fades run the general step, which contracts the delay line against
``base`` per voice. ``swap_snapshot=False`` ('allk' only) drops ``base``
altogether and keeps every fade in the span.

``mac_dtype='bf16'`` stores the delay line and the MAC tensors (``rhs2``,
``mac_rhs``, ``spectra_rev2``, ``sel_spectra``) in bfloat16: half the bytes
the MAC reads. The new block spectrum is rounded to bf16 as it enters the
line, as JAX casts it; the MAC kernels take bf16 operands and write f32
sums of exact products; the transforms, the mixing, the crossfade
coefficients and the roll mode's planar spectra and snapshot stay f32.

The per-voice contractions and span expansions are plain f32 PyTorch
(TF32 off), as they are XLA einsums in the JAX package; a bf16 operand is
upcast first (its products are exact in f32, as the JAX einsum's
preferred_element_type=float32 takes them). ``pv_mac`` picks the per-voice
MAC's form: "dot", a [2, Pp] x [Pp, 4] product per (f, v, i), or
"merged", a [4, Pp] x [Pp, 8] product per (f, v) whose i == i' diagonal is
kept (the JAX ``per_voice_mac_merged``).

Unlike the JAX engine, whose state buffers are donated to each jitted
step, the steps here update ``state.fdl`` (ring slot write or roll shift)
and ``state.wet_ring`` IN PLACE and return a new FMajorState that shares
them: the caller must treat the state it passed in as consumed. On a CUDA
device the steady ring step is replayed as one CUDA graph under the same
contract (step_coef_steady, engine/step_graph.py).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from tpu_audio_torch.engine import device_prep
from tpu_audio_torch.engine.params import VoiceParams
from tpu_audio_torch.engine.step_graph import (
    SteadyRingGraph, run_on, steady_key)
from tpu_audio_torch.ops.fft import SpectralTransform
from tpu_audio_torch.ops.mac_shift import mac_shift
from tpu_audio_torch.ops.mix import add_dry, wet_scale
from tpu_audio_torch.ops.ring_mac import ring_mac
from tpu_audio_torch.utils import diskcache
from tpu_audio_torch.utils.device import resolve_device
from tpu_audio_torch.utils.log import Log

MAC_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.bmm of two f32 or two bf16 operands, summed and returned in
    f32: the JAX per-voice MACs' preferred_element_type=float32 (bf16
    products are exact in f32). On the card bf16 operands go to cuBLAS as
    they are (out_dtype), so no f32 copy of them is made; the CPU, which
    has no such product, upcasts them."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


@dataclass
class FMajorBank:
    """Device-side bank in MAC-ready real layouts. Each mode and strategy
    reads some of the leaves; the others are size-1 placeholders, as in the
    JAX engine."""

    mac_rhs: torch.Tensor       # mac [F, 2, Pp, KOD] plane-major (roll,
                                # allk)
    rhs2: torch.Tensor          # mac [F, 2, 2*Pp, KOD] doubled+reversed
                                # (ring, allk)
    spectra: torch.Tensor       # f32 [K, O, Pp, F, 2] planar (roll)
    spectra_rev2: torch.Tensor  # mac [K, F, O, 2, 2*Pp] doubled+reversed
                                # planar (ring)
                                # (mac: the engine's mac_dtype)

    @property
    def num_irs(self) -> int:
        # one of the planar leaves is a size-1 placeholder (spectra in
        # ring mode, spectra_rev2 in roll mode) — the real one is K-major
        return max(self.spectra.shape[0], self.spectra_rev2.shape[0])


@dataclass
class FMajorState:
    fdl: torch.Tensor       # mac [F, VI, 2, Pp] planar freq delay line
    prev_in: torch.Tensor   # f32 [V, 2, B]
    wet_ring: torch.Tensor  # f32 [V, 2, NB, B] MODULAR block-slot output
                            # accumulator: slot (t + d) mod NB holds wet due
                            # d blocks from block t
    base: torch.Tensor      # fade snapshot: ring bf16 [F,V,I,O,2,2Pp],
                            # roll f32 [F,V,I,O,2,Pp]; [1]*6 placeholder
                            # when swap_snapshot=False
    coef_a: torch.Tensor    # f32 [V, 2]
    coef_c: torch.Tensor    # f32 [V, 2]
    wptr: torch.Tensor      # i32 [] block counter (mod t_modulus): drives the
                            # ring slot (t mod Pp) and wet-ring slots
    sel_spectra: torch.Tensor  # 'selected' only: mac, base's layout — each
                               # voice's selected spectra; [.,.,.,.,.,1]
                               # placeholder for 'allk'
    base_g: torch.Tensor    # f32 [V, 2, K] span coefficients of the snapshot
                            # ('allk'; [V, 2, 1] placeholder for 'selected')
    base_pure: torch.Tensor  # bool [V, 2]: the snapshot is sum_k base_g[k] *
                             # bank[k] and `base` may be stale


@dataclass
class BankSlot:
    """One IR packed for one bank slot (FMajorPartitionedConvolution.
    pack_bank_slot): the slot's 4 MAC columns and its planar spectra row,
    built on the engine's device on whatever stream was current. `done`
    (CUDA only) marks the end of that work; `host` is the pinned staging
    buffer of the upload, kept alive with the slot until it is written."""

    columns: torch.Tensor   # mac [F, 2, 2Pp, 4] (ring) or [F, 2, Pp, 4]
    row: torch.Tensor       # mac [F, O, 2, 2Pp] (ring) or f32 [O, Pp, F, 2]
    host: torch.Tensor      # f32: the 'td' IR [O, partitions * block] or
                            # the spectra payload's packed row
    done: torch.cuda.Event | None = None


def _pad_p(arr: np.ndarray, axis: int, pp: int) -> np.ndarray:
    pad = pp - arr.shape[axis]
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def pack_mac_rhs(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> [F, 2, Pp, K*O*2] f32 plane-major MAC rhs.

    Plane c=0 carries columns (br, bi) per (k, o); plane c=1 carries
    (-bi, br), so summing the two plane-dots of the (ar, ai) fdl planes
    yields the complex product-sum  sum_p X_p * H_p.
    """
    k, o, p, f = spectra.shape
    br = np.transpose(spectra.real.astype(np.float32), (3, 2, 0, 1))  # [F,P,K,O]
    bi = np.transpose(spectra.imag.astype(np.float32), (3, 2, 0, 1))
    rhs = np.empty((f, 2, p, k, o, 2), np.float32)
    rhs[:, 0, :, :, :, 0] = br
    rhs[:, 0, :, :, :, 1] = bi
    rhs[:, 1, :, :, :, 0] = -bi
    rhs[:, 1, :, :, :, 1] = br
    return _pad_p(rhs.reshape(f, 2, p, k * o * 2), 2, pp)


def double_reversed(arr: np.ndarray, axis: int) -> np.ndarray:
    """out[j] = arr[(-j) mod P], tiled twice along `axis` (one gather; call
    it on the complex spectra BEFORE packing, while the minor-side chunk is
    large — doubling the packed tensor is far slower on the host)."""
    p = arr.shape[axis]
    idx = (p - np.arange(2 * p)) % p
    return np.take(arr, idx, axis=axis)


def pack_planar_spectra(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> [K, O, Pp, F, 2] f32: the layout the roll
    mode's gathers and span expansions read."""
    planar = np.stack([spectra.real, spectra.imag], axis=-1).astype(np.float32)
    return _pad_p(planar, 2, pp)


def pack_spectra_rev2(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> f32 [K, F, O, 2, 2*Pp] doubled+reversed
    planar: the layout the ring mode's gathers and span expansions read."""
    planar = _pad_p(
        np.stack([spectra.real, spectra.imag], axis=1).astype(np.float32),
        3, pp)                                       # [K, 2, O, Pp, F]
    dbl = double_reversed(planar, axis=3)            # [K, 2, O, 2Pp, F]
    return np.ascontiguousarray(np.transpose(dbl, (0, 4, 2, 1, 3)))


def mac_planes(re_: torch.Tensor, im_: torch.Tensor) -> torch.Tensor:
    """(br, bi) as [F, q, O] -> the pack_mac_rhs column layout [F, 2, q,
    O*2]: plane c=0 carries (br, bi), c=1 carries (-bi, br). Axis moves
    and one negation, so the columns keep the row's bits in either dtype
    (the 'derived' fault payload's device rebuild)."""
    f, q = re_.shape[0], re_.shape[1]
    p0 = torch.stack([re_, im_], dim=-1).reshape(f, q, -1)
    p1 = torch.stack([-im_, re_], dim=-1).reshape(f, q, -1)
    return torch.stack([p0, p1], dim=1)


def _tensor(arr, device, dtype=None) -> torch.Tensor:
    """Copy a host array onto `device` (never a view of the host buffer).
    A bfloat16 array (a JAX bf16 leaf, an ml_dtypes type) is carried bit
    for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, dtype=dtype, device=device)


def bank_from_numpy(*, device, mac_rhs, rhs2, spectra, spectra_rev2
                    ) -> FMajorBank:
    """The port's bank from every field of a JAX FMajorBank as numpy arrays
    (``np.asarray(leaf)`` per field), placeholders included, in either mode,
    strategy and MAC dtype (bf16 leaves bit for bit)."""
    return FMajorBank(mac_rhs=_tensor(mac_rhs, device),
                      rhs2=_tensor(rhs2, device),
                      spectra=_tensor(spectra, device),
                      spectra_rev2=_tensor(spectra_rev2, device))


def state_from_numpy(*, device, fdl, prev_in, wet_ring, base, coef_a, coef_c,
                     wptr, sel_spectra, base_g, base_pure) -> FMajorState:
    """The port's state from every field of a JAX FMajorState as numpy
    arrays (``np.asarray(leaf)`` per field), in either mode, strategy and
    MAC dtype, mid-fade states with a materialized snapshot included. The
    bfloat16 leaves (the ring mode's ``base``; ``fdl`` and ``sel_spectra``
    under bf16) are carried bit for bit."""
    return FMajorState(
        fdl=_tensor(fdl, device),
        prev_in=_tensor(prev_in, device, torch.float32),
        wet_ring=_tensor(wet_ring, device, torch.float32),
        base=_tensor(base, device),
        coef_a=_tensor(coef_a, device, torch.float32),
        coef_c=_tensor(coef_c, device, torch.float32),
        wptr=_tensor(wptr, device, torch.int32).reshape(()),
        sel_spectra=_tensor(sel_spectra, device),
        base_g=_tensor(base_g, device, torch.float32),
        base_pure=_tensor(base_pure, device, torch.bool),
    )


def _bcast(vi: torch.Tensor) -> torch.Tensor:
    """[V, 2] -> [1, V, 2, 1, 1, 1], against the snapshot layout."""
    return vi[None, :, :, None, None, None]


class FMajorPartitionedConvolution:
    """V stereo voices, f-major planar partitioned-OLS, coef crossfades.

    `device`: None or "cuda" selects the best CUDA device (select_gpu,
    which raises without CUDA); "cpu" runs the plain PyTorch path."""

    ALLK_MAX_COLUMNS = 64  # K <= 16 stereo IRs ride the all-K MAC
    # (the cascade's collapse_pure takes the post-change parameters)
    collapse_pure_takes_params = False

    def __init__(self, num_voices: int, block: int, partitions: int,
                 max_predelay: int = 8192, ring: bool = True,
                 mac_strategy: str = "allk", num_irs: int | None = None,
                 mac_dtype: str = "f32", swap_snapshot: bool = True,
                 pv_mac: str = "dot", fault_upload: str = "td",
                 device=None):
        self.num_voices = num_voices
        self.block = block
        self.partitions = partitions
        # partition axis padded to a multiple of 8; extra zero partitions
        # contribute nothing
        self.pp = -(-partitions // 8) * 8
        self.max_predelay = max_predelay
        self.ring_mode = ring
        if mac_strategy == "auto":
            if num_irs is None:
                raise ValueError("mac_strategy='auto' needs num_irs")
            mac_strategy = ("allk" if num_irs * 4 <= self.ALLK_MAX_COLUMNS
                            else "selected")
        if mac_strategy not in ("allk", "selected"):
            raise ValueError(f"unknown mac_strategy {mac_strategy!r}")
        self.mac_strategy = mac_strategy
        if mac_dtype not in MAC_DTYPES:
            raise ValueError(f"unknown mac_dtype {mac_dtype!r}")
        self.mac_dtype_name = mac_dtype
        self.mac_dtype = MAC_DTYPES[mac_dtype]
        # swap_snapshot=False ('allk' only) drops the materialized fade
        # snapshot `base`, the largest state tensor; swap_bank mid-fade then
        # waits for in-flight fades to decay (StreamSession)
        if not swap_snapshot and mac_strategy != "allk":
            raise ValueError("swap_snapshot=False requires the 'allk' MAC "
                             "strategy (the 'selected' MAC reads the "
                             "materialized snapshot during fades)")
        self.swap_snapshot = swap_snapshot
        # StreamSession's fade protocol (runtime/stream.py): the span paths
        # exist for 'allk' only; 'selected' re-gathers its per-voice spectra
        self.fade_protocol = "spans" if mac_strategy == "allk" else "selected"
        if pv_mac not in ("dot", "merged"):
            raise ValueError(f"unknown pv_mac {pv_mac!r}")
        self.pv_mac = pv_mac
        # working-set fault payloads ('allk', update_bank_slot): "td" the
        # time-domain IR [O, L], transformed and packed on the device (the
        # reference's prepare() architecture, src/conv.cu:207-253);
        # "derived" host spectra [1, O, P, F], only the row packed and
        # uploaded (rev2 in ring mode, planar in roll mode), the columns
        # rebuilt from it on the device (axis moves and one negation).
        # "dual" takes the same payload and the same route: the JAX engine
        # uploads both packed layouts there, the same bits at three times
        # the bytes, so the port keeps the name and not the second upload.
        # The JAX engine defaults to "derived"; the port to "td", what its
        # model uploads by default.
        if fault_upload not in ("dual", "derived", "td"):
            raise ValueError(f"unknown fault_upload {fault_upload!r}")
        self.fault_upload = fault_upload
        self.num_irs = num_irs
        self.device = resolve_device(device)
        self.xf = SpectralTransform(2 * block)
        self.num_bins = self.xf.num_bins
        # block-slot accumulator: slots 0..maxPD//B (+1 for the sub-block
        # tail spill of the deepest predelay)
        self.ring_slots = max_predelay // block + 2
        # the block counter wraps at the lcm of every modulus derived from
        # it so the slot indices stay continuous across the wrap
        self.t_modulus = (math.lcm(self.pp, self.ring_slots) if ring
                          else self.ring_slots)
        # the steady ring step's CUDA graph (step_coef_steady): off for a
        # mesh's local engines (parallel/mesh.py), which step eagerly
        self.steady_graphs = True
        self.steady_captures = 0   # graphs captured
        self.steady_replays = 0    # steady calls that replayed one
        self.steady_eager = 0      # steady calls that did not
        self._steady_graph = None
        self._steady_warm = None   # the key whose eager first call ran
        self._graph_stream = None

    # -- offline / cloning interface ------------------------------------------------

    def with_voices(self, num_voices: int,
                    swap_snapshot: bool | None = None, device=None
                    ) -> "FMajorPartitionedConvolution":
        """Same geometry and strategy at another voice count, on this
        engine's device or on `device`. Banks are voice-independent ([K,
        ...] tensors), so a bank prepared by this engine serves the clone
        directly — the seam the offline renderer (runtime/offline.py) and
        the mesh's per-shard engines (parallel/mesh.py) build on.
        `swap_snapshot` overrides the fade snapshot for 'allk' ('selected'
        always keeps it)."""
        if swap_snapshot is None:
            swap_snapshot = self.swap_snapshot
        return FMajorPartitionedConvolution(
            num_voices, self.block, self.partitions,
            max_predelay=self.max_predelay, ring=self.ring_mode,
            mac_strategy=self.mac_strategy, num_irs=self.num_irs,
            mac_dtype=self.mac_dtype_name,
            swap_snapshot=(swap_snapshot if self.mac_strategy == "allk"
                           else True),
            pv_mac=self.pv_mac, fault_upload=self.fault_upload,
            device=self.device if device is None else device)

    @property
    def history_blocks(self) -> int:
        """Trailing input blocks that fully determine the next output block
        at converged params: the delay line's depth plus the deepest
        wet-ring deferral, with margin. Priming a fresh converged state with
        this many blocks reproduces the streamed output — the contract the
        offline renderer's segment warm-up relies on."""
        return self.pp + self.ring_slots + 2

    @property
    def prime_blocks(self) -> int:
        """Streamed warm-up depth when the delay line is primed directly
        (prime_fdl): only the wet ring still needs streaming."""
        return self.ring_slots + 2

    def input_spectra_bulk(self, xb: torch.Tensor) -> torch.Tensor:
        """Planar input spectra of a whole block tensor [T, ..., 2, B]:
        spec[t] holds _input_spectrum's values for block t (the rfft of the
        OLS pair [x_{t-1}, x_t], x_{-1} = 0), as f32 [T, ..., 2, F, 2] — one
        batched transform instead of T chained steps."""
        b = self.block
        seg = xb.new_zeros(xb.shape[:-1] + (2 * b,))
        seg[..., b:] = xb
        seg[1:, ..., :b] = xb[:-1]
        return torch.view_as_real(self.xf.rfft(seg))

    def prime_fdl(self, state: FMajorState, spec: torch.Tensor,
                  t0: torch.Tensor, voice_of: torch.Tensor | None = None
                  ) -> FMajorState:
        """Prime the delay line, IN PLACE, as if blocks [t0 - Pp, t0) had
        been streamed into a fresh state (local wptr 0): the step at local
        time 0 then processes block t0[v] with its whole input history in
        place. `spec` is input_spectra_bulk's [T, 2, F, 2] (shared program
        material) or [T, Vb, 2, F, 2] with `voice_of` [V] mapping each voice
        onto a base voice; blocks before 0 prime to zero (the
        stream-from-silence state). prev_in is the caller's to set.

        One gather of [V*Pp] rows, copied into the line through a permuted
        view: the only full-size temporary is the gathered rows."""
        pp, f, v = self.pp, self.num_bins, self.num_voices
        j = torch.arange(pp, device=spec.device)
        t0 = t0.to(spec.device, torch.long)
        if self.ring_mode:
            # at wptr 0 the MAC pairs slot j with bank partition (0 - j) mod
            # Pp, so slot j holds block t0 - Pp + j (slot 0, the j = Pp
            # alias, is overwritten by the step-0 write before the MAC reads)
            blocks = t0[:, None] - pp + j[None, :]               # [V, Pp]
        else:
            # roll mode: position j holds block t - 1 - j entering step t
            blocks = t0[:, None] - 1 - j[None, :]
        nt = spec.shape[0]
        rows = blocks.clamp(0, nt - 1)
        if voice_of is None:
            table = spec.reshape(nt, 2, f, 2)
        else:
            nb = spec.shape[1]
            table = spec.reshape(nt * nb, 2, f, 2)
            rows = rows * nb + voice_of.to(spec.device, torch.long)[:, None]
        g = table.index_select(0, rows.reshape(-1))               # [V*Pp,I,F,d]
        g.view(v, pp, -1).masked_fill_((blocks < 0)[..., None], 0.0)
        state.fdl.view(f, v, 2, 2, pp).copy_(
            g.view(v, pp, 2, f, 2).permute(3, 0, 2, 4, 1))
        return state

    # -- bank ---------------------------------------------------------------------

    def _pack_bank_host(self, spectra: np.ndarray):
        """Host [K, O, P, F] complex -> the numpy bank tensors (mac_rhs,
        rhs2, planar, rev2; None where this mode and strategy read none),
        f32. Doubling and reversal happen on the complex spectra BEFORE
        packing (see double_reversed)."""
        pp = self.pp
        mac_rhs = rhs2 = planar = rev2 = None
        if self.mac_strategy == "allk":
            if self.ring_mode:
                dbl = double_reversed(_pad_p(spectra, 2, pp), 2)
                rhs2 = pack_mac_rhs(dbl, 2 * pp)
            else:
                mac_rhs = pack_mac_rhs(spectra, pp)
        if self.ring_mode:
            rev2 = pack_spectra_rev2(spectra, pp)
        else:
            planar = pack_planar_spectra(spectra, pp)
        return mac_rhs, rhs2, planar, rev2

    def prepare_bank(self, spectra: np.ndarray,
                     cache_dir: str | os.PathLike | None = None
                     ) -> FMajorBank:
        """Host [K, 2, P, F] complex spectra -> device FMajorBank, packing
        what this mode and strategy read, in the MAC dtype (roll mode's
        planar spectra stay f32).

        cache_dir: a content-addressed disk cache of the PACKED tensors,
        ``pack_<key>`` entries keyed and stored as the JAX package stores
        them (utils/diskcache.py), so either package reads the other's."""
        spectra = np.asarray(spectra)
        if spectra.shape[2] != self.partitions or spectra.shape[3] != self.num_bins:
            raise ValueError(f"bank geometry {spectra.shape} != engine "
                             f"(P={self.partitions}, F={self.num_bins})")
        if self.num_irs is not None and spectra.shape[0] != self.num_irs:
            raise ValueError(f"bank has {spectra.shape[0]} IRs, engine was "
                             f"built for num_irs={self.num_irs} (base_g "
                             f"state is K-shaped)")
        self.num_irs = spectra.shape[0]
        fields = ("mac_rhs", "rhs2", "planar", "rev2")
        packs = base = None
        if cache_dir is not None:
            base = "pack_" + diskcache.content_key(
                "fmajor-pack", (self.pp, self.ring_mode, self.mac_strategy,
                                spectra.shape), spectra)
            hit = diskcache.load(cache_dir, base, fields)
            if hit is not None:
                Log.info("fmajor", "packed-bank cache hit: %s/%s*",
                         os.fspath(cache_dir), base)
                packs = tuple(hit[f] for f in fields)
        if packs is None:
            packs = self._pack_bank_host(spectra)
            if base is not None:
                diskcache.store(cache_dir, base, dict(zip(fields, packs)))
        mac_rhs, rhs2, planar, rev2 = packs
        dev, dt = self.device, self.mac_dtype

        def leaf(arr, ndim, dtype=dt):
            if arr is None:
                return torch.zeros((1,) * ndim, dtype=dtype, device=dev)
            return _tensor(arr, dev).to(dtype)

        return FMajorBank(mac_rhs=leaf(mac_rhs, 4), rhs2=leaf(rhs2, 4),
                          spectra=leaf(planar, 5, torch.float32),
                          spectra_rev2=leaf(rev2, 5))

    def update_bank_slot(self, bank: FMajorBank, slot: int,
                         payload: np.ndarray) -> FMajorBank:
        """Replace ONE IR slot of a device bank (working-set residency,
        runtime/working_set.py) with `payload`, of the engine's
        fault_upload kind (pack_bank_slot): the slot's columns and row are
        written IN PLACE, stream-ordered after every step already queued
        (write_bank_slot). Returns the same bank object. 'allk' only: the
        'selected' strategy materializes per-voice spectra in state, which
        a bank-slot write would silently miss."""
        return self.write_bank_slot(bank, slot, self.pack_bank_slot(payload))

    def pack_bank_slot(self, payload: np.ndarray) -> BankSlot:
        """One fault payload -> its BankSlot on the engine's device, each
        upload through a pinned buffer on CUDA, the device work on the
        current stream. Reads no bank, so it may run on a side stream while
        blocks stream.

          - 'td': the time-domain IR [O, L], zero-padded to the static
            partition grid on the host; the partition FFT, the
            double+reverse (ring) and the packs on the device;
          - 'derived' and 'dual': host spectra [1, O, P, F], only the row
            packed and uploaded (ring: rev2, roll: planar); the columns
            are rebuilt from it on the device (mac_planes), bit-equal to
            the JAX engine's 'dual' upload of both layouts."""
        self._require_allk()
        payload = np.asarray(payload)
        if self.fault_upload == "td":
            if payload.ndim != 2 or np.iscomplexobj(payload):
                raise ValueError(f"a slot update takes a time-domain [O, L] "
                                 f"IR, got {payload.dtype} {payload.shape}")
            return self._pack_slot_td(payload)
        if payload.ndim != 4 or not np.iscomplexobj(payload):
            raise ValueError(f"fault_upload={self.fault_upload!r} takes a "
                             f"spectra payload [1, O, P, F] complex, got "
                             f"{payload.dtype} {payload.shape}")
        if self.ring_mode:
            host, row = self._stage(pack_spectra_rev2(payload, self.pp)[0])
            row = row.to(self.mac_dtype)              # [F, O, 2, 2Pp]
            columns = mac_planes(row[:, :, 0].transpose(1, 2),
                                 row[:, :, 1].transpose(1, 2))
        else:                                         # row f32 [O, Pp, F, 2]
            host, row = self._stage(pack_planar_spectra(payload,
                                                        self.pp)[0])
            columns = mac_planes(row[..., 0].permute(2, 1, 0),
                                 row[..., 1].permute(2, 1, 0)
                                 ).to(self.mac_dtype)
        return self._slot(columns, row, host)

    def _stage(self, arr: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """A host array's f32 copy on the engine's device, queued through
        a pinned staging buffer on CUDA. Returns (staging buffer, device
        tensor)."""
        host = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host, host.to(self.device, non_blocking=True)

    def _slot(self, columns, row, host) -> BankSlot:
        """A BankSlot, with an event after its device work on CUDA."""
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return BankSlot(columns=columns, row=row, host=host, done=done)

    def _pack_slot_td(self, ir: np.ndarray) -> BankSlot:
        lp = self.partitions * self.block
        pad = np.zeros((ir.shape[0], lp), np.float32)
        pad[:, : min(ir.shape[1], lp)] = ir[:, :lp]
        host, td = self._stage(pad)
        spec = device_prep.pad_parts(
            device_prep.partition_fd(td[None], self.block, self.partitions,
                                     0, self.xf), self.pp)   # [1, O, Pp, F]
        dt = self.mac_dtype
        if self.ring_mode:
            dbl = device_prep.double_reversed_j(spec, axis=2)
            columns = device_prep.pack_mac_rhs_j(dbl).to(dt)
            row = device_prep.pack_rev2_j(dbl)[0].to(dt)
        else:
            columns = device_prep.pack_mac_rhs_j(spec).to(dt)
            row = device_prep.pack_planar_j(spec)[0]
        return self._slot(columns, row, host)

    def _require_allk(self) -> None:
        if self.mac_strategy != "allk":
            raise ValueError("working-set slot updates require the 'allk' "
                             "MAC strategy (mac_strategy='selected' copies "
                             "spectra into state at collapse)")

    def write_bank_slot(self, bank: FMajorBank, slot: int,
                        packed: BankSlot, device: torch.device | None = None
                        ) -> FMajorBank:
        """Write a packed slot into `bank` in place on the current stream:
        ring mode rhs2[..., 4k:4k+4] and spectra_rev2[k], roll mode
        mac_rhs[..., 4k:4k+4] and spectra[k]. On CUDA the current stream
        first waits for the stream that packed the slot, and the packed
        tensors are marked in use by this stream so that their memory is
        not handed out again before the copies ran. `device` is the bank's
        (default the engine's): its current stream takes the copies."""
        self._require_allk()
        col0 = 4 * int(slot)
        if self.ring_mode:
            columns, rows = bank.rhs2, bank.spectra_rev2
        else:
            columns, rows = bank.mac_rhs, bank.spectra
        device = self.device if device is None else device
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            if packed.done is not None:
                stream.wait_event(packed.done)
            for t in (packed.columns, packed.row):
                t.record_stream(stream)
        columns[..., col0: col0 + 4].copy_(packed.columns)
        rows[int(slot)].copy_(packed.row)
        return bank

    # -- state ---------------------------------------------------------------------

    def _base_shape(self):
        v, f, pp = self.num_voices, self.num_bins, self.pp
        if not self.swap_snapshot:
            return (1, 1, 1, 1, 1, 1), torch.float32  # span-only: no snapshot
        if self.ring_mode:
            return (f, v, 2, 2, 2, 2 * pp), torch.bfloat16
        return (f, v, 2, 2, 2, pp), torch.float32

    def _sel_shape(self):
        v, f, pp = self.num_voices, self.num_bins, self.pp
        if self.mac_strategy != "selected":
            return (f, v, 2, 2, 2, 1)
        return (f, v, 2, 2, 2, 2 * pp if self.ring_mode else pp)

    def _base_g_width(self) -> int:
        if self.mac_strategy != "allk":
            return 1  # 'selected' never re-enters the span; placeholder
        if self.num_irs is None:
            raise ValueError("the 'allk' strategy's base_g provenance is "
                             "bank-sized; pass num_irs= to the constructor "
                             "or call prepare_bank before init_state")
        return self.num_irs

    def init_state(self) -> FMajorState:
        v, b, pp, f = self.num_voices, self.block, self.pp, self.num_bins
        base_shape, base_dtype = self._base_shape()

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return FMajorState(
            fdl=zeros(f, v * 2, 2, pp, dtype=self.mac_dtype),
            prev_in=zeros(v, 2, b),
            wet_ring=zeros(v, 2, self.ring_slots, b),
            base=zeros(*base_shape, dtype=base_dtype),
            coef_a=zeros(v, 2),
            coef_c=zeros(v, 2),
            wptr=zeros(dtype=torch.int32),
            sel_spectra=zeros(*self._sel_shape(), dtype=self.mac_dtype),
            base_g=zeros(v, 2, self._base_g_width()),  # the zero snapshot
            base_pure=torch.ones((v, 2), dtype=torch.bool, device=self.device),
        )

    def init_converged(self, bank: FMajorBank, params: VoiceParams
                       ) -> FMajorState:
        state = self.init_state()
        state = replace(state, coef_c=params.wet.to(torch.float32).clone())
        if self.mac_strategy == "selected":
            state = replace(state, sel_spectra=self._gather_selection(
                bank, params.select))
        return state

    def _gather_selection(self, bank: FMajorBank, select: torch.Tensor
                          ) -> torch.Tensor:
        """Per-voice selected spectra in the snapshot layout
        [F, V, I, O, 2, (2)Pp], in the MAC dtype (sel_spectra's)."""
        v = self.num_voices
        idx = select.reshape(-1).long()
        if self.ring_mode:
            g = bank.spectra_rev2.index_select(0, idx)     # [VI, F, O, e, 2Pp]
            g = g.reshape(v, 2, *g.shape[1:]).permute(2, 0, 1, 3, 4, 5)
        else:
            g = bank.spectra.index_select(0, idx)          # [VI, O, Pp, F, d]
            g = g.reshape(v, 2, *g.shape[1:]).permute(4, 0, 1, 2, 5, 3)
        return g.to(self.mac_dtype).contiguous()

    def regather_selection(self, state: FMajorState, bank: FMajorBank,
                           select: torch.Tensor) -> FMajorState:
        """Re-point the materialized per-voice spectra at a (new) bank —
        the live bank-swap path (StreamSession._apply_pending_bank)."""
        return replace(state,
                       sel_spectra=self._gather_selection(bank, select))

    def _span_expand(self, bank: FMajorBank, g: torch.Tensor) -> torch.Tensor:
        """Materialize span-represented snapshots, sum_k g[v,i,k] * bank[k],
        in the snapshot layout [F, V, I, O, 2, (2)Pp], f32 (rare path:
        collapse and bank swaps only)."""
        v, k = self.num_voices, g.shape[-1]
        leaf = bank.spectra_rev2 if self.ring_mode else bank.spectra
        out = torch.matmul(g.reshape(v * 2, k), leaf.reshape(k, -1).float())
        out = out.reshape(v, 2, *leaf.shape[1:])
        if self.ring_mode:
            return out.permute(2, 0, 1, 3, 4, 5)           # from [V,I,F,O,e,2Pp]
        return out.permute(4, 0, 1, 2, 5, 3)               # from [V,I,O,Pp,F,d]

    # -- hot step -------------------------------------------------------------------

    def _input_spectrum(self, state: FMajorState, x: torch.Tensor
                        ) -> torch.Tensor:
        """OLS segment rfft -> planar [F, VI, 2, 1] in the MAC dtype
        (contiguous)."""
        seg = torch.cat([state.prev_in, x], dim=-1)               # [V, 2, 2B]
        spec = self.xf.rfft(seg)                                  # [V, 2, F]
        xn = torch.stack([spec.real, spec.imag], dim=-1)          # [V, 2, F, 2]
        return xn.reshape(self.num_voices * 2, self.num_bins, 2
                          ).permute(1, 0, 2)[..., None].to(
                              self.mac_dtype).contiguous()

    def _window(self, arr: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The last axis' MAC window of a snapshot-layout tensor, rounded to
        the MAC dtype (as JAX casts it: roll mode's f32 snapshot under
        bf16). Ring: rows [Pp - w, 2Pp - w) of the doubled,
        reversed tensor, w = t mod Pp taken on the device (index_select: no
        host read of the block counter, no sync); roll: the tensor itself
        (natural order)."""
        if self.ring_mode:
            pp = self.pp
            idx = (pp - t.long() % pp) + torch.arange(pp, device=arr.device)
            arr = arr.index_select(5, idx.reshape(-1))
        return arr.to(self.mac_dtype)

    def _per_voice_mac(self, fdl: torch.Tensor, spectra: torch.Tensor
                       ) -> torch.Tensor:
        """fdl against one per-voice spectra window [F, V, I, O, 2, Pp],
        both in the MAC dtype, products summed in f32 (bmm_f32) -> complex
        products [F, V, I, O, 2]. 'dot': a
        batched [2, Pp] x [Pp, 4] matvec per (f, v, i) (one voice, one
        rhs); 'merged': a [4, Pp] x [Pp, 8] product per (f, v), (i, c) on
        its rows and (i', o, e) on its columns, of which the i == i'
        diagonal is kept (twice the FLOPs, half the products). Sized by
        `fdl`, so it also runs on one partition shard's slice."""
        f, vi, _, pp = fdl.shape
        v = vi // 2
        if self.pv_mac == "merged":
            lhs = fdl.reshape(f * v, 4, pp)                       # [B, ic, p]
            rhs = spectra.reshape(f * v, 8, pp)                   # [B, i'oe, p]
            prod = bmm_f32(lhs, rhs.transpose(1, 2)).reshape(
                f, v, 2, 2, 2, 2, 2)                              # [F,V,i,c,i',o,e]
            mb = torch.diagonal(prod, dim1=2, dim2=4).permute(
                0, 1, 5, 2, 3, 4)                                 # [F,V,i,c,o,e]
        else:
            lhs = fdl.reshape(f * v * 2, 2, pp)                   # [B, c, p]
            rhs = spectra.reshape(f * v * 2, 4, pp)               # [B, oe, p]
            mb = bmm_f32(lhs, rhs.transpose(1, 2)).reshape(f, v, 2, 2, 2, 2)
        yre = mb[..., 0, :, 0] - mb[..., 1, :, 1]                 # [F,V,I,O]
        yim = mb[..., 0, :, 1] + mb[..., 1, :, 0]
        return torch.stack([yre, yim], dim=-1)

    def _finish(self, state, params, x, y, t, **updates):
        """y [F, V, O, 2] planar spectra -> predelayed wet -> ring -> mix.

        Per-voice predelay pd = q*B + r: the sub-block part r rides the
        inverse transform as a spectral phase ramp (a circular shift of the
        length-2B segment, whose wrap region carries the split-off tail) and
        the block part q picks the wet-ring slots (t + q) mod NB and
        (t + q + 1) mod NB, added in place. Channel 0's predelay feeds both
        outputs (reference src/conv.cu:411-415). The emit slot t mod NB is
        read, then zeroed in place."""
        b, v = self.block, self.num_voices
        n2 = 2 * b
        pd = params.predelay[:, 0].long()                          # [V]
        q = pd // b
        r = pd % b

        # phase ramp e^{-i 2 pi f r / N}: planar rotation of y
        ang = (2.0 * math.pi / n2) * (
            torch.arange(self.num_bins, dtype=torch.float32,
                         device=y.device)[:, None]
            * r.to(torch.float32)[None, :])                       # [F, V]
        c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        yre, yim = y[..., 0], y[..., 1]
        spec = torch.complex(yre * c + yim * s, yim * c - yre * s)
        ys = self.xf.irfft(spec.permute(1, 2, 0))                 # [V, O, 2B]

        # circular shift: ys[..., B:] offset j holds wet[j - r] for j >= r;
        # ys[..., :B] offset j < r holds the tail wet[B - r + j]
        offs = torch.arange(b, device=y.device)[None, None, :]
        rr = r[:, None, None]
        part_main = torch.where(offs >= rr, ys[..., b:], 0.0)
        part_tail = torch.where(offs < rr, ys[..., :b], 0.0)

        ring = state.wet_ring
        nb = ring.shape[2]
        voices = torch.arange(v, device=y.device)
        tl = t.long()
        ring[voices, :, (tl + q) % nb] += part_main
        ring[voices, :, (tl + q + 1) % nb] += part_tail
        emit = (tl % nb).reshape(1)
        wet_now = ring.index_select(2, emit)[:, :, 0]             # [V, 2, B]
        ring.index_fill_(2, emit, 0.0)

        out = add_dry(torch.clamp(wet_now, -1.0, 1.0), x, params)
        return replace(state, prev_in=x, **updates), out

    def step_coef(self, state: FMajorState, bank: FMajorBank,
                  params: VoiceParams, x: torch.Tensor,
                  with_base: bool = True, indexed_base: bool = False):
        """One block, fade-capable: write the input spectrum into the
        delay line (ring slot t mod Pp, or the roll shift), run the MAC,
        add the fade term. ``with_base`` without ``indexed_base`` is the
        general fade, which reads the materialized snapshot ``base``;
        ``indexed_base`` ('allk') takes the span-represented fade term from
        the same all-K MAC output.

        The step is the composition of two stages, the seam of the mesh's
        part axis (parallel/mesh.py): mac_stage, linear in the partitions,
        and finish_stage, which reads only their sums."""
        if with_base and not indexed_base and not self.swap_snapshot:
            raise ValueError(
                "engine was built with swap_snapshot=False: there is no "
                "materialized fade snapshot to read — fades ride "
                "step_coef_indexed (span provenance)")
        xn = self._input_spectrum(state, x)                       # [F, VI, 2, 1]
        sums = self.mac_stage(state.fdl, bank, xn, state.wptr,
                              state.sel_spectra, state.base,
                              with_base=with_base and not indexed_base)
        return self.finish_stage(state, params, x, sums,
                                 indexed_base=indexed_base)

    def mac_stage(self, fdl: torch.Tensor, bank: FMajorBank,
                  xn: torch.Tensor, t, sel_spectra: torch.Tensor,
                  base: torch.Tensor, with_base: bool):
        """Stage 1 of a step: write the new column `xn` [F, VI, 2, 1] into
        the line `fdl` IN PLACE (ring slot t mod Pp, or the roll shift)
        and return its sums over the line's partitions: (m [F, VI, KOD],
        the all-K MAC ('allk'); y_sel [F, V, I, O, 2], the selected
        products ('selected'); y_base, the materialized snapshot's
        products (``with_base``)), None where not computed.

        Every term is a sum over partitions, so a roll-mode line split
        over partition shards runs this stage on each shard (its `fdl`,
        `sel_spectra`, `base` and bank the shard's partitions, `xn` the
        previous shard's last column) and the shards' sums add up; `t` is
        read in ring mode only."""
        allk = self.mac_strategy == "allk"
        m = y_sel = y_base = None
        if self.ring_mode:
            fdl.index_copy_(3, (t.long() % fdl.shape[3]).reshape(1), xn)
            if allk:  # all-K MAC: [F, VI, 2Pp] x window [F, 2Pp, KOD]
                m = ring_mac(t, fdl, bank.rhs2)
        elif allk:  # the shift and the all-K MAC in one pass
            _, m = mac_shift(fdl, xn, bank.mac_rhs)
        else:  # 'selected' has no all-K MAC: shift alone
            fdl.copy_(torch.cat([xn, fdl[..., :-1]], dim=-1))
        if not allk:
            y_sel = self._per_voice_mac(fdl, self._window(sel_spectra, t))
        if with_base:
            y_base = self._per_voice_mac(fdl, self._window(base, t))
        return m, y_sel, y_base

    def finish_stage(self, state: FMajorState, params: VoiceParams,
                     x: torch.Tensor, sums, indexed_base: bool = False):
        """Stage 2 of a step, on mac_stage's sums: the coefficient slew,
        the gather of each voice's selection and the span fade term from
        the all-K MAC (``indexed_base``), the mix of the terms, and
        _finish. Reads no partition-sized tensor."""
        m, y_sel, y_base = sums
        f, v = self.num_bins, self.num_voices
        t = state.wptr  # block counter (mod t_modulus), device int32
        r = 1.0 / (params.vsteps.to(torch.float32) + 5.0)
        a = state.coef_a * (1.0 - r)
        c = state.coef_c * (1.0 - r) + params.wet * r
        scale = wet_scale(params)                                 # [V, I, O]
        coef_sel = c[..., None] * scale

        if m is not None:
            k = m.shape[2] // 4
            m = m.reshape(f, v, 2, k, 2, 2)                       # [F,V,I,K,O,d]
            sel = params.select.long()[None, :, :, None, None, None]
            y_sel = torch.gather(m, 3, sel.expand(f, v, 2, 1, 2, 2))[:, :, :, 0]
            if indexed_base:
                # span snapshot: base == sum_k base_g[k] * bank[k], so the
                # base term is linear in the SAME all-K products m
                y_base = torch.einsum("fvikod,vik->fviod", m, state.base_g)
        y = torch.einsum("fviod,vio->fvod", y_sel, coef_sel)
        if y_base is not None:
            y = y + torch.einsum("fviod,vio->fvod", y_base,
                                 a[..., None] * scale)

        wptr_next = torch.remainder(t + 1, self.t_modulus).to(torch.int32)
        return self._finish(state, params, x, y, t, fdl=state.fdl, coef_a=a,
                            coef_c=c, wptr=wptr_next)

    def step_coef_steady(self, state, bank, params, x):
        """Steady-state hot path: base term elided (coef_a ~ 0).

        On a CUDA device in ring mode under 'allk' (outside a mesh:
        ``steady_graphs``) the step is one CUDA graph
        (engine/step_graph.py), bound to the state's ``fdl`` and
        ``wet_ring`` and the bank's ``rhs2``: the first call on a set of
        them runs eagerly on the capture stream, the next captures and
        replays, every later one replays. A new set (a fresh or restored
        state, another bank) releases the old capture. The outputs, the
        in-place updates and the fresh leaves are the eager step's."""
        if not (self.steady_graphs and x.is_cuda and self.ring_mode
                and self.mac_strategy == "allk"):
            self.steady_eager += 1
            return self._step_steady(state, bank, params, x)
        key = steady_key(state, bank, x)
        graph = self._steady_graph
        if graph is not None and graph.key == key:
            self.steady_replays += 1
            return graph.run(state, params, x)
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if self._steady_warm != key:
            self._steady_warm = key
            self.steady_eager += 1
            return run_on(self._graph_stream, self._step_steady, state, bank,
                          params, x)
        # release the old capture once nothing of it is in flight (the
        # capture synchronizes anyway)
        torch.cuda.synchronize(self.device)
        del graph
        self._steady_graph = None
        graph = self._steady_graph = SteadyRingGraph(
            self._step_steady, state, bank, params, x, self._graph_stream)
        self.steady_captures += 1
        self.steady_replays += 1
        Log.info("fmajor", "captured the steady ring step as a CUDA graph "
                 "(%d voices, %s; capture %d)", self.num_voices,
                 self.mac_dtype_name, self.steady_captures)
        return graph.run(state, params, x)

    def _step_steady(self, state, bank, params, x):
        return self.step_coef(state, bank, params, x, with_base=False)

    def step_coef_indexed(self, state, bank, params, x):
        """The crossfading step: every fading voice's snapshot is
        span-represented, base == sum_k state.base_g[k] * bank[k], so a
        mid-fade block costs the steady block plus a K-sized contraction of
        the same MAC output."""
        if self.mac_strategy != "allk":
            raise ValueError("indexed fade requires the 'allk' MAC strategy")
        return self.step_coef(state, bank, params, x, with_base=False,
                              indexed_base=True)

    # -- rare path ---------------------------------------------------------------------

    def _effective_base(self, state: FMajorState, bank: FMajorBank
                        ) -> torch.Tensor:
        """The snapshot every voice really has, in f32: the span expansion
        where base_pure, the stored `base` elsewhere. 'selected' span
        provenance only ever holds the zero snapshot."""
        pure = _bcast(state.base_pure)
        stored = state.base.float()
        if self.mac_strategy == "selected":
            return torch.where(pure, 0.0, stored)
        return torch.where(pure, self._span_expand(bank, state.base_g), stored)

    def collapse(self, state: FMajorState, bank: FMajorBank,
                 old_select: torch.Tensor, changed: torch.Tensor,
                 new_select: torch.Tensor | None = None,
                 params: VoiceParams | None = None) -> FMajorState:
        """Re-base the affine form after an IR re-select, MATERIALIZING the
        snapshot: base := a*base_eff + c*bank[old] for changed voices, and
        base := base_eff for the others (virtual snapshots are materialized
        for everyone, so the general step may read `base` afterwards). The
        'selected' strategy also re-gathers the per-voice selected spectra
        (pass `new_select`, the post-change selection). `params` is taken
        for the cascade's signature and not read."""
        if not self.swap_snapshot:
            raise ValueError(
                "engine was built with swap_snapshot=False: snapshots "
                "cannot materialize — collapse in the span (collapse_pure) "
                "and defer bank swaps until fades decay")
        if self.mac_strategy == "selected":
            if new_select is None:
                raise ValueError("'selected' strategy collapse needs new_select")
            gathered = state.sel_spectra.float()
        else:
            gathered = self._gather_selection(bank, old_select).float()
        base_eff = self._effective_base(state, bank)
        collapsed = (_bcast(state.coef_a) * base_eff
                     + _bcast(state.coef_c) * gathered)
        mask = _bcast(changed)
        state = replace(
            state,
            base=torch.where(mask, collapsed, base_eff).to(state.base.dtype),
            base_pure=torch.zeros_like(state.base_pure),
            coef_a=torch.where(changed, 1.0, state.coef_a),
            coef_c=torch.where(changed, 0.0, state.coef_c),
        )
        if self.mac_strategy == "selected":
            fresh = self._gather_selection(bank, new_select)
            state = replace(state, sel_spectra=torch.where(
                mask, fresh, state.sel_spectra))
        return state

    def materialize_base(self, state: FMajorState, bank: FMajorBank
                         ) -> FMajorState:
        """Materialize virtual (span-provenance) snapshots WITHOUT any
        re-select: base := base_eff, purity cleared, coefficients and
        selection untouched — collapse(..., changed=all-False) without the
        re-select gathers (the session's bank-swap and run-start paths)."""
        if not self.swap_snapshot:
            raise ValueError(
                "engine was built with swap_snapshot=False: snapshots "
                "cannot materialize — defer bank swaps until fades decay")
        base = self._effective_base(state, bank).to(state.base.dtype)
        return replace(state, base=base,
                       base_pure=torch.zeros_like(state.base_pure))

    def collapse_pure(self, state: FMajorState, old_select: torch.Tensor,
                      changed: torch.Tensor) -> FMajorState:
        """Span collapse ('allk'): the affine re-base base := a*base +
        c*bank[old] applied to the span coefficients, base_g := a*base_g +
        c*onehot(old) — exact for any changed voice whose snapshot was
        span-represented, converged or mid-fade alike. A changed voice that
        was not pure must have converged (a ~ 0, host-checked): its stale
        base_g is dropped and the span restarts at c*onehot(old)."""
        if self.mac_strategy != "allk":
            raise ValueError("span collapse requires the 'allk' MAC strategy")
        k = state.base_g.shape[-1]
        oh = torch.nn.functional.one_hot(old_select.long(), k
                                         ).to(torch.float32)       # [V, 2, K]
        prev = torch.where(state.base_pure[..., None], state.base_g, 0.0)
        g = state.coef_a[..., None] * prev + state.coef_c[..., None] * oh
        return replace(
            state,
            base_g=torch.where(changed[..., None], g, state.base_g),
            base_pure=changed | state.base_pure,
            coef_a=torch.where(changed, 1.0, state.coef_a),
            coef_c=torch.where(changed, 0.0, state.coef_c),
        )


def make_chunk_step(engine, steady: bool = False, indexed: bool = False):
    """Multi-block step (port of tpu_audio/engine/fmajor.py:make_chunk_step):
    run a coefficient engine's step over a [T, V, 2, B] chunk uploaded once.

    Works with any engine whose fade protocol is not "slew" (fmajor in
    either mode, strategy and MAC dtype; the cascade; partitioned 'coef'):
    the steady step with ``steady=True``, the span-indexed fade step with
    ``indexed=True`` ('allk'), else the general fade step. Within a chunk
    the parameters are frozen except the crossfade countdown: block i gets
    ``vsteps = max(params.vsteps - i, 0)``, computed on the device, as the
    JAX scan body and the host's per-block countdown do. Each step launches
    its MAC kernel (ring_mac or mac_shift) exactly as a per-block step does.

    The returned ``chunk_step(state, bank, params, xs, blocks=None)`` is a
    Python loop of ``blocks`` step calls (default T) writing one
    preallocated [T, V, 2, B] output; rows past ``blocks`` (a partial
    chunk's zero pad) are neither rendered nor written. The chunk is not
    captured as one CUDA graph (ROADMAP Queue 4 item 8b): the host calls
    every step as a per-block session does, and the steady ring step
    replays its own graph (step_coef_steady). The steps update the
    state in place: the state passed in is consumed, and each block's input
    is a view of ``xs``, which the state keeps as ``prev_in``, so ``xs``
    must not be written afterwards."""
    if engine.fade_protocol == "slew":
        raise ValueError(f"{type(engine).__name__} slews its own spectra "
                         f"(fade protocol 'slew'): it has no coefficient "
                         f"step to run in chunks")
    if indexed:
        step = engine.step_coef_indexed
    else:
        step = engine.step_coef_steady if steady else engine.step_coef

    def chunk_step(state, bank, params, xs, blocks=None):
        n = xs.shape[0] if blocks is None else blocks
        outs = torch.empty_like(xs)
        for i in range(n):
            p_i = params if i == 0 else replace(
                params, vsteps=torch.clamp_min(params.vsteps - i, 0))
            state, out = step(state, bank, p_i, xs[i])
            outs[i].copy_(out)
        return state, outs

    return chunk_step

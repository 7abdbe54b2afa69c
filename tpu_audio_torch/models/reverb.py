"""Reverb models: engine + bank + control plane bundles (port of
tpu_audio/models/reverb.py).

``ConvolutionReverb`` matches the reference's application wiring
(reference src/main.cu:18-116: settings -> IR bank -> Convolution instance
-> control mapping -> stream), batched over V stereo voices on one engine
(FMajorPartitionedConvolution, CascadeConvolution for voice scaling,
PartitionedConvolution, or the reference's own MonolithicConvolution) and
one shared device bank. With ``bank_capacity=N`` the device holds only N IR
slots and a working set (runtime/working_set.py) pages IRs of the full bank
in on demand. ``render_offline`` bounces a whole track time-parallel
(runtime/offline.py). ``MultiVoiceReverbServer`` is the 64-voice fmajor
model; ``ReverbGroups`` serves a settings file whose conv pairs differ, one
batched model per distinct pair geometry, their outputs summed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_audio_torch.engine import device_prep
from tpu_audio_torch.engine.bank import IRBank
from tpu_audio_torch.engine.cascade import CascadeConvolution
from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio_torch.engine.monolithic import MonolithicConvolution
from tpu_audio_torch.engine.params import CC_MAX_SPEED, CCMapping, ControlPlane
from tpu_audio_torch.engine.partitioned import PartitionedConvolution
from tpu_audio_torch.io.settings import Settings
from tpu_audio_torch.parallel.mesh import ShardedBank
from tpu_audio_torch.runtime.backends import (
    BlockSink, BlockSource, CallbackSink, WavSource,
)
from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession
from tpu_audio_torch.utils.device import resolve_device
from tpu_audio_torch.utils.log import Log


def _fit_cascade_ratio(requested: int, num_voices: int, partitions: int) -> int:
    """Largest valid stagger ratio <= requested: the cascade engine needs
    `num_voices % ratio == 0` (one voice group's tail chunk per block) and
    `partitions > 2*ratio` (the head must not swallow the whole IR)."""
    for ratio in range(min(requested, num_voices, (partitions - 1) // 2), 1, -1):
        if num_voices % ratio == 0:
            return ratio
    raise ValueError(
        f"no cascade stagger ratio >= 2 fits voices={num_voices}, "
        f"IR partitions={partitions}; use engine='fmajor' (short IRs or "
        f"awkward voice counts don't benefit from the cascade)")


def pair_geometry_keys(settings: Settings, root: str | None) -> list[tuple]:
    """One engine-geometry key per conv pair: (fftSize, maxPredelay,
    index0, index1). The reference builds count/2 independent instances,
    each with its own geometry (src/main.cu:31-39, paired fftSizes asserted
    equal at main.cu:36); one batched ConvolutionReverb serves a file whose
    keys are all equal, ReverbGroups one whose keys differ."""
    count = settings.u32("conv.count", default=2)
    if count % 2:
        raise ValueError("conv.count must be a multiple of 2 (main.cu:26)")
    keys = []
    for n in range(count // 2):
        fft = settings.u32("conv[%d].fftSize", 2 * n, default=131072)
        fft2 = settings.u32("conv[%d].fftSize", 2 * n + 1, default=fft)
        if fft != fft2:
            raise ValueError(f"convolution pair {n} needs identical fft "
                             f"sizes (main.cu:36): {fft} != {fft2}")
        max_pd = settings.u32("conv[%d].maxPredelay", 2 * n, default=8192)
        keys.append((fft, max_pd, _resolve_index(settings, 2 * n, root),
                     _resolve_index(settings, 2 * n + 1, root)))
    return keys


def _resolve_index(settings: Settings, idx_ch: int,
                   root: str | None) -> str:
    """conv[idx_ch].index resolved against `root` when not found as-is
    (reference indices list repo-root-relative paths, src/main.cu:72)."""
    index = settings.str("conv[%d].index", idx_ch, default="")
    if index and root and not os.path.exists(index):
        candidate = os.path.join(root, index)
        if os.path.exists(candidate):
            index = candidate
    return index


def _merged_bank(index0: str, index1: str, root, max_ir_seconds,
                 verbose, sample_rate: int = 44100) -> tuple:
    """A conv pair's bank + per-channel select windows: differing index
    files concatenate along the bank axis and each channel addresses its
    own window (the reference shares one map and lets channel 1 overwrite
    channel 0, src/main.cu:72-81). IRs recorded at another rate than the
    session's are resampled on load."""
    bank = (IRBank.from_index(index0, root=root, verbose=verbose,
                              max_seconds=max_ir_seconds,
                              sample_rate=sample_rate)
            if index0 else IRBank(sample_rate=sample_rate))
    windows = [(0, len(bank))]
    if index1 and index1 != index0:
        bank1 = IRBank.from_index(index1, root=root, verbose=verbose,
                                  max_seconds=max_ir_seconds,
                                  sample_rate=sample_rate)
        offset = bank.extend(bank1)
        windows = [(0, offset), (offset, len(bank1))]
    return bank, windows


def _host_spectra(bank, block: int, partitions: int, cache_dir):
    """The bank's [K, 2, P, F] partition spectra on the host, through its
    disk cache when `cache_dir` is given."""
    if cache_dir:
        return bank.cached_partitioned_spectra(block, cache_dir,
                                               max_partitions=partitions)
    return bank.partitioned_spectra(block, max_partitions=partitions)


def _sub_bank(bank, members) -> IRBank:
    """An IRBank of `bank`'s IRs `members`, in that order."""
    sub = IRBank(sample_rate=bank.sample_rate)
    for k in members:
        sub.append(bank.ir(k))
    return sub


class ConvolutionReverb:
    """V stereo voices of convolution reverb over one IR bank.

    `device`: None or "cuda" selects the best CUDA device (select_gpu,
    which raises without CUDA); "cpu" runs the plain PyTorch path.

    `bank_prep` says where the fmajor and cascade banks are prepared.
    "device" (their default) uploads the time-domain IRs as float32 and
    computes spectra and packs on the engine's device (engine/device_prep.py, the reference's prepare()
    architecture, src/conv.cu:207-253). "host" computes the spectra and
    packs in numpy and uploads the packed tensors, bit-identical to the
    JAX package's host prep. The JAX model defaults to "host"; the port
    keeps "device", the faster route on a card. The other engines always
    prepare on the host (None resolves to "host" there; "device" raises,
    as in JAX).

    `bank_capacity=N` keeps N resident IR slots on the 'allk' MAC and pages
    the rest of the bank in on demand (runtime/working_set.py), with
    `async_paging` and `ws_exhausted` ("defer" or "raise"). Each fmajor
    fault uploads the payload `fault_upload` names (the engine's
    update_bank_slot): "td", the time-domain IR, transformed on the
    device; "derived", host spectra, the packed row only, the MAC columns
    rebuilt from it on the device; "dual", JAX's upload of both packed
    layouts, takes the same route here (the same bits). None resolves as in JAX: "td" under device prep,
    "derived" under host prep, "dual" (inert) for the other engines, where
    any other payload raises; device prep takes "td" only (a spectra
    payload would run the host FFT over the whole bank), and host prep
    with "td" warns that the bank mixes host- and device-FFT slots. The
    port's resolved default is therefore "td" where JAX's is "derived".
    The cascade's faults always upload the time-domain IR.

    `engine="cascade"` builds the two-stage engine (engine/cascade.py)
    with the largest stagger ratio <= `cascade_ratio` that the voice count
    and the IR length allow, and its `predelay_side` and `tail_mac`.

    `engine="partitioned"` builds PartitionedConvolution in its `variant`
    ("coef" or "materialized"), `engine="monolithic"` the reference's
    MonolithicConvolution at `fft_size`, its IRs truncated to fft_size -
    max(block, min(1024, fft_size // 8)). Their spectra are computed on the
    host (numpy) and uploaded; they take no `bank_capacity`.

    `cache_dir` keeps host-computed spectra in a content-addressed disk
    cache (IRBank.cached_partitioned_spectra), shared with the JAX
    package: the partitioned engine's always, and under host prep the
    fmajor and cascade spectra and their packed banks too (`pack_*` and
    `cascpack_*` entries, engine prepare_bank). Device prep and the
    monolithic engine (as in JAX) compute their banks without it: a
    `cache_dir` there is accepted and has no effect."""

    def __init__(self, bank: IRBank, num_voices: int = 1, block: int = 256,
                 sample_rate: int = 44100, engine: str = "fmajor",
                 variant: str = "coef", fft_size: int = 131072,
                 max_predelay: int = 8192,
                 max_partitions: int | None = None,
                 mac_strategy: str = "auto", mac_dtype: str = "f32",
                 swap_snapshot: bool = True, cascade_ratio: int = 16,
                 predelay_side: str = "write", tail_mac: str = "auto",
                 bank_capacity: int | None = None,
                 async_paging: bool = False, ws_exhausted: str = "defer",
                 cache_dir: str | os.PathLike | None = None,
                 bank_prep: str | None = None,
                 fault_upload: str | None = None, device=None):
        if engine not in ("fmajor", "cascade", "partitioned", "monolithic"):
            raise ValueError(f"unknown engine {engine!r}")
        if bank_capacity is not None and engine not in ("fmajor", "cascade"):
            raise ValueError(f"bank_capacity (working-set residency) needs "
                             f"engine 'fmajor' or 'cascade', not {engine!r}")
        prepped = engine in ("fmajor", "cascade")
        if bank_prep is None:
            bank_prep = "device" if prepped else "host"
        if bank_prep not in ("host", "device"):
            raise ValueError(f"unknown bank_prep {bank_prep!r}")
        if bank_prep == "device" and not prepped:
            raise ValueError(f"bank_prep='device' covers the fmajor and "
                             f"cascade engines, not {engine!r}")
        self.bank_prep = bank_prep
        if fault_upload is None:
            if engine == "fmajor":
                fault_upload = "td" if bank_prep == "device" else "derived"
            else:
                fault_upload = "dual"
        if fault_upload != "dual" and engine != "fmajor":
            # never silently ignore: the flag is inert on these engines
            # (cascade faults upload raw samples already)
            raise ValueError(
                f"fault_upload={fault_upload!r} applies to the fmajor "
                f"engine's working-set faults; engine {engine!r} has "
                f"nothing to derive (cascade faults upload raw samples "
                f"already)")
        self.fault_upload = fault_upload
        self.bank = bank
        self.block = block
        self.sample_rate = sample_rate
        if getattr(bank, "sample_rate", sample_rate) != sample_rate:
            Log.warn("reverb", "bank sample rate %d != session rate %d: "
                     "IRs will play %.1f%% off — load the bank with "
                     "sample_rate=%d to resample",
                     bank.sample_rate, sample_rate,
                     abs(1 - bank.sample_rate / sample_rate) * 100,
                     sample_rate)
        self.device = resolve_device(device)
        if cache_dir and (engine == "monolithic" or bank_prep == "device"):
            Log.info("reverb", "cache_dir %s: no effect on engine %r with "
                     "bank_prep=%r (host-computed spectra and packs are "
                     "cached)", os.fspath(cache_dir), engine, bank_prep)
        self.control = ControlPlane(num_voices, len(bank), max_predelay,
                                    device=self.device)
        self.working_set = None
        self._offline_counters: dict = {}
        partitions = max_partitions or bank.max_partitions(block)
        if bank_capacity is not None:
            capacity = min(bank_capacity, len(bank))
            if engine == "cascade":
                # residency is defined over the all-K MAC's bank slots
                self.engine = self._cascade(
                    num_voices, block, partitions, cascade_ratio,
                    max_predelay, capacity, mac_dtype, predelay_side,
                    tail_mac, "allk")
            else:
                self.engine = FMajorPartitionedConvolution(
                    num_voices, block, partitions, max_predelay=max_predelay,
                    mac_strategy="allk", num_irs=capacity,
                    mac_dtype=mac_dtype, swap_snapshot=swap_snapshot,
                    fault_upload=fault_upload, device=self.device)
            self._init_working_set(bank, capacity, async_paging,
                                   ws_exhausted, partitions, cache_dir)
            return
        if engine == "cascade":
            self.engine = self._cascade(
                num_voices, block, partitions, cascade_ratio, max_predelay,
                len(bank), mac_dtype, predelay_side, tail_mac, mac_strategy)
            if bank_prep == "device":
                self.spectra = device_prep.prepare_cascade_bank_device(
                    self.engine, bank)
            else:
                self.spectra = self.engine.prepare_bank(bank,
                                                        cache_dir=cache_dir)
        elif engine == "fmajor":
            # swap_snapshot=False only composes with the allk strategy;
            # the auto rule would silently pick 'selected' on big banks
            strategy = mac_strategy
            if not swap_snapshot and strategy == "auto":
                strategy = "allk"
            self.engine = FMajorPartitionedConvolution(
                num_voices, block, partitions, max_predelay=max_predelay,
                mac_strategy=strategy, num_irs=len(bank),
                mac_dtype=mac_dtype, swap_snapshot=swap_snapshot,
                fault_upload=fault_upload, device=self.device)
            if bank_prep == "device":
                self.spectra = device_prep.prepare_fmajor_bank_device(
                    self.engine, bank)
            else:
                self.spectra = self.engine.prepare_bank(
                    _host_spectra(bank, block, partitions, cache_dir),
                    cache_dir=cache_dir)
        elif engine == "partitioned":
            self.engine = PartitionedConvolution(
                num_voices, block, partitions, max_predelay=max_predelay,
                variant=variant, device=self.device)
            self.spectra = self._upload(
                _host_spectra(bank, block, partitions, cache_dir))
        else:
            self.engine = MonolithicConvolution(
                num_voices, fft_size, block, max_predelay=max_predelay,
                device=self.device)
            # reserve >= block keeps overlap-add exact; the reference fixes
            # reserve at 1024 (conv.h:63), which at small fftSize would
            # truncate the whole IR away
            self.spectra = self._upload(bank.monolithic_spectra(
                fft_size, reserve=max(block, min(1024, fft_size // 8))))
        Log.info("reverb", "%d voice(s), %d IRs, engine=%s (%s), bank "
                 "%.1f MB on %s", num_voices, len(bank), engine,
                 getattr(self.engine, "mac_strategy",
                         getattr(self.engine, "variant", f"fft {fft_size}")),
                 self.bank_bytes() / 1e6, self.device)

    def _upload(self, spectra: np.ndarray) -> torch.Tensor:
        """Host complex64 spectra (a read-only cache mmap included) -> a
        tensor on the model's device."""
        if not spectra.flags.writeable:
            return torch.tensor(spectra, device=self.device)
        return torch.from_numpy(spectra).to(self.device)

    def _cascade(self, num_voices, block, partitions, requested, max_predelay,
                 num_irs, mac_dtype, predelay_side, tail_mac, mac_strategy):
        """The cascade engine at the largest stagger ratio <= `requested`
        that fits (a warning says when it shrank); mac_strategy='auto'
        sends a bank of more than 16 IRs to 'selected'."""
        ratio = _fit_cascade_ratio(requested, num_voices, partitions)
        if ratio != requested:
            Log.warn("reverb", "cascade ratio %d adjusted to %d (voices=%d "
                     "must divide, IR partitions=%d must exceed 2*ratio)",
                     requested, ratio, num_voices, partitions)
        return CascadeConvolution(
            num_voices, block, partitions, ratio=ratio,
            max_predelay=max_predelay, num_irs=num_irs, mac_dtype=mac_dtype,
            predelay_side=predelay_side, tail_mac=tail_mac,
            mac_strategy=mac_strategy, device=self.device)

    def _init_working_set(self, bank, capacity, async_paging, ws_exhausted,
                          partitions, cache_dir):
        """Large banks at small-bank speed: the engine (built over
        `capacity` slots) runs the all-K path; the full bank stays on the
        host and select events page IRs in on demand
        (runtime/working_set.py). Engine geometry is sized by the FULL
        bank so any member IR fits its slot. Device prep with 'td' faults
        keeps every spectrum on the device; host prep packs the residents
        from the full bank's host spectra, which the 'dual' and 'derived'
        payloads slice."""
        from tpu_audio_torch.runtime.working_set import WorkingSetBank

        residents = list(range(capacity))
        device = self.bank_prep == "device"
        payload = bank.ir
        if isinstance(self.engine, CascadeConvolution):
            compact = _sub_bank(bank, residents)
            if device:
                self.spectra = device_prep.prepare_cascade_bank_device(
                    self.engine, compact)
            else:
                # prepare_bank pads the compact sub-bank up to the engine's
                # (full-bank-sized) partition grid
                self.spectra = self.engine.prepare_bank(compact,
                                                        cache_dir=cache_dir)
        elif device:
            if self.fault_upload != "td":
                # spectra fault payloads need the host FFT after all — the
                # full-bank prep this mode exists to avoid
                raise ValueError(
                    "bank_prep='device' working sets need "
                    "fault_upload='td' (time-domain fault payloads); "
                    f"{self.fault_upload!r} would re-run the host FFT over "
                    "the whole bank")
            self.spectra = device_prep.prepare_fmajor_bank_device(
                self.engine, _sub_bank(bank, residents))
        else:
            full = _host_spectra(bank, self.block, partitions, cache_dir)
            self.spectra = self.engine.prepare_bank(full[residents],
                                                    cache_dir=cache_dir)
            if self.fault_upload == "td":
                Log.warn("reverb", "fault_upload='td' with bank_prep='host' "
                         "mixes host- and device-FFT slots in one bank "
                         "(~1e-7 relative); use bank_prep='device' for "
                         "uniform provenance")
            else:
                def payload(k):
                    return full[k: k + 1]
        # the slowest CC-reachable crossfade (speed 127 -> vsteps 1016)
        # plus decay margin sets the eviction protection window: a slot
        # must never be reclaimed while a fade-out still references it
        self.working_set = WorkingSetBank(
            self.engine, self.control, payload, self.spectra, residents,
            min_age_blocks=CC_MAX_SPEED + 64, async_paging=async_paging,
            on_exhausted=ws_exhausted)
        self.working_set.on_update = self._publish_bank
        self._live_session = None
        Log.info("reverb", "%d voice(s), %d-IR bank with %d resident slots, "
                 "engine=%s (allk), bank %.1f MB on %s", self.engine.num_voices,
                 len(bank), capacity, type(self.engine).__name__,
                 self.bank_bytes() / 1e6, self.device)

    def bank_bytes(self) -> int:
        """Bytes of the device bank, placeholders included."""
        leaves = ([self.spectra] if isinstance(self.spectra, torch.Tensor)
                  else vars(self.spectra).values())
        return sum(leaf.numel() * leaf.element_size() for leaf in leaves)

    def _publish_bank(self, new_bank) -> None:
        if not isinstance(new_bank, ShardedBank):
            # (a mesh session's placed bank is the session's, for one run)
            self.spectra = new_bank
        if self._live_session is not None:
            # slot updates only touch fade-inert slots (min-age eviction),
            # so the swap is safe to apply directly between blocks
            self._live_session.bank = new_bank

    # -- reference-settings construction (src/main.cu:18-116) --------------------

    @classmethod
    def from_settings(cls, settings: Settings | str,
                      engine: str = "partitioned",
                      root: str | None = None, num_voices: int | None = None,
                      max_ir_seconds: float | None = None,
                      normalize_bank: str | None = None,
                      verbose: bool = True, **kwargs) -> "ConvolutionReverb":
        """Build from a reference-format settings file (the JAX package's
        default engine, "partitioned"; the CLI passes its --engine).

        conv.count / 2 stereo voices (reference asserts count is even,
        src/main.cu:26); per-channel CC mappings + initial values
        (src/main.cu:54-70); IR banks from BOTH channels' index files
        (src/main.cu:72-81), concatenated along the bank axis when they
        differ, each engine channel addressing its own window; fftSize
        sizes the monolithic engine. A file whose pairs differ raises
        ValueError: ReverbGroups.from_settings serves it."""
        if not isinstance(settings, Settings):
            settings = Settings().open(settings, verbose=verbose)
        count = settings.u32("conv.count", default=2)
        if count % 2:
            raise ValueError("conv.count must be a multiple of 2 (main.cu:26)")
        v = num_voices if num_voices is not None else count // 2
        # one batched engine shares one geometry across its voices: a file
        # whose pairs differ must not collapse silently to pair 0's
        keys = pair_geometry_keys(settings, root)
        if len(set(keys)) > 1:
            raise ValueError(
                f"settings file has {len(set(keys))} distinct conv-pair "
                f"geometries (fftSize/maxPredelay/index); a single "
                f"ConvolutionReverb would silently serve them all with "
                f"pair 0's — build ReverbGroups.from_settings instead "
                f"(the CLI routes there automatically)")
        fft_size, max_pd, _, _ = keys[0]
        bank, windows = _merged_bank(
            _resolve_index(settings, 0, root),
            _resolve_index(settings, 1, root), root, max_ir_seconds, verbose,
            sample_rate=kwargs.get("sample_rate", 44100))
        if normalize_bank:
            bank.normalize(mode=normalize_bank)
        model = cls(bank, num_voices=v, engine=engine, fft_size=fft_size,
                    max_predelay=max_pd, **kwargs)
        model.control.set_channel_banks(windows)
        for voice in range(min(v, count // 2)):
            for ch in range(2):
                idx = voice * 2 + ch
                model.control.set_mapping(
                    voice, ch, CCMapping.from_settings(settings, idx))
                model.control.load_initial_values(settings, voice, ch, idx)
        # replicate voice 0's config across extra voices (server scale-out)
        for voice in range(count // 2, v):
            for ch in range(2):
                model.control.set_mapping(voice, ch,
                                          CCMapping.from_settings(settings, ch))
                model.control.load_initial_values(settings, voice, ch, ch)
        return model

    # -- running --------------------------------------------------------------------

    def init_state(self, converged: bool = True):
        if converged:
            return self.engine.init_converged(
                self.spectra, self.control.snapshot().to(self.device))
        return self.engine.init_state()

    def session(self, source: BlockSource, sink: BlockSink,
                **kwargs) -> StreamSession:
        """A StreamSession of this model; `kwargs` go to it unchanged
        (warmup, realtime, clock, pipeline_depth, underrun_policy,
        max_consecutive_underruns, on_missed_deadline, chunk_blocks,
        fetch_batch, wire, spans: a utils/profiling.py Spans, mesh: a
        parallel/mesh.py Mesh; the working set writes the session's
        placed bank while a run lasts, so that its slot writes reach every
        replica, and ``spectra`` stays the single-device bank)."""
        sess = StreamSession(self.engine, self.spectra, self.control,
                             source, sink, sample_rate=self.sample_rate,
                             **kwargs)
        if self.working_set is not None:
            self._live_session = sess

            def adopt(bank):
                # a mesh session's placed bank at run start, the gathered
                # single-device bank at run end
                self.working_set.bank = bank
                if not isinstance(bank, ShardedBank):
                    self.spectra = bank

            sess.on_bank_placed = adopt
            # warm the fault path before block 0, so the first real bank
            # miss pays no one-off cost mid-stream
            sess.pre_run_hooks.append(self.working_set.warmup)
        if isinstance(self.engine, MonolithicConvolution):
            # build the fft_size-point FFT plans before block 0
            sess.pre_run_hooks.append(self.engine.warmup)
        return sess

    def process(self, source: BlockSource, sink: BlockSink,
                midi: MidiSchedule | None = None,
                max_blocks: int | None = None, state=None,
                **session_kwargs):
        """Convenience: build a session, run to completion, return
        (final_state, summary dict)."""
        session = self.session(source, sink, **session_kwargs)
        state = state if state is not None else self.init_state()
        state = session.run(state, max_blocks=max_blocks, midi=midi)
        return state, session.summary()

    def render_offline(self, samples, **kwargs):
        """Time-parallel bounce: the time axis is segmented onto virtual
        voices, so throughput scales with the engine's voice ceiling instead
        of the per-block step time (runtime/offline.py). Renders the control
        plane's current (converged) parameters, or a scripted MIDI timeline
        via ``schedule=MidiSchedule(...)``, which matches the live streaming
        session to float precision; ``mesh=`` renders the virtual voices
        in one lane per voice row of a parallel/mesh.py Mesh. Returns
        per-voice output [V, 2, T + tail]. ``spans=`` (a
        utils/profiling.py Spans) records its stage spans; offline_counters()
        then reads its counters."""
        from tpu_audio_torch.runtime.offline import render_offline

        counters: dict = {}
        out = render_offline(self, samples, counters=counters, **kwargs)
        self._offline_counters = counters
        return out

    def offline_counters(self) -> dict:
        """The counters of the last render_offline call that returned
        (runtime/offline.py; {} before the first)."""
        return dict(self._offline_counters)


class MultiVoiceReverbServer(ConvolutionReverb):
    """64 concurrent stereo voices on the fmajor engine (the CLI's default
    engine) unless `engine` says otherwise."""

    def __init__(self, bank: IRBank, num_voices: int = 64, block: int = 256,
                 **kwargs):
        kwargs.setdefault("engine", "fmajor")
        super().__init__(bank, num_voices=num_voices, block=block, **kwargs)


class ReverbGroups:
    """The models of a settings file whose conv pairs differ.

    The reference builds count/2 independent Convolution instances, each
    pair with its own fftSize and index files (src/main.cu:31-39), all fed
    the same capture ports and summed into the same playback ports by the
    JACK graph (main.cu:86-89). Here pairs are grouped by their geometry key
    (pair_geometry_keys), one batched ConvolutionReverb per distinct key,
    and ``process`` streams every group over the same input and sums their
    outputs, as that wiring does."""

    def __init__(self, models: list[ConvolutionReverb],
                 pair_ids: list[list[int]]):
        self.models = models
        self.pair_ids = pair_ids  # settings pair indices per group

    @classmethod
    def from_settings(cls, settings: Settings | str, engine: str = "fmajor",
                      root: str | None = None,
                      max_ir_seconds: float | None = None,
                      verbose: bool = True, **kwargs) -> "ReverbGroups":
        """One model per distinct pair geometry; `kwargs` go to every
        ConvolutionReverb (device, block, variant, ...)."""
        if not isinstance(settings, Settings):
            settings = Settings().open(settings, verbose=verbose)
        count = settings.u32("conv.count", default=2)
        groups: dict[tuple, list[int]] = {}
        for n, key in enumerate(pair_geometry_keys(settings, root)):
            groups.setdefault(key, []).append(n)

        models, pair_ids = [], []
        for (fft, max_pd, index0, index1), pairs in groups.items():
            bank, windows = _merged_bank(
                index0, index1, root, max_ir_seconds, verbose,
                sample_rate=kwargs.get("sample_rate", 44100))
            model = ConvolutionReverb(bank, num_voices=len(pairs),
                                      engine=engine, fft_size=fft,
                                      max_predelay=max_pd, **kwargs)
            model.control.set_channel_banks(windows)
            for voice, n in enumerate(pairs):
                for ch in range(2):
                    idx = 2 * n + ch
                    model.control.set_mapping(
                        voice, ch, CCMapping.from_settings(settings, idx))
                    model.control.load_initial_values(settings, voice, ch,
                                                      idx)
            models.append(model)
            pair_ids.append(list(pairs))
        Log.info("reverb", "%d conv pair(s) in %d engine group(s): %s",
                 count // 2, len(models),
                 [(type(m.engine).__name__, len(p))
                  for m, p in zip(models, pair_ids)])
        return cls(models, pair_ids)

    def process(self, x: np.ndarray, midi: MidiSchedule | None = None,
                max_blocks: int | None = None, **session_kwargs):
        """Stream stereo input [2, T] through every group (the same input
        to every pair, like the reference's capture wiring) and return the
        SUMMED stereo output [2, T'] (the JACK playback mix) and the
        per-group session summaries."""
        total = None
        summaries = []
        for model, pairs in zip(self.models, self.pair_ids):
            blocks = []
            source = WavSource(np.asarray(x), num_voices=len(pairs),
                               block=model.block)
            midi_copy = (MidiSchedule(list(midi._events))
                         if midi is not None else None)
            _, summary = model.process(source, CallbackSink(blocks.append),
                                       midi=midi_copy, max_blocks=max_blocks,
                                       **session_kwargs)
            # this group's pairs summed: [2, T']
            out = (np.concatenate(blocks, axis=-1) if blocks
                   else np.zeros((1, 2, 0), np.float32)).sum(axis=0)
            if total is None:
                total = out
            else:
                n = min(total.shape[-1], out.shape[-1])
                total = total[..., :n] + out[..., :n]
            summaries.append(summary)
        return total, summaries

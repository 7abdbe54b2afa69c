"""The port's device mesh (tpu_audio_torch/parallel/mesh.py) on virtual CPU
shards against the JAX package, on the same numpy inputs.

The shapes are tests/test_parallel.py's (8 voices, 32-frame blocks, IRs of
200-700 samples). The JAX side runs its unsharded engines and sessions
(tests/test_parallel.py holds them equal to its sharded ones), built with
backend="fft" so that both sides run an FFT; one session case also runs
the JAX package's own mesh session as the reference. Tolerances, each of
the output's scale where the outputs are compared: 2e-6 for voice
sharding (every shard runs the unsharded ops on its voices), 1e-5 for
partition sharding (the shards' partial sums add in another order than
one sum over all partitions), 3e-5 for the bounce (tests/test_offline.py's
limit), and 1e-6 absolute for the 1x1 mesh against the unsharded port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import PartitionedConvolution as JaxPartitioned
from tpu_audio.engine.cascade import CascadeConvolution as JaxCascade
from tpu_audio.engine.fmajor import FMajorPartitionedConvolution as JaxFMajor
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.parallel import mesh as jax_mesh
from tpu_audio.runtime import offline as jax_offline
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine.cascade import CascadeConvolution
from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.engine.partitioned import PartitionedConvolution
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.parallel import mesh as pm
from tpu_audio_torch.runtime import offline
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.checkpoint import load_checkpoint
from tpu_audio_torch.runtime.stream import MidiSchedule

torch.set_num_threads(1)

VOICE_DP, PART, BOUNCE, DEGENERATE = 2e-6, 1e-5, 3e-5, 1e-6
V, B = 8, 32


def cpu_mesh(n, part=1):
    return pm.make_mesh(devices=["cpu"] * n, part=part)


def _irs(num_irs, ir_len, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * (0.4 / np.abs(ir).max()))
    return out


def _banks(irs):
    jbank, tbank = JaxIRBank(), IRBank()
    for ir in irs:
        jbank.append(ir)
        tbank.append(ir)
    return jbank, tbank


def _controls(num_irs, predelay=11):
    cps = JaxControlPlane(V, num_irs, max_predelay=64), ControlPlane(
        V, num_irs, max_predelay=64, device="cpu")
    for cp in cps:
        cp.wet[:] = 0.8
        cp.dry[:] = 0.1
        cp.predelay[:, 0] = np.arange(V) * 9 % 64 if predelay is None \
            else predelay
    return cps


def _params(jcp, tcp):
    return jax.tree.map(jnp.asarray, jcp.snapshot()), tcp.snapshot_device()


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((V, 2, B)) * 0.05).astype(np.float32)
            for _ in range(n)]


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 1e-4, what
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel * scale:.3e}"


def _reselect(jcp, tcp, select, vsteps):
    """The same re-select on both control planes: (old, changed) numpy."""
    old = jcp.select.copy()
    for cp in (jcp, tcp):
        cp.select[:] = select
        cp.vsteps[:] = vsteps
    return old, jcp.select != old


# -- steps ---------------------------------------------------------------------------


@pytest.mark.parametrize("voice,part,variant", [
    (8, 1, "coef"), (4, 2, "coef"), (2, 4, "coef"), (4, 2, "materialized")])
def test_partitioned_step_matches_jax(voice, part, variant):
    jbank, tbank = _banks(_irs(2, 256, 0))
    parts = jbank.max_partitions(B)
    jeng = JaxPartitioned(V, B, parts, max_predelay=64, variant=variant)
    teng = PartitionedConvolution(V, B, parts, max_predelay=64,
                                  variant=variant, device="cpu")
    spectra = tbank.partitioned_spectra(B)
    jspec, tspec = jnp.asarray(spectra), torch.tensor(spectra)
    jcp, tcp = _controls(2)
    jp, tp = _params(jcp, tcp)
    mesh = cpu_mesh(voice * part, part)
    step = pm.shard_partitioned_step(teng, mesh)
    state = pm.place_state(teng.init_converged(tspec, tp), mesh, teng)
    bank = pm.place_bank(tspec, mesh, teng)
    jstep = jax.jit(jeng.step)
    jstate = jeng.init_converged(jspec, jp)
    for t, x in enumerate(_blocks(6, 1)):
        state, out = step(state, bank, tp, torch.tensor(x))
        jstate, jout = jstep(jstate, jspec, jp, jnp.asarray(x))
        _close(out.gather(), jout, VOICE_DP if part == 1 else PART,
               f"block {t}")
    # per block and voice row: a boundary column per part shard > 0, and
    # its partial sums (the target's and, 'coef', the snapshot's)
    sums = 2 if variant == "coef" else 1
    assert mesh.exchanges == 6 * voice * (part - 1) * (1 + sums)


def test_partitioned_sharded_collapse_and_crossfade():
    jbank, tbank = _banks(_irs(2, 256, 0))
    parts = jbank.max_partitions(B)
    jeng = JaxPartitioned(V, B, parts, max_predelay=64)
    teng = PartitionedConvolution(V, B, parts, max_predelay=64, device="cpu")
    spectra = tbank.partitioned_spectra(B)
    jspec, tspec = jnp.asarray(spectra), torch.tensor(spectra)
    jcp, tcp = _controls(2)
    jp, tp = _params(jcp, tcp)
    mesh = cpu_mesh(8, part=2)
    step, collapse = (pm.shard_partitioned_step(teng, mesh),
                      pm.shard_collapse(teng, mesh))
    steady = pm.shard_partitioned_step(teng, mesh, steady=True)
    state = pm.place_state(teng.init_converged(tspec, tp), mesh, teng)
    bank = pm.place_bank(tspec, mesh, teng)
    jstate = jeng.init_converged(jspec, jp)
    xs = _blocks(12, 2)
    state, out = steady(state, bank, tp, torch.tensor(xs[0]))
    jstate, jout = jax.jit(jeng.step_coef_steady)(jstate, jspec, jp,
                                                  jnp.asarray(xs[0]))
    _close(out.gather(), jout, PART, "steady")
    old, changed = _reselect(jcp, tcp, 1, 4)
    state = collapse(state, bank, torch.tensor(old), torch.tensor(changed))
    jstate = jeng.collapse(jstate, jspec, jnp.asarray(old),
                           jnp.asarray(changed))
    jstep = jax.jit(jeng.step_coef)
    for t, x in enumerate(xs[1:]):
        jp, tp = _params(jcp, tcp)
        state, out = step(state, bank, tp, torch.tensor(x))
        jstate, jout = jstep(jstate, jspec, jp, jnp.asarray(x))
        _close(out.gather(), jout, PART, f"fade block {t}")
        for cp in (jcp, tcp):
            cp.end_block()
    gathered = state.gather()
    np.testing.assert_allclose(gathered.base.numpy(), np.asarray(jstate.base),
                               atol=1e-5)
    np.testing.assert_allclose(gathered.coef_a.numpy(),
                               np.asarray(jstate.coef_a), atol=1e-6)


def _fmajor_pair(ring, strategy, ir_len, num_irs=2, seed=5):
    jbank, tbank = _banks(_irs(num_irs, ir_len, seed))
    parts = jbank.max_partitions(B)
    kwargs = dict(max_predelay=64, ring=ring, mac_strategy=strategy,
                  num_irs=num_irs)
    jeng = JaxFMajor(V, B, parts, backend="fft", **kwargs)
    teng = FMajorPartitionedConvolution(V, B, parts, device="cpu", **kwargs)
    spectra = tbank.partitioned_spectra(B)
    return jeng, teng, jeng.prepare_bank(spectra), teng.prepare_bank(spectra)


def test_fmajor_ring_voice_sharded_indexed_fade_matches_jax():
    jeng, teng, jbank, tbank = _fmajor_pair(True, "allk", 200)
    jcp, tcp = _controls(2)
    jp, tp = _params(jcp, tcp)
    mesh = cpu_mesh(8)
    steady = pm.shard_fmajor_step(teng, mesh, steady=True)
    indexed = pm.shard_fmajor_step(teng, mesh, mode="indexed")
    cpure = pm.shard_fmajor_collapse_pure(teng, mesh)
    state = pm.place_state(teng.init_converged(tbank, tp), mesh, teng)
    bank = pm.place_bank(tbank, mesh, teng)
    jstate = jeng.init_converged(jbank, jp)
    xs = _blocks(14, 3)
    jsteady = jax.jit(jeng.step_coef_steady)
    for t, x in enumerate(xs[:4]):
        state, out = steady(state, bank, tp, torch.tensor(x))
        jstate, jout = jsteady(jstate, jbank, jp, jnp.asarray(x))
        _close(out.gather(), jout, VOICE_DP, f"steady block {t}")
    old, changed = _reselect(jcp, tcp, 1, 6)
    state = cpure(state, torch.tensor(old), torch.tensor(changed))
    jstate = jeng.collapse_pure(jstate, jnp.asarray(old), jnp.asarray(changed))
    jindexed = jax.jit(jeng.step_coef_indexed)
    for t, x in enumerate(xs[4:]):
        jp, tp = _params(jcp, tcp)
        state, out = indexed(state, bank, tp, torch.tensor(x))
        jstate, jout = jindexed(jstate, jbank, jp, jnp.asarray(x))
        _close(out.gather(), jout, VOICE_DP, f"fade block {t}")
        for cp in (jcp, tcp):
            cp.end_block()
    np.testing.assert_allclose(state.leaf("base_g").numpy(),
                               np.asarray(jstate.base_g), atol=1e-6)
    assert mesh.exchanges == 0


@pytest.mark.parametrize("voice,part", [(4, 2), (2, 4)])
@pytest.mark.parametrize("strategy", ["allk", "selected"])
def test_fmajor_roll_part_sharded_matches_jax(voice, part, strategy):
    """Roll mode over (voice, part): a materializing collapse, then the
    general fade step, against JAX's unsharded engine."""
    jeng, teng, jbank, tbank = _fmajor_pair(False, strategy, 512, seed=11)
    assert teng.pp % part == 0
    jcp, tcp = _controls(2)
    for cp in (jcp, tcp):
        cp.dry[:] = 0.1
    jp, tp = _params(jcp, tcp)
    mesh = cpu_mesh(voice * part, part)
    step = pm.shard_fmajor_step(teng, mesh)
    collapse = pm.shard_fmajor_collapse(teng, mesh)
    state = pm.place_state(teng.init_converged(tbank, tp), mesh, teng)
    bank = pm.place_bank(tbank, mesh, teng)
    jstate = jeng.init_converged(jbank, jp)
    select = jcp.select.copy()
    select[:4] = 1
    old, changed = _reselect(jcp, tcp, select, 5)
    extra = ({"new_select": torch.tensor(jcp.select)}
             if strategy == "selected" else {})
    state = collapse(state, bank, torch.tensor(old), torch.tensor(changed),
                     **extra)
    jextra = ((jnp.asarray(jcp.select),) if strategy == "selected" else ())
    jstate = jeng.collapse(jstate, jbank, jnp.asarray(old),
                           jnp.asarray(changed), *jextra)
    jstep = jax.jit(jeng.step_coef)
    for t, x in enumerate(_blocks(10, 4)):
        jp, tp = _params(jcp, tcp)
        state, out = step(state, bank, tp, torch.tensor(x))
        jstate, jout = jstep(jstate, jbank, jp, jnp.asarray(x))
        _close(out.gather(), jout, PART, f"block {t}")
        for cp in (jcp, tcp):
            cp.end_block()
    # per block and voice row: a column and two partial sums (the
    # selection's and the snapshot's) per part shard > 0
    assert mesh.exchanges == 10 * voice * (part - 1) * 3


def test_cascade_voice_sharded_matches_jax():
    """Steady blocks, the span collapse (with its in-flight tail rescale)
    and the indexed fade, each voice shard its own stagger groups."""
    jbank, tbank = _banks(_irs(2, 700, 23))
    parts = jbank.max_partitions(B)
    jeng = JaxCascade(V, B, parts, ratio=2, max_predelay=64, backend="fft")
    teng = CascadeConvolution(V, B, parts, ratio=2, max_predelay=64,
                              device="cpu")
    jb, tb = jeng.prepare_bank(jbank), teng.prepare_bank(tbank)
    jcp, tcp = _controls(2, predelay=None)
    jp, tp = _params(jcp, tcp)
    mesh = cpu_mesh(4)
    steady = pm.shard_cascade_step(teng, mesh, "steady")
    indexed = pm.shard_cascade_step(teng, mesh, "indexed")
    cpure = pm.shard_cascade_collapse_pure(teng, mesh)
    state, bank = pm.place_cascade(teng.init_converged(tb, tp), tb, mesh)
    jstate = jeng.init_converged(jb, jp)
    xs = _blocks(40, 5)
    jsteady, jindexed = (jax.jit(jeng.step_coef_steady),
                         jax.jit(jeng.step_coef_indexed))
    for t, x in enumerate(xs[:20]):
        state, out = steady(state, bank, tp, torch.tensor(x))
        jstate, jout = jsteady(jstate, jb, jp, jnp.asarray(x))
        _close(out.gather(), jout, VOICE_DP, f"steady block {t}")
    old, changed = _reselect(jcp, tcp, 1, 12)
    jp, tp = _params(jcp, tcp)
    state = cpure(state, torch.tensor(old), torch.tensor(changed), tp)
    jstate = jeng.collapse_pure(jstate, jnp.asarray(old),
                                jnp.asarray(changed), jp)
    for t, x in enumerate(xs[20:]):
        jp, tp = _params(jcp, tcp)
        state, out = indexed(state, bank, tp, torch.tensor(x))
        jstate, jout = jindexed(jstate, jb, jp, jnp.asarray(x))
        _close(out.gather(), jout, VOICE_DP, f"fade block {t}")
        for cp in (jcp, tcp):
            cp.end_block()


def test_cascade_contiguous_split_keeps_stagger_groups():
    """Local voice u of shard r is global voice r*Vl + u, so u % ratio ==
    v % ratio when Vl is a multiple of the ratio: a placed and gathered
    state is the single-device state, leaf for leaf."""
    teng = CascadeConvolution(V, B, 22, ratio=2, max_predelay=64,
                              num_irs=2, device="cpu")
    state = teng.init_state()
    for name in ("fdl2", "inbuf2", "tail_ring", "fdl1", "wet_ring"):
        leaf = getattr(state, name)
        leaf.copy_(torch.arange(leaf.numel(), dtype=torch.float32
                                ).reshape(leaf.shape).to(leaf.dtype))
    sharded = pm.place_cascade_state(state, cpu_mesh(4))
    back = sharded.gather()
    for name in ("fdl2", "inbuf2", "tail_ring", "fdl1", "wet_ring"):
        assert torch.equal(getattr(back, name), getattr(state, name)), name
    # shard 1's group-g rows are global voices 2 + j*ratio + g
    local = sharded.shards[1][0].inbuf2                  # [M, Vg/4, ...]
    assert torch.equal(local, state.inbuf2[:, 1:2])


# -- validation and the degenerate mesh ---------------------------------------------


def test_mesh_validation_messages():
    with pytest.raises(ValueError, match="does not divide"):
        pm.make_mesh(devices=["cpu"] * 6, part=4)
    with pytest.raises(ValueError, match="mix device types"):
        pm.Mesh([[torch.device("cpu"), torch.device("meta")]])
    odd = PartitionedConvolution(3, B, 4, max_predelay=64, device="cpu")
    with pytest.raises(ValueError, match="voices not divisible by voice axis"):
        pm.shard_partitioned_step(odd, cpu_mesh(2))
    part = PartitionedConvolution(4, B, 9, max_predelay=64, device="cpu")
    with pytest.raises(ValueError, match="partitions not divisible by part"):
        pm.shard_partitioned_step(part, cpu_mesh(4, part=2))
    roll = FMajorPartitionedConvolution(6, B, 9, max_predelay=64, ring=False,
                                        device="cpu")
    with pytest.raises(ValueError, match="padded partition axis"):
        pm.shard_fmajor_step(roll, cpu_mesh(6, part=3))
    with pytest.raises(ValueError, match="voices"):
        pm.shard_fmajor_step(roll, cpu_mesh(8, part=2))
    ring = FMajorPartitionedConvolution(8, B, 9, max_predelay=64,
                                        device="cpu")
    with pytest.raises(ValueError, match="ring-mode fmajor cannot shard"):
        pm.shard_fmajor_step(ring, cpu_mesh(4, part=2))
    # bf16: Pp 16 over 8 part shards leaves 2 per shard, and the bf16
    # mac_shift needs a multiple of 4 (over 4 shards: 4, accepted)
    bf16 = FMajorPartitionedConvolution(2, B, 9, max_predelay=64, ring=False,
                                        mac_dtype="bf16", num_irs=2,
                                        device="cpu")
    with pytest.raises(ValueError, match="mac_shift kernel's rule"):
        pm.shard_fmajor_step(bf16, cpu_mesh(8, part=8))
    pm.shard_fmajor_step(bf16, cpu_mesh(4, part=4))     # Pp 16 / 4 = 4
    cascade = CascadeConvolution(8, B, 22, ratio=2, max_predelay=64,
                                 num_irs=2, device="cpu")
    with pytest.raises(ValueError, match="part"):
        pm.shard_cascade_step(cascade, cpu_mesh(8, part=2))
    with pytest.raises(ValueError, match="stagger"):
        pm.shard_cascade_step(cascade, cpu_mesh(8))


@pytest.mark.parametrize("kind", ["fmajor", "partitioned"])
def test_single_device_mesh_is_the_unsharded_step(kind):
    jbank, tbank = _banks(_irs(2, 256, 0))
    parts = jbank.max_partitions(B)
    _, tcp = _controls(2)
    params = tcp.snapshot_device()
    if kind == "fmajor":
        eng = FMajorPartitionedConvolution(V, B, parts, max_predelay=64,
                                           num_irs=2, device="cpu")
        bank = eng.prepare_bank(tbank.partitioned_spectra(B))
    else:
        eng = PartitionedConvolution(V, B, parts, max_predelay=64,
                                     device="cpu")
        bank = torch.tensor(tbank.partitioned_spectra(B))
    mesh = cpu_mesh(1)
    step = (pm.shard_fmajor_step if kind == "fmajor"
            else pm.shard_partitioned_step)(eng, mesh)
    state = pm.place_state(eng.init_converged(bank, params), mesh, eng)
    placed = pm.place_bank(bank, mesh, eng)
    plain = eng.init_converged(bank, params)
    for t, x in enumerate(_blocks(5, 6)):
        state, out = step(state, placed, params, torch.tensor(x))
        plain, want = eng.step_coef(plain, bank, params, torch.tensor(x))
        np.testing.assert_allclose(out.gather().numpy(), want.numpy(),
                                   atol=DEGENERATE, err_msg=f"block {t}")
    np.testing.assert_allclose(state.gather().wet_ring.numpy(),
                               plain.wet_ring.numpy(), atol=DEGENERATE)


# -- sessions -----------------------------------------------------------------------

SESSION_EVENTS = [(6, "", bytes([0xB0, 0x15, 64])),    # select full 3
                  (18, "", bytes([0xB0, 0x15, 110]))]  # select full 5
SESSION_BLOCKS = 40


def _session_run(side, kind, mesh=None, ckpt=None, resume_from=None):
    """tests/test_parallel.py's session: 6 IRs of 700 samples, 40 blocks,
    two MIDI re-selects; fmajor through a 4-slot working set (a fault),
    the cascade at ratio 2; checkpoints every 17 blocks to `ckpt`, or a
    resume from `resume_from`. Returns (sink data, session)."""
    jax_side = side == "jax"
    jbank, tbank = _banks(_irs(6, 700, 3))
    x = (np.random.default_rng(4).standard_normal((V, 2, B * SESSION_BLOCKS))
         * 0.05).astype(np.float32)
    kwargs = dict(num_voices=V, block=B, max_predelay=64,
                  engine=kind.split("-")[0])
    if kind.startswith("fmajor"):
        kwargs["bank_capacity"] = 4
        kwargs["async_paging"] = kind.endswith("async")
    if kind.startswith("cascade"):
        kwargs["cascade_ratio"] = 2
    if kind == "cascade-selected":
        kwargs["mac_strategy"] = "selected"
    if jax_side:
        if kind != "partitioned":
            kwargs["bank_prep"] = "device"
        model = JaxReverb(jbank, backend="fft", **kwargs)
    else:
        model = ConvolutionReverb(tbank, device="cpu", **kwargs)
    ws = getattr(model, "working_set", None)
    if ws is not None and ws.async_paging:
        # pin the publish to the block after the select (the worker
        # thread's timing is not what is under test)
        hook = model.control.block_hooks.index(ws.poll)
        model.control.block_hooks[hook] = ws.drain
    cp = model.control
    cp.wet[:] = 0.8
    cp.dry[:] = 0.1
    cp.speed[:] = 6
    cp.set_mapping(0, 0, (JaxCCMapping if jax_side else CCMapping)(
        message=0xB0, select=0x15))
    if jax_side:
        sink = JaxWavSink("/dev/null", keep_data=True)
        source = JaxWavSource(x, V, B)
        sess = model.session(source, sink, warmup=0, donate=False,
                             mesh=mesh)
        midi = JaxMidiSchedule(list(SESSION_EVENTS))
    else:
        sink = WavSink("/dev/null", keep_data=True)
        source = WavSource(x, V, B)
        sess = model.session(source, sink, warmup=0, mesh=mesh)
        midi = MidiSchedule(list(SESSION_EVENTS))
    state = model.init_state()
    if resume_from is not None:
        state, meta = load_checkpoint(resume_from, state, model.control)
        start = meta["block_index"]
        midi.rewind_to(start)
        sess.source = WavSource(x[..., B * start:], V, B)
        sess.run(state, midi=midi, start_block=start)
    else:
        sess.run(state, midi=midi, checkpoint_path=ckpt,
                 checkpoint_every=17)
    if ws is not None:
        ws.close()
    return sink.data, sess


# (voice, part) per kind: the cascade needs whole stagger groups per shard
# (8 voices, ratio 2: at most 4 shards); the partitioned engine also
# splits its partitions
SESSION_MESH = {"fmajor": (8, 1), "fmajor-async": (8, 1), "cascade": (4, 1),
                "cascade-selected": (4, 1), "partitioned": (4, 2)}


@pytest.mark.parametrize("kind", list(SESSION_MESH))
def test_mesh_session_matches_jax(kind, tmp_path):
    """StreamSession(mesh=) through the whole runtime: MIDI re-selects
    (collapse and crossfade), a working-set fault (fmajor, sync and
    async), and a checkpoint saved on the mesh and resumed on the mesh,
    whose tail must equal the uninterrupted run's. The fmajor case's
    reference is the JAX package's own session on its 8-device mesh."""
    voice, part = SESSION_MESH[kind]
    mesh = cpu_mesh(voice * part, part)
    ckpt = tmp_path / "mesh.ckpt"
    got, sess = _session_run("port", kind, mesh, ckpt=str(ckpt))
    want, _ = _session_run("jax", kind, jax_mesh.make_mesh(8, part=1)
                           if kind == "fmajor" else None)
    rel = VOICE_DP if part == 1 else PART
    _close(got, want, rel, kind)
    assert sess.blocks_streamed == SESSION_BLOCKS
    if kind.startswith("fmajor"):
        assert sess.indexed_blocks > 0
    resumed, _ = _session_run("port", kind, cpu_mesh(voice * part, part),
                              resume_from=str(ckpt))
    n = resumed.shape[-1]
    assert n == B * (SESSION_BLOCKS - 34)       # from the save at 34
    np.testing.assert_allclose(resumed, got[..., -n:], atol=2e-6)


def test_mesh_checkpoint_loads_into_a_single_device_session(tmp_path):
    ckpt = tmp_path / "mesh.ckpt"
    got, _ = _session_run("port", "cascade", cpu_mesh(4), ckpt=str(ckpt))
    resumed, _ = _session_run("port", "cascade", resume_from=str(ckpt))
    n = resumed.shape[-1]
    np.testing.assert_allclose(resumed, got[..., -n:], atol=2e-6)


def test_mesh_session_leaves_the_model_reusable():
    """One working-set model served by three sessions in turn, each going
    on from the last one's state: on an 8-row mesh, on one device, then on
    a 4-row mesh, with a re-select in each (the first two fault). The
    model keeps its single-device bank between runs, and the output and
    the faults equal three sessions on one device."""
    irs = _irs(6, 700, 3)
    x = (np.random.default_rng(4).standard_normal((V, 2, B * 36)) * 0.05
         ).astype(np.float32)
    events = [(3, "", bytes([0xB0, 0x15, 90])),      # select full 4
              (15, "", bytes([0xB0, 0x15, 110])),    # select full 5
              (27, "", bytes([0xB0, 0x15, 20]))]     # select full 0

    def serve(meshes):
        model = ConvolutionReverb(_banks(irs)[1], num_voices=V, block=B,
                                  max_predelay=64, engine="fmajor",
                                  bank_capacity=4, device="cpu")
        cp = model.control
        cp.wet[:], cp.dry[:], cp.speed[:] = 0.8, 0.1, 6
        cp.set_mapping(0, 0, CCMapping(message=0xB0, select=0x15))
        midi, state, out = MidiSchedule(list(events)), model.init_state(), []
        for i, mesh in enumerate(meshes):
            sink = WavSink("/dev/null", keep_data=True)
            sess = model.session(
                WavSource(x[..., B * 12 * i:B * 12 * (i + 1)], V, B), sink,
                warmup=0, mesh=mesh)
            state = sess.run(state, midi=midi, start_block=12 * i)
            assert not isinstance(model.spectra, pm.ShardedBank)
            assert model.working_set.bank is model.spectra
            assert sess.bank is model.spectra
            out.append(sink.data)
        model.working_set.close()
        return np.concatenate(out, axis=-1), model.working_set.misses

    got, misses = serve([cpu_mesh(8), None, cpu_mesh(4)])
    want, want_misses = serve([None, None, None])
    assert misses == want_misses >= 2
    _close(got, want, VOICE_DP, "mesh, one device, mesh")


def test_mesh_session_refusals():
    tbank = _banks(_irs(2, 300, 0))[1]
    x = np.zeros((2, 2, 64 * 4), np.float32)
    mesh = cpu_mesh(2)
    model = ConvolutionReverb(tbank, num_voices=2, block=64, max_predelay=64,
                              device="cpu", engine="fmajor")
    with pytest.raises(ValueError, match="chunk_blocks must be 1"):
        model.session(WavSource(x, 2, 64), WavSink("/dev/null"),
                      chunk_blocks=4, mesh=mesh)
    for kwargs in ({"engine": "partitioned", "variant": "materialized"},
                   {"engine": "monolithic", "fft_size": 1024}):
        slew = ConvolutionReverb(tbank, num_voices=2, block=64,
                                 max_predelay=64, device="cpu", **kwargs)
        with pytest.raises(ValueError, match="coef-interface engines"):
            slew.session(WavSource(x, 2, 64), WavSink("/dev/null"),
                         mesh=mesh)
    partitioned = ConvolutionReverb(tbank, num_voices=2, block=64,
                                    max_predelay=64, device="cpu",
                                    engine="partitioned")
    with pytest.raises(ValueError, match="mesh-sharded"):
        partitioned.render_offline(x[0], mesh=mesh)


# -- the bounce ---------------------------------------------------------------------

BOUNCE_EVENTS = [(8, "", bytes([0xB0, 0x15, 0x40])),
                 (30, "", bytes([0xB0, 0x16, 0x46])),
                 (41, "", bytes([0xB0, 0x15, 0x7F]))]


def _bounce_model(side, kind):
    jax_side = side == "jax"
    jbank, tbank = _banks(_irs(3, 400, 0))
    kwargs = dict(num_voices=4, block=16, max_predelay=64)
    if kind == "cascade":
        kwargs.update(engine="cascade", cascade_ratio=2)
    else:
        kwargs.update(engine="fmajor")
    if jax_side:
        model = JaxReverb(jbank, backend="fft", **kwargs)
    else:
        model = ConvolutionReverb(tbank, device="cpu", **kwargs)
    cp = model.control
    cp.wet[:] = 0.8
    cp.dry[:] = 0.3
    cp.predelay[:] = [[17, 40]] * 4
    cp.speed[:] = 20
    for v in range(4):
        cp.select[v] = [v % 3, (v + 1) % 3]
        for ch in range(2):
            cp.set_mapping(v, ch, (JaxCCMapping if jax_side else CCMapping)(
                message=0xB0, select=0x15, wet=0x16))
    return model


@pytest.mark.parametrize("kind", ["fmajor", "cascade"])
@pytest.mark.parametrize("how", ["static", "automated", "chunked",
                                 "per_voice"])
def test_mesh_bounce_matches_jax(kind, how):
    """render_offline(mesh=) over a 4-row mesh, against the JAX
    single-device bounce: 3 segments of 4 voices are 3
    virtual voices per lane on fmajor; the cascade rounds up to 4
    segments, so that every lane holds whole stagger groups. `per_voice`
    bounces [V, 2, T] input statically, each lane reading its virtual
    voices' base voices."""
    shape = (4, 2, 16 * 70) if how == "per_voice" else (2, 16 * 70)
    x = (np.random.default_rng(1).standard_normal(shape) * 0.1
         ).astype(np.float32)
    kwargs = {"segments": 3}
    if how == "chunked":
        kwargs["track_chunk_blocks"] = 40
    jkwargs = dict(kwargs)
    if how in ("automated", "chunked"):
        kwargs["schedule"] = MidiSchedule(list(BOUNCE_EVENTS))
        jkwargs["schedule"] = JaxMidiSchedule(list(BOUNCE_EVENTS))
    mesh = cpu_mesh(4)
    got = offline.render_offline(_bounce_model("port", kind), x, mesh=mesh,
                                 **kwargs)
    want = jax_offline.render_offline(_bounce_model("jax", kind), x,
                                      **jkwargs)
    _close(got, want, BOUNCE, f"{kind} {how}")


def test_mesh_round_segments():
    mesh = cpu_mesh(4)
    assert offline._mesh_round_segments(3, 2, mesh) == 4     # 8 / 4 rows
    assert offline._mesh_round_segments(3, 8, mesh) == 3
    # the cascade: v*nseg/ratio group rows split over the voice axis
    assert offline._mesh_round_segments(3, 4, mesh, ratio=2) == 4
    assert offline._mesh_round_segments(3, 2, None) == 3

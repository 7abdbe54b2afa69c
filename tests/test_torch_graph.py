"""The fmajor engine's steady ring step as a CUDA graph
(engine/step_graph.py, FMajorPartitionedConvolution.step_coef_steady).

On the CPU: an engine never captures (every steady call is counted in
steady_eager), the capture's key follows the buffers the graph is bound
to, and a mesh's local engines keep the eager step.

On the card (marked ``cuda``, skipped without one; the file imports no
JAX): the graphed step against the eager one of a twin engine, bit for
bit in f32 and bf16, at 64 voices (ring_mac_kernel) and 8 voices
(ring_mac_small_kernel in f32), through a re-select with an indexed block
and parameter changes; one recapture per fresh state and per bank, the old
capture released; earlier outputs and state leaves never overwritten;
every replay counted as a ring_mac launch; a capture that an unreachable
engine's graph, freed by the cycle collector, cannot break.

    python -m pytest --noconftest -m cuda tests/test_torch_graph.py
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio_torch.engine.params import ControlPlane
from tpu_audio_torch.engine.step_graph import steady_key
from tpu_audio_torch.ops.ring_mac import ring_mac
from tpu_audio_torch.parallel import mesh as pm

torch.set_num_threads(1)

B, P, K, PD = 64, 12, 3, 128
LEAVES = ("fdl", "prev_in", "wet_ring", "base", "coef_a", "coef_c", "wptr",
          "sel_spectra", "base_g", "base_pure")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        pytest.skip("needs nvcc (CUDA_HOME)")
    return torch.device("cuda")


def _spectra(seed):
    rng = np.random.default_rng(seed)
    return (np.fft.rfft(rng.standard_normal((K, 2, P, 2 * B)), axis=-1)
            .astype(np.complex64) * 0.1)


def _engine(device, voices, dtype="f32", ring=True, strategy="allk",
            graphs=True):
    eng = FMajorPartitionedConvolution(voices, B, P, max_predelay=PD,
                                       ring=ring, mac_strategy=strategy,
                                       num_irs=K, mac_dtype=dtype,
                                       device=device)
    eng.steady_graphs = graphs
    return eng


def _control(device, voices, seed=0):
    rng = np.random.default_rng(seed)
    cp = ControlPlane(voices, K, PD, device=device)
    cp.select[:] = rng.integers(0, K, (voices, 2))
    cp.wet[:] = rng.uniform(0.3, 0.9, (voices, 2))
    cp.dry[:] = rng.uniform(0.0, 0.5, (voices, 2))
    cp.predelay[:] = rng.integers(0, PD + 1, (voices, 2))
    cp.pan_wet[:] = rng.uniform(-1, 1, (voices, 2))
    return cp


def _blocks(device, voices, n, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((voices, 2, B)) * 0.05,
                         dtype=torch.float32, device=device)
            for _ in range(n)]


def _assert_states_equal(got, want, what):
    for name in LEAVES:
        assert torch.equal(getattr(got, name), getattr(want, name)), \
            f"{what}: {name}"


# -- on the CPU -------------------------------------------------------------------------


@pytest.mark.parametrize("ring,strategy,dtype", [
    (True, "allk", "f32"), (True, "allk", "bf16"), (False, "allk", "f32"),
    (True, "selected", "f32")])
def test_a_cpu_engine_never_captures(ring, strategy, dtype):
    """Every steady call on the CPU runs the eager step, counted in
    steady_eager: the same bits as step_coef without the base term."""
    eng = _engine("cpu", 2, dtype, ring, strategy)
    bank = eng.prepare_bank(_spectra(3))
    params = _control("cpu", 2).snapshot_device()
    state = eng.init_converged(bank, params)
    twin = eng.init_converged(bank, params)
    for t, x in enumerate(_blocks("cpu", 2, 6)):
        state, out = eng.step_coef_steady(state, bank, params, x)
        twin, want = eng.step_coef(twin, bank, params, x, with_base=False)
        assert torch.equal(out, want), f"block {t}"
    _assert_states_equal(state, twin, "after 6 blocks")
    assert (eng.steady_captures, eng.steady_replays, eng.steady_eager) \
        == (0, 0, 6)
    assert eng._steady_graph is None


def test_the_capture_key_follows_the_bound_buffers():
    """The key is the address and layout of fdl, wet_ring and rhs2 and the
    block's layout: the step's in-place updates and a working-set slot
    write keep it; a fresh state, another bank or another block shape
    change it."""
    eng = _engine("cpu", 2)
    bank = eng.prepare_bank(_spectra(3))
    params = _control("cpu", 2).snapshot_device()
    state = eng.init_converged(bank, params)
    x = _blocks("cpu", 2, 1)[0]
    key = steady_key(state, bank, x)
    state, _ = eng.step_coef_steady(state, bank, params, x)
    assert steady_key(state, bank, x) == key
    ir = np.random.default_rng(5).standard_normal((2, P * B)) * 0.1
    assert eng.update_bank_slot(bank, 1, ir.astype(np.float32)) is bank
    assert steady_key(state, bank, x) == key
    fresh = eng.init_converged(bank, params)
    assert steady_key(fresh, bank, x) != key
    assert steady_key(state, eng.prepare_bank(_spectra(4)), x) != key
    assert steady_key(state, bank, x[:1]) != key


def test_mesh_local_engines_keep_the_eager_step():
    """ShardedEngine turns the graph off on its local engines, and on
    them only."""
    eng = _engine("cpu", 4)
    sh = pm.sharded(eng, pm.make_mesh(devices=["cpu"] * 2))
    locals_ = [local for row in sh.locals for local in row]
    assert locals_ and all(local is not eng for local in locals_)
    assert not any(local.steady_graphs for local in locals_)
    assert eng.steady_graphs


# -- on the card ------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("voices", [64, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_graphed_step_is_the_eager_step_bit_for_bit(cuda, voices, dtype):
    """30 blocks on twin engines, graph on and off, from equal states:
    equal outputs and states to the bit, through parameter changes (the
    copy-in path), a re-select by collapse_pure with one indexed block, and
    the fade's per-block vsteps countdown. One capture; every later steady
    call replays; earlier outputs and leaves stay as returned; one ring_mac
    launch counted per step."""
    graphed = _engine(cuda, voices, dtype)
    eager = _engine(cuda, voices, dtype, graphs=False)
    bank = graphed.prepare_bank(_spectra(voices))
    cp = _control(cuda, voices)
    sg = graphed.init_converged(bank, cp.snapshot_device())
    se = eager.init_converged(bank, cp.snapshot_device())
    kept = []
    launches = launches_bf16 = steady = 0
    for t, x in enumerate(_blocks(cuda, voices, 30)):
        if t == 8:
            cp.predelay[:] = np.roll(cp.predelay, 1)
            cp.dry[:] = 0.25
        step = "steady"
        if t == 14:
            old = torch.tensor(cp.select.copy(), device=cuda)
            changed = torch.zeros((voices, 2), dtype=torch.bool, device=cuda)
            changed[::2] = True
            cp.select[::2] = (cp.select[::2] + 1) % K
            cp.vsteps[::2] = 6
            sg = graphed.collapse_pure(sg, old, changed)
            se = eager.collapse_pure(se, old, changed)
            step = "indexed"
        params = cp.snapshot_device()
        before = (ring_mac.launches, ring_mac.launches_bf16)
        sg, out = getattr(graphed, f"step_coef_{step}")(sg, bank, params, x)
        launches += ring_mac.launches - before[0]
        launches_bf16 += ring_mac.launches_bf16 - before[1]
        se, want = getattr(eager, f"step_coef_{step}")(se, bank, params, x)
        steady += step == "steady"
        cp.end_block()
        assert torch.equal(out, want), f"block {t}"
        for name in ("prev_in", "coef_a", "coef_c", "wptr"):
            assert torch.equal(getattr(sg, name), getattr(se, name)), \
                f"block {t}: {name}"
        if t % 5 == 0:
            kept += [(a, a.clone()) for a in (out, sg.coef_a, sg.coef_c,
                                              sg.wptr)]
    torch.cuda.synchronize()
    _assert_states_equal(sg, se, "after 30 blocks")
    assert all(torch.equal(a, b) for a, b in kept)
    assert launches == 30
    assert launches_bf16 == (30 if dtype == "bf16" else 0)
    assert (graphed.steady_captures, graphed.steady_replays,
            graphed.steady_eager) == (1, steady - 1, 1)
    assert (eager.steady_captures, eager.steady_eager) == (0, steady)


class _Cycle:
    """Holds an object in a reference cycle: only the cycle collector
    frees it."""

    def __init__(self, held):
        self.held, self.me = held, self


@pytest.mark.cuda
def test_capture_survives_an_unreachable_graph(cuda, monkeypatch):
    """An engine whose capture only the cycle collector can free becomes
    unreachable just as another engine starts capturing, with the
    collector set to run every few allocations: the capture holds (no
    collection runs during it, which would call the old graph's
    destructor, refused by CUDA during a capture), and the old graph is
    freed after it."""
    voices = 8
    bank = _engine(cuda, voices).prepare_bank(_spectra(7))
    params = _control(cuda, voices).snapshot_device()
    xs = _blocks(cuda, voices, 3)

    def captured_engine():
        eng = _engine(cuda, voices)
        state = eng.init_converged(bank, params)
        for x in xs:
            state, _ = eng.step_coef_steady(state, bank, params, x)
        assert eng.steady_captures == 1
        return eng

    garbage = [captured_engine()]
    old_graph = weakref.ref(garbage[0]._steady_graph)
    begin = torch.cuda.CUDAGraph.capture_begin

    def begin_then_drop(graph, *args, **kwargs):
        begin(graph, *args, **kwargs)
        if garbage:
            # a new, young cycle is the engine's only holder
            _Cycle(garbage.pop())

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        begin_then_drop)
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1)      # the young cycle goes at the next few
    try:
        captured_engine()
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert not garbage and old_graph() is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fresh_state_and_new_bank_recapture_once(cuda, dtype):
    """A fresh state and another bank each cost one eager block and one
    capture, and the old capture is released along with every hold on
    the old state's line; a slot written in place is read by the replay
    without a recapture. The outputs stay the eager twin's, bit for
    bit."""
    voices = 64
    graphed = _engine(cuda, voices, dtype)
    eager = _engine(cuda, voices, dtype, graphs=False)
    bank = graphed.prepare_bank(_spectra(1))
    params = _control(cuda, voices).snapshot_device()
    xs = _blocks(cuda, voices, 4)

    def run(sg, se, bank):
        for t, x in enumerate(xs):
            sg, out = graphed.step_coef_steady(sg, bank, params, x)
            se, want = eager.step_coef_steady(se, bank, params, x)
            assert torch.equal(out, want), f"block {t}"
        _assert_states_equal(sg, se, "after the run")
        return sg, se

    old, se = run(graphed.init_converged(bank, params),
                  eager.init_converged(bank, params), bank)
    assert graphed.steady_captures == 1
    first = weakref.ref(graphed._steady_graph)
    old_line = weakref.ref(old.fdl)
    state, se = run(graphed.init_converged(bank, params),
                    eager.init_converged(bank, params), bank)
    assert graphed.steady_captures == 2 and first() is None
    del old
    gc.collect()
    assert old_line() is None

    ir = np.random.default_rng(6).standard_normal((2, P * B)) * 0.1
    graphed.update_bank_slot(bank, 0, ir.astype(np.float32))
    state, se = run(state, se, bank)
    assert graphed.steady_captures == 2

    second = weakref.ref(graphed._steady_graph)
    swapped = graphed.prepare_bank(_spectra(2))
    state, se = run(state, se, swapped)
    assert graphed.steady_captures == 3 and second() is None
    assert (graphed.steady_replays, graphed.steady_eager) == (13, 3)

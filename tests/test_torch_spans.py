"""The session's spans and counters (utils/profiling.py Spans,
runtime/stream.py StreamSession(spans=)), on the CPU with a small fmajor
model: the span tree of each block, the rare spans on their own paths,
spans off reading no clock, the bounded store, the profiler's ranges, and
the counters in ``summary()``."""

import time

import numpy as np
import pytest
import torch

from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule
from tpu_audio_torch.utils.profiling import RANGE_PREFIX, Spans

torch.set_num_threads(1)

V, B = 2, 64
PER_BLOCK = ["gather", "step_choice", "params", "upload"]
RARE = {"control", "select", "bank_swap", "checkpoint", "clock_wait"}
# the rare spans that another's path opens too: a re-select comes by MIDI
ALSO = {"select": {"control"}}


def _model(sample_rate=44100):
    rng = np.random.default_rng(0)
    bank = IRBank(sample_rate=sample_rate)
    for k in range(3):
        bank.append(rng.uniform(-0.3, 0.3, (2, 150 + 40 * k))
                    .astype(np.float32))
    model = ConvolutionReverb(bank, num_voices=V, block=B, max_predelay=64,
                              sample_rate=sample_rate, device="cpu")
    for v in range(V):
        for ch in range(2):
            model.control.set_mapping(v, ch, CCMapping(select=21))
    return model


def _input(blocks):
    return (np.random.default_rng(1).standard_normal((V, 2, B * blocks))
            * 0.05).astype(np.float32)


def _run(blocks=6, spans=None, model=None, run_kwargs=None, **session_kw):
    model = model or _model()
    sink = WavSink("/dev/null", keep_data=True)
    session = model.session(WavSource(_input(blocks), V, B), sink,
                            warmup=0, spans=spans, **session_kw)
    session.run(model.init_state(), **(run_kwargs or {}))
    return session, sink


def _tree(spans):
    """{block id: [(name, id) of each child of that block's span]}, and
    the spans outside any block."""
    recs = spans.records()
    tree, roots = {}, []
    for r in recs:
        if r.parent is None:
            if r.name == "block":
                tree[r.block] = []
            else:
                roots.append((r.name, r.block))
        else:
            parent = recs[r.parent]
            assert parent.name == "block" and parent.parent is None, r
            tree[parent.block].append((r.name, r.block))
    return tree, roots


@pytest.mark.parametrize("mode", ["per_block", "chunk", "batched"])
def test_each_block_has_its_span_tree(mode):
    """Every span is a child of its iteration's block span, which carries
    the iteration's first block index; fetch_wait and sink carry the id of
    the block (chunk, batch) they deliver, one fetch behind."""
    kw = {"per_block": {}, "chunk": {"chunk_blocks": 4},
          "batched": {"fetch_batch": 2}}[mode]
    spans = Spans()
    session, sink = _run(blocks=12, spans=spans, **kw)
    tree, roots = _tree(spans)
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns
               for r in spans.records())
    step = [("step.chunk" if mode == "chunk" else "step.steady")]
    ids = list(range(0, 12, 4 if mode == "chunk" else 1))
    # the last iteration reads the source dry and ends the loop
    assert list(tree) == ids + [12]
    assert tree[12] == [("gather", 12)]
    for i, bid in enumerate(ids):
        names = [name for name, _ in tree[bid]]
        assert names[:6] == PER_BLOCK + step + ["fetch"], (bid, names)
        assert names[6] == "end_block"
        assert all(b == bid for _, b in tree[bid][:7])
        delivered = tree[bid][7:]
        if mode == "batched":
            # a batch of blocks (2k, 2k+1) is fetched at 2k+1 and
            # delivered when the next batch is fetched
            want = ([("fetch_wait", bid - 3), ("sink", bid - 3)]
                    if bid >= 3 and bid % 2 else [])
        else:
            want = ([("fetch_wait", ids[i - 1]), ("sink", ids[i - 1])]
                    if i else [])
        assert delivered == want, (bid, delivered)
    last = 10 if mode == "batched" else ids[-1]
    assert roots == [("fetch_wait", last), ("sink", last)]
    assert sink.data.shape == (V, 2, 12 * B)
    assert not RARE & {r.name for r in spans.records()}


@pytest.mark.parametrize("path", sorted(RARE))
def test_rare_spans_open_on_their_path_only(path, tmp_path):
    """control on a block whose MIDI message is due (a wet CC here),
    select on a MIDI re-select's block (inside control), bank_swap on a
    swap_bank, checkpoint on a save, clock_wait in a realtime run; no other
    rare span opens."""
    spans = Spans()
    run_kwargs, session_kw = {}, {}
    model = _model(sample_rate=2000 if path == "clock_wait" else 44100)
    if path == "select":
        run_kwargs["midi"] = MidiSchedule.parse("2 B0 15 40\n4 B0 15 7F\n")
    elif path == "control":
        for v in range(V):
            for ch in range(2):
                model.control.set_mapping(v, ch, CCMapping(select=21, wet=22))
        run_kwargs["midi"] = MidiSchedule.parse("2 B0 16 40\n4 B0 16 7F\n")
    elif path == "checkpoint":
        run_kwargs.update(checkpoint_path=tmp_path / "ckpt",
                          checkpoint_every=3)
    elif path == "clock_wait":
        session_kw["realtime"] = True
    session = model.session(WavSource(_input(6), V, B),
                            WavSink("/dev/null"), warmup=0, spans=spans,
                            **session_kw)
    if path == "bank_swap":
        session.swap_bank(model.spectra)
    session.run(model.init_state(), **run_kwargs)
    tree, _ = _tree(spans)
    where = {name: sorted(bid for bid, kids in tree.items()
                          for n, _ in kids if n == name) for name in RARE}
    want = {"control": [2, 4], "select": [2, 4], "bank_swap": [0],
            "checkpoint": [2, 5]}
    for name in RARE - {path}:
        want_there = want[path] if name in ALSO.get(path, ()) else []
        assert where[name] == want_there, (name, where)
    if path == "clock_wait":
        # a 32 ms block period: the CPU renders a block well inside it
        assert where["clock_wait"] and len(where["clock_wait"]) >= 3
        return
    assert where[path] == want[path]
    if path == "select":
        # the control span (the MIDI dispatch) and the select span open
        # before the block's step choice, and the fades then ride the
        # indexed step
        assert [n for n, _ in tree[2][:4]] == ["gather", "control", "select",
                                               "step_choice"]
        assert ("step.indexed", 2) in tree[2]


def test_spans_off_record_nothing_and_read_no_extra_clock(monkeypatch):
    """spans=None: no span is kept and the loop reads no nanosecond clock;
    spans on read it exactly twice per span."""
    calls = []
    clock = time.perf_counter_ns

    def counted():
        calls.append(1)
        return clock()

    monkeypatch.setattr(time, "perf_counter_ns", counted)
    session, sink_off = _run(blocks=6)
    assert session.spans is None and calls == []
    spans = Spans()
    _, sink_on = _run(blocks=6, spans=spans)
    assert len(calls) == 2 * len(spans.records()) > 0
    np.testing.assert_array_equal(sink_on.data, sink_off.data)


def test_the_store_is_bounded_and_counts_what_it_drops():
    spans = Spans(capacity=5)
    session, _ = _run(blocks=6, spans=spans)
    recs = spans.records()
    assert [r.name for r in recs] == ["block"] + PER_BLOCK
    assert spans.dropped > 0 and spans._stack == []
    assert spans.table()["block"]["count"] == 1
    unbounded = Spans()
    _run(blocks=6, spans=unbounded)
    assert len(unbounded.records()) == 5 + spans.dropped
    with pytest.raises(ValueError):
        Spans(capacity=0)


def test_table_counts_means_and_self_time():
    """table(): per name, count, mean and p99 duration, and mean self
    time (a span's duration less its children's)."""
    spans = Spans()
    spans.open("block", 7)
    spans.call("gather", time.sleep, 0.002)
    spans.open("sink", 3)
    spans.close()
    spans.close()
    recs = spans.records()
    assert [(r.name, r.block, r.parent) for r in recs] == [
        ("block", 7, None), ("gather", 7, 0), ("sink", 3, 0)]
    table = spans.table()
    dur = [(r.end_ns - r.start_ns) * 1e-6 for r in recs]
    assert table["gather"]["count"] == 1
    assert table["gather"]["mean_ms"] == table["gather"]["p99_ms"] == dur[1]
    assert table["gather"]["mean_ms"] >= 2.0
    assert table["block"]["self_ms"] == pytest.approx(
        dur[0] - dur[1] - dur[2], abs=1e-9)
    assert 0 <= table["block"]["self_ms"] < table["block"]["mean_ms"]


def test_profiler_ranges_are_the_records():
    """Under torch.profiler each span is a tpu_audio.<name> range: the same
    names in the same order, nested as the records are."""
    from torch.profiler import ProfilerActivity, profile

    spans = Spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(blocks=4, spans=spans,
             run_kwargs={"midi": MidiSchedule.parse("1 B0 15 40\n")})
    ranges = sorted((e for e in prof.events()
                     if e.name.startswith(RANGE_PREFIX)),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    recs = spans.records()
    assert [e.name for e in ranges] == [RANGE_PREFIX + r.name for r in recs]
    assert "tpu_audio.select" in {e.name for e in ranges}

    def enclosing(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(RANGE_PREFIX):
            p = p.cpu_parent
        return p

    for e, r in zip(ranges, recs):
        parent = enclosing(e)
        if r.parent is None:
            assert parent is None
        else:
            assert parent.name == RANGE_PREFIX + recs[r.parent].name
    # outside the profiler no range opens
    assert not torch.autograd._profiler_enabled()


def test_counters_in_the_summary():
    """upload_bytes is blocks x V x 2 x B x 4; a re-select block runs one
    collapse (collapse_pure while the fades stay in the span, the
    materializing one after a bank swap mid-fade broke it); a CPU engine
    captures no graph: every steady block is counted in steady_eager."""
    model = _model()
    midi = MidiSchedule.parse("2 B0 15 40\n5 B0 15 7F\n8 B0 15 20\n")
    sink = WavSink("/dev/null")
    session = model.session(WavSource(_input(10), V, B), sink, warmup=0)
    swap_at = []

    class SwapMidFade:
        def poll(self):
            swap_at.append(1)
            if len(swap_at) == 7:   # block 6, inside the fade from block 5
                session.swap_bank(model.spectra)
            return []

    session.run(model.init_state(), midi=midi, live_midi=SwapMidFade())
    c = session.summary()["counters"]
    assert c["upload_bytes"] == 10 * V * 2 * B * 4
    assert (c["collapses_pure"], c["collapses_full"]) == (2, 1)
    assert c["fetch_copies"] == c["fetch_bytes"] == 0   # CPU: no copies
    assert c["param_uploads"] == model.control.uploads >= 4
    assert c["indexed_blocks"] == session.indexed_blocks > 0
    assert c["general_blocks"] == session.general_blocks > 0
    assert c["underruns"] == session.underruns == 0
    steady = 10 - c["indexed_blocks"] - c["general_blocks"]
    assert c["steady_eager"] == steady > 0
    assert c["steady_captures"] == c["steady_replays"] == 0
    assert model.engine.steady_eager == steady

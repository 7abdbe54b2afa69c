"""The port's operational surface against the JAX package's, on the CPU:
the tools CLI (tpu_audio_torch/app/tools.py), make_index / write_index,
the content-addressed disk cache (utils/diskcache.py), IRBank's spectra
cache, ConvolutionReverb(cache_dir=) and the CLI's --cache-dir, --profile
(its span table and counters) and --chunk-blocks.

Every input is synthetic (WAVs written into tmp_path from a seed). The
tools print what the JAX tool prints for the same inputs, to the
character; a spectra cache entry written by either package is a hit for the
other, and the arrays are equal to the bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_audio.app.tools import main as jax_tools
from tpu_audio.engine.bank import IRBank as JaxIRBank
from tpu_audio.io.index import make_index as jax_make_index
from tpu_audio.utils import diskcache as jax_diskcache
from tpu_audio_torch.app.main import main as port_main
from tpu_audio_torch.app.tools import main as tools_main
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.io.index import load_index, make_index, write_index
from tpu_audio_torch.io.wav import write_wav
from tpu_audio_torch.models.reverb import ConvolutionReverb, ReverbGroups
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.checkpoint import save_checkpoint
from tpu_audio_torch.utils import diskcache, trace

torch.set_num_threads(1)


@pytest.fixture
def bank_dir(tmp_path):
    rng = np.random.default_rng(0)
    for k in range(3):
        write_wav(tmp_path / f"ir{k}.wav",
                  rng.uniform(-0.3, 0.3, (200 + 40 * k, 2)).astype(np.float32),
                  44100)
    return tmp_path


def _index(bank_dir):
    idx = bank_dir / "all.index"
    write_index(idx, make_index(bank_dir))
    return idx


# -- tests/test_tools_and_transport.py:19-82 on the port ----------------------------


def test_tools_makeindex(bank_dir):
    idx = bank_dir / "all.index"
    assert tools_main(["makeindex", str(bank_dir), "-o", str(idx)]) == 0
    lines = idx.read_text().strip().splitlines()
    assert len(lines) == 3
    assert all(line.endswith(".wav") for line in lines)


def test_tools_makeindex_empty(tmp_path):
    assert tools_main(["makeindex", str(tmp_path)]) == 1


def test_tools_prebuild_cache_and_bank_info(bank_dir, capsys):
    idx = _index(bank_dir)
    cache = bank_dir / "cache"
    assert tools_main(["prebuild-cache", str(idx), "--block", "64",
                       "--cache-dir", str(cache), "--quiet"]) == 0
    assert any(f.startswith("bank_") for f in os.listdir(cache))
    assert tools_main(["bank-info", str(idx), "--block", "64"]) == 0
    assert "3 IRs" in capsys.readouterr().out


def test_tools_inspect_checkpoint(tmp_path, capsys):
    rng = np.random.default_rng(1)
    bank = IRBank()
    bank.append(rng.standard_normal((2, 100)).astype(np.float32) * 0.2)
    model = ConvolutionReverb(bank, num_voices=1, block=32, max_predelay=64,
                              device="cpu")
    ckpt = tmp_path / "c.npz"
    save_checkpoint(ckpt, model.init_state(), model.control, meta={"x": 1})
    assert tools_main(["inspect-checkpoint", str(ckpt)]) == 0
    out = capsys.readouterr().out
    assert '"x": 1' in out
    assert "state.fdl: shape=" in out and "cp_select: shape=(1, 2)" in out


def _profiled_session(directory):
    """A 4-block CPU session under torch.profiler, its Chrome trace
    exported under `directory`; returns the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    bank = IRBank()
    bank.append(np.random.default_rng(2).standard_normal((2, 200))
                .astype(np.float32) * 0.2)
    model = ConvolutionReverb(bank, block=64, max_predelay=64, device="cpu")
    x = np.random.default_rng(3).standard_normal((1, 2, 256)).astype(
        np.float32) * 0.05
    session = model.session(WavSource(x, 1, 64), WavSink("/dev/null"),
                            warmup=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        session.run(model.init_state())
    path = os.path.join(directory, "run.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def test_tools_profile_trace(tmp_path, capsys):
    """`tools profile` summarises a torch.profiler trace: per category,
    the top events with counts and percentiles (the JAX tool's columns)."""
    path = _profiled_session(tmp_path)
    assert trace.newest_trace(tmp_path) == path
    assert tools_main(["profile", str(tmp_path), "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert f"trace: {path}" in out
    assert "category 'cpu_op'" in out and "total_ms" in out
    assert "aten::" in out
    events = trace.category_events(path)
    # the session's four FFTs of the input (ops/fft.py: torch.fft.rfft)
    assert len(events["cpu_op"]["aten::fft_rfft"]) == 4
    assert tools_main(["profile", path, "--top", "1"]) == 0
    # a missing trace errors cleanly
    assert tools_main(["profile", str(tmp_path / "nope")]) == 2


# -- the tools' stdout against the JAX tool's -------------------------------------------


@pytest.mark.parametrize("cmd", ["makeindex", "bank-info",
                                 "inspect-checkpoint"])
def test_tools_print_what_the_jax_tool_prints(bank_dir, capsys, cmd):
    if cmd == "makeindex":
        args = ["makeindex", str(bank_dir)]
    elif cmd == "bank-info":
        args = ["bank-info", str(_index(bank_dir)), "--block", "64"]
    else:
        bank = IRBank.from_index(_index(bank_dir), verbose=False)
        model = ConvolutionReverb(bank, num_voices=2, block=64,
                                  max_predelay=64, engine="cascade",
                                  cascade_ratio=2, device="cpu")
        ckpt = bank_dir / "port.ckpt"
        save_checkpoint(ckpt, model.init_state(), model.control,
                        meta={"block_index": 7})
        args = ["inspect-checkpoint", str(ckpt)]
    capsys.readouterr()
    assert tools_main(args) == 0
    port = capsys.readouterr().out
    assert jax_tools(args) == 0
    assert port == capsys.readouterr().out
    assert port.count("\n") >= 3


def test_make_and_load_index(tmp_path):
    """tests/test_index.py:10-23, and the JAX package's order."""
    bank = tmp_path / "bank"
    (bank / "sub").mkdir(parents=True)
    for name in ["b.wav", "a.WAV", "sub/c.wav", "sub/notes.txt"]:
        write_wav(bank / name, np.zeros((10, 2), np.float32), 44100)
    entries = make_index(bank)
    assert len(entries) == 3
    assert entries == sorted(entries) == jax_make_index(bank)
    idx = tmp_path / "bank.index"
    write_index(idx, entries)
    assert load_index(idx) == entries


# -- the disk cache -----------------------------------------------------------------------


def test_diskcache_roundtrip_and_torn_entries(tmp_path):
    """tests/test_utils.py:87-111: manifest-gated loads, None fields
    recorded absent, torn entries are misses, legacy entries load when
    every file exists; and the JAX package reads the port's entry."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    diskcache.store(tmp_path, "e1", {"head": a, "tail": a * 2, "opt": None})
    got = diskcache.load(tmp_path, "e1", ["head", "tail", "opt"])
    assert got is not None
    np.testing.assert_array_equal(np.asarray(got["head"]), a)
    np.testing.assert_array_equal(np.asarray(got["tail"]), a * 2)
    assert got["opt"] is None
    theirs = jax_diskcache.load(tmp_path, "e1", ["head", "tail", "opt"])
    np.testing.assert_array_equal(np.asarray(theirs["tail"]), a * 2)
    assert sorted(os.listdir(tmp_path)) == ["e1.ok", "e1_head.npy",
                                            "e1_tail.npy"]
    assert diskcache.load(tmp_path, "nope", ["head"]) is None
    (tmp_path / "e1_tail.npy").unlink()
    assert diskcache.load(tmp_path, "e1", ["head", "tail"]) is None
    np.save(tmp_path / "leg_head.npy", a)
    got = diskcache.load(tmp_path, "leg", ["head"])
    np.testing.assert_array_equal(np.asarray(got["head"]), a)
    assert diskcache.load(tmp_path, "leg", ["head", "tail"]) is None
    assert (diskcache.content_key("pack", (64, 2), a)
            == jax_diskcache.content_key("pack", (64, 2), a))


def _banks(bank_dir):
    idx = _index(bank_dir)
    return (IRBank.from_index(idx, verbose=False),
            JaxIRBank.from_index(idx, verbose=False))


def test_spectra_cache_roundtrip(bank_dir, monkeypatch):
    """The cache half of tests/test_engine.py:354-369 on synthetic IRs: a
    miss writes, a hit reads the same array by mmap without recomputing."""
    bank, _ = _banks(bank_dir)
    cache = bank_dir / "cache"
    c1 = bank.cached_partitioned_spectra(64, cache)
    np.testing.assert_array_equal(c1, bank.partitioned_spectra(64))
    monkeypatch.setattr(bank, "partitioned_spectra", None)   # hits only
    c2 = bank.cached_partitioned_spectra(64, cache)
    assert isinstance(c2, np.memmap) and not c2.flags.writeable
    np.testing.assert_array_equal(c1, c2)
    assert [f for f in os.listdir(cache) if "tmp" in f] == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_reads_the_others_cache(bank_dir, monkeypatch,
                                               writer):
    """A bank_<key>.npy the JAX prebuild-cache writes is a hit for the port,
    and one the port's tool writes is a hit for the JAX package: the same
    key over the same IR bytes, the same array to the bit."""
    idx = _index(bank_dir)
    cache = bank_dir / "cache"
    args = ["prebuild-cache", str(idx), "--block", "64", "--cache-dir",
            str(cache), "--quiet"]
    assert (jax_tools if writer == "jax" else tools_main)(args) == 0
    (entry,) = os.listdir(cache)
    written = np.load(cache / entry)
    bank, jbank = _banks(bank_dir)
    reader = jbank if writer == "port" else bank
    monkeypatch.setattr(reader, "partitioned_spectra", None)  # hits only
    got = reader.cached_partitioned_spectra(64, cache)
    np.testing.assert_array_equal(np.asarray(got), written)
    assert os.listdir(cache) == [entry]
    assert bank._cache_key("part", 64, None, 0) == jbank._cache_key(
        "part", 64, None, 0)


def test_legacy_npz_entry_is_honoured(bank_dir):
    bank, _ = _banks(bank_dir)
    cache = bank_dir / "cache"
    cache.mkdir()
    key = bank._cache_key("part", 64, None, 0)
    want = bank.partitioned_spectra(64)
    np.savez(cache / f"bank_{key}.npz", spectra=want)
    np.testing.assert_array_equal(bank.cached_partitioned_spectra(64, cache),
                                  want)


def test_model_cache_dir_routes(bank_dir, monkeypatch):
    """cache_dir: the partitioned route reads and writes the spectra cache
    (its second build is a hit and computes nothing); fmajor preps its bank
    on the device and leaves the cache alone; ReverbGroups passes it on."""
    bank, _ = _banks(bank_dir)
    cache = bank_dir / "cache"
    kw = dict(num_voices=1, block=64, max_predelay=64, device="cpu",
              cache_dir=cache)
    m1 = ConvolutionReverb(bank, engine="partitioned", **kw)
    assert len(os.listdir(cache)) == 1
    monkeypatch.setattr(bank, "partitioned_spectra", None)   # hits only
    m2 = ConvolutionReverb(bank, engine="partitioned", **kw)
    assert torch.equal(m1.spectra, m2.spectra)
    ConvolutionReverb(bank, engine="fmajor", **kw)
    assert len(os.listdir(cache)) == 1
    settings = bank_dir / "settings.txt"
    settings.write_text("conv.count 2\n" + "".join(
        f"conv[{i}].index {bank_dir / 'all.index'}\n"
        f"conv[{i}].fftSize 1024\nconv[{i}].maxPredelay 64\n"
        for i in range(2)))
    groups = ReverbGroups.from_settings(str(settings), engine="partitioned",
                                        block=64, verbose=False,
                                        device="cpu", cache_dir=cache)
    assert torch.equal(groups.models[0].spectra, m1.spectra)


# -- the CLI's --profile, --cache-dir and --chunk-blocks -----------------------------------


def test_cli_profile_cache_dir_and_chunk_blocks(bank_dir, capsys,
                                                monkeypatch):
    idx = _index(bank_dir)
    settings = bank_dir / "settings.txt"
    settings.write_text("conv.count 2\n" + "".join(
        f"conv[{i}].index {idx}\nconv[{i}].fftSize 1024\n"
        f"conv[{i}].maxPredelay 64\nconv[{i}].cc.message 176\n"
        f"conv[{i}].cc.select 21\nconv[{i}].value.wet 0.7\n"
        f"conv[{i}].value.dry 0.2\n" for i in range(2)))
    (bank_dir / "events.txt").write_text("4 B0 15 40\n")
    common = ["--settings", str(settings), "--signal", "noise",
              "--blocks", "10", "--block-size", "64", "--device", "cpu",
              "--midi", str(bank_dir / "events.txt")]
    outs = {}
    for chunk in (1, 4):
        out = bank_dir / f"chunk{chunk}.wav"
        assert port_main(common + ["--chunk-blocks", str(chunk), "--output",
                                   str(out)]) == 0
        outs[chunk] = out.read_bytes()
    assert outs[1] == outs[4]    # the event at 4 is on the chunk grid
    prof = bank_dir / "prof"
    cache = bank_dir / "cache"
    for run in range(2):
        assert port_main(common + ["--engine", "partitioned", "--cache-dir",
                                   str(cache), "--chunk-blocks", "4",
                                   "--profile", str(prof), "--output",
                                   str(bank_dir / f"p{run}.wav")]) == 0
        assert len(os.listdir(cache)) == 1
        # the second run must hit: computing the spectra would raise
        monkeypatch.setattr(IRBank, "partitioned_spectra", None)
    assert "streamed 10 blocks" in capsys.readouterr().out
    assert ((bank_dir / "p0.wav").read_bytes()
            == (bank_dir / "p1.wav").read_bytes())
    traces = sorted(os.listdir(prof))
    assert traces == [f"{os.getpid()}.pt.trace.json"]
    with open(prof / traces[0]) as fh:
        assert any(ev.get("cat") == "cpu_op"
                   for ev in json.load(fh)["traceEvents"])
    assert tools_main(["profile", str(prof)]) == 0
    assert "category 'cpu_op'" in capsys.readouterr().out


def test_cli_profile_prints_the_span_table_and_counters(bank_dir, capsys):
    """--profile records the session's spans: their table and the
    session's counters follow the summary line, and the Chrome trace
    carries them as tpu_audio.* ranges."""
    idx = _index(bank_dir)
    settings = bank_dir / "settings.txt"
    settings.write_text("conv.count 2\n" + "".join(
        f"conv[{i}].index {idx}\nconv[{i}].maxPredelay 64\n"
        f"conv[{i}].cc.message 176\nconv[{i}].cc.select 21\n"
        for i in range(2)))
    (bank_dir / "events.txt").write_text("4 B0 15 40\n")
    prof = bank_dir / "prof"
    assert port_main(["--settings", str(settings), "--signal", "noise",
                      "--blocks", "10", "--block-size", "64", "--voices",
                      "3", "--device", "cpu", "--midi",
                      str(bank_dir / "events.txt"), "--profile",
                      str(prof)]) == 0
    lines = capsys.readouterr().out.splitlines()
    first = next(i for i, line in enumerate(lines)
                 if line.startswith("spans: "))
    assert lines[first - 1].startswith("streamed 10 blocks")
    assert lines[first].split()[1:] == ["name", "count", "mean_ms",
                                        "p99_ms", "self_ms"]
    rows = {}
    for line in lines[first + 1:]:
        if not line.startswith("spans: "):
            break
        name, count, *ms = line.split()[1:]
        rows[name] = (int(count), [float(x) for x in ms])
    assert list(rows)[:5] == ["block", "gather", "step_choice", "params",
                              "upload"]
    assert rows["block"][0] == 10 and rows["select"][0] == 1
    assert rows["step.indexed"][0] + rows["step.steady"][0] == 10
    assert rows["fetch_wait"][0] == rows["sink"][0] == 10
    assert all(mean >= 0 and p99 >= 0 and mean >= own >= 0
               for _, (mean, p99, own) in rows.values())
    counters = dict(item.rsplit(" ", 1) for item in
                    lines[first + 1 + len(rows)]
                    .removeprefix("counters: ").split(" | "))
    assert int(counters["upload_bytes"]) == 10 * 3 * 2 * 64 * 4
    assert int(counters["collapses_pure"]) == 1
    assert int(counters["indexed_blocks"]) == rows["step.indexed"][0]
    with open(trace.newest_trace(prof)) as fh:
        ranges = [ev["name"] for ev in json.load(fh)["traceEvents"]
                  if ev.get("cat") == "user_annotation"]
    assert ranges.count("tpu_audio.block") == 10
    assert ranges.count("tpu_audio.select") == 1


def test_cli_refuses_chunks_on_a_slew_engine(bank_dir):
    idx = _index(bank_dir)
    settings = bank_dir / "settings.txt"
    settings.write_text("conv.count 2\n" + "".join(
        f"conv[{i}].index {idx}\nconv[{i}].fftSize 1024\n"
        f"conv[{i}].maxPredelay 64\n" for i in range(2)))
    with pytest.raises(ValueError, match="chunk_blocks"):
        port_main(["--settings", str(settings), "--blocks", "4",
                   "--block-size", "64", "--device", "cpu", "--quiet",
                   "--engine", "monolithic", "--chunk-blocks", "8"])

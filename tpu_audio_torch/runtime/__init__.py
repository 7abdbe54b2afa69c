from tpu_audio_torch.runtime.backends import (
    BlockSource, BlockSink, WavSource, WavSink, NoiseSource, SilenceSource,
    ImpulseSource, CallbackSource, CallbackSink, NullSink, LoopbackBuffer,
)
from tpu_audio_torch.runtime.stream import StreamSession, MidiSchedule
from tpu_audio_torch.runtime.checkpoint import save_checkpoint, load_checkpoint
from tpu_audio_torch.runtime.recovery import run_resilient

__all__ = [
    "BlockSource", "BlockSink", "WavSource", "WavSink", "NoiseSource",
    "SilenceSource", "ImpulseSource", "CallbackSource", "CallbackSink",
    "NullSink", "LoopbackBuffer",
    "StreamSession", "MidiSchedule",
    "save_checkpoint", "load_checkpoint", "run_resilient",
]

from tpu_audio_torch.runtime.backends import (
    BlockSource, BlockSink, WavSource, WavSink, NoiseSource, SilenceSource,
    ImpulseSource, NullSink,
)
from tpu_audio_torch.runtime.stream import StreamSession, MidiSchedule

__all__ = [
    "BlockSource", "BlockSink", "WavSource", "WavSink", "NoiseSource",
    "SilenceSource", "ImpulseSource", "NullSink",
    "StreamSession", "MidiSchedule",
]

"""Multi-device serving: the voice x partition mesh (parallel/mesh.py)."""

from tpu_audio_torch.parallel.mesh import (
    Mesh, ShardedBank, ShardedEngine, ShardedState, VoiceShards, make_mesh,
    place_bank, place_cascade, place_state, shard_cascade_collapse,
    shard_cascade_collapse_pure, shard_cascade_step, shard_collapse,
    shard_fmajor_collapse, shard_fmajor_collapse_pure, shard_fmajor_step,
    shard_partitioned_step,
)

__all__ = [
    "Mesh", "ShardedBank", "ShardedEngine", "ShardedState", "VoiceShards",
    "make_mesh", "place_bank", "place_cascade", "place_state",
    "shard_cascade_collapse", "shard_cascade_collapse_pure",
    "shard_cascade_step", "shard_collapse", "shard_fmajor_collapse",
    "shard_fmajor_collapse_pure", "shard_fmajor_step",
    "shard_partitioned_step",
]

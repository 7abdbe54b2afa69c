from tpu_audio_torch.engine.params import (
    CCMapping, VoiceParams, ControlPlane, CC_MAX_PREDELAY, CC_MAX_SPEED,
)
from tpu_audio_torch.engine.bank import IRBank
from tpu_audio_torch.engine.cascade import (
    CascadeBank, CascadeConvolution, CascadeState,
)
from tpu_audio_torch.engine.fmajor import (
    FMajorBank, FMajorPartitionedConvolution, FMajorState,
)
from tpu_audio_torch.engine.monolithic import (
    MonolithicConvolution, MonolithicState,
)
from tpu_audio_torch.engine.partitioned import (
    PartitionedConvolution, PartitionedState,
)

__all__ = [
    "CascadeBank", "CascadeConvolution", "CascadeState",
    "FMajorBank", "FMajorPartitionedConvolution", "FMajorState",
    "MonolithicConvolution", "MonolithicState",
    "PartitionedConvolution", "PartitionedState",
    "CCMapping", "VoiceParams", "ControlPlane", "CC_MAX_PREDELAY", "CC_MAX_SPEED",
    "IRBank",
]

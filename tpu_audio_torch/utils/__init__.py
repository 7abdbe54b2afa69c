from tpu_audio_torch.utils.log import Log
from tpu_audio_torch.utils.device import pin_full_f32, select_gpu
from tpu_audio_torch.utils.profiling import BlockTimer, Spans

__all__ = ["Log", "pin_full_f32", "select_gpu", "BlockTimer", "Spans"]

from tpu_audio_torch.models.reverb import ConvolutionReverb

__all__ = ["ConvolutionReverb"]

"""Command-line application: ``python -m tpu_audio_torch.app``."""

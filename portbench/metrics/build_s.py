"""build_s: host span around the model build (ConvolutionReverb with its
device prep, engine/device_prep.py), the warm-up session's blocks of
silence and the window's fresh state, synchronised at its end."""

def read(run):
    return run.build_s

"""control_ms: the mean, over the traced window's blocks before its
profiled slice on which a MIDI message was due, of the session's
``control`` span (runtime/stream.py: the block's scripted and live
messages applied to the control plane, engine/params.py
apply_midi_message), in milliseconds. None where the program has no such
span."""

import numpy as np


def read(run):
    ms = getattr(run, "span_ms", {}).get("control")
    return float(np.mean(ms)) if ms else None

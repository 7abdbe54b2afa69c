"""voice_s_per_s: voice-seconds of input delivered per second of the
window: every block delivered, times the voices, times B / rate, over the
host-clock time from the source's first block to the sink's last. It is
the number of voices the card sustains in real time at this shape."""

def read(run):
    if len(run.deliver_stamps) == 0:
        return None
    wall = run.deliver_stamps[-1] - run.t_first_read
    audio = len(run.deliver_stamps) * run.voices * run.block / run.sample_rate
    return audio / wall

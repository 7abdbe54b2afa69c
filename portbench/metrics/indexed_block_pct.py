"""indexed_block_pct: the share, in percent, of the traced run's blocks
that rode the crossfading step (the session's ``indexed_blocks`` counter
over the blocks it streamed): near 100 while fades overlap without a
break, lower where the session returns to the steady step."""


def read(run):
    counters = getattr(run, "counters", None)
    blocks = getattr(run, "blocks", 0)
    if not counters or "indexed_blocks" not in counters or not blocks:
        return None
    return 100.0 * counters["indexed_blocks"] / blocks

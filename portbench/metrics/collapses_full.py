"""collapses_full: the re-selects the session served by the materializing
collapse over the traced run (its ``collapses_full`` counter). 0 while
every fade stays in the bank's span; a change that sends span fades
through the materializing collapse shows here."""


def read(run):
    counters = getattr(run, "counters", None)
    if not counters or "collapses_full" not in counters:
        return None
    return float(counters["collapses_full"])

"""ring_mac_roofline: the ring MAC's roofline time per call, from the
cell's shapes (F, VI, Pp, KOD and the operand dtype; portbench/roofline.py),
times the MAC launches in the profiled slice, over the device time of
those launches, in percent. The MAC's kernels are those of
ops/ring_mac.py -> csrc/ring_mac.cu named below; which one runs does not
change the work counted."""

import re

from portbench.roofline import ring_mac_work, roofline_s

KERNELS = re.compile(r"\bring_mac(_small|_bf16)?_kernel\b")


def read(run):
    prof = run.profile
    if prof is None:
        return None
    seconds = launches = 0
    for name, (sec, count) in prof["kernels"].items():
        if KERNELS.search(name):
            seconds += sec
            launches += count
    if launches == 0 or seconds <= 0:
        return None
    s = run.shapes
    bound, _ = roofline_s(*ring_mac_work(s["F"], s["VI"], s["Pp"], s["KOD"],
                                         s["dtype"]), s["dtype"])
    return 100.0 * bound * launches / seconds

"""rt_live_share: share (%) of the lanes kernels A, A' and B are launched
over that carry a live ray, all depths: the program's counters
live_closest_d* (rays A traces live) and cast_shadow_d* (segments B
traces live) over the traced window's replayed frames, against the
lanes the kernel wrappers launch a frame (tracing.lanes, the graph's
span table) times those frames (spans_window.py). The counters are read
from the program (`program_counter`)."""

import spans_window

KERNELS = ("trace_closest", "trace_occluded", "occl_multi")


def read(run):
    win = spans_window.window(run)
    if win is None:
        return None
    live = sum(v for k, v in win.counters.items()
               if k.startswith(("live_closest_d", "cast_shadow_d")))
    lanes = sum(n for k, _, n in win.lanes if k in KERNELS) * win.n
    return 100.0 * live / lanes if lanes else None

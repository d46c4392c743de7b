"""raster_live_share: share (%) of the lanes kernel G is launched over
that carry a live sample, every round: the program's counters
raster_live_r* (the samples not parked as each discard round enters G)
over the traced window's replayed frames, against the lanes G's wrapper
launches a frame (tracing.lanes, the graph's span table) times those
frames (spans_window.py). The counters are read from the program
(`program_counter`)."""

import spans_window


def read(run):
    win = spans_window.window(run)
    if win is None:
        return None
    live = sum(v for k, v in win.counters.items()
               if k.startswith("raster_live_r"))
    lanes = sum(n for k, _, n in win.lanes if k == "raster_edge") * win.n
    return 100.0 * live / lanes if lanes else None

"""raster_fetch_share: share (%) of the lanes kernel G is launched over
whose base-colour texel the discard round's sample fetches: the
program's counters raster_fetch_r* (the lanes G hit in each round)
over the traced window's replayed frames, against the lanes G's wrapper
launches a frame (tracing.lanes, the graph's span table) times those
frames (spans_window.py). The counters are read from the program
(`program_counter`). None where the program keeps no such counter."""

import spans_window


def read(run):
    win = spans_window.window(run)
    if win is None:
        return None
    fetched = [v for k, v in win.counters.items()
               if k.startswith("raster_fetch_r")]
    lanes = sum(n for k, _, n in win.lanes if k == "raster_edge") * win.n
    return 100.0 * sum(fetched) / lanes if fetched and lanes else None

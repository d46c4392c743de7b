"""raster_clip_share: share (%) of the clusters holding a triangle that
crosses w = 0 whose clipped sheet still reaches the screen: the
program's counters raster_clip_kept over raster_clip_cross (the raster
setup's kernel J, raster/edge.py::build_raster_setup), summed over the
traced window's replayed frames (spans_window.py). The rest get no box
from those triangles, where they once had the whole screen. The counters
are read from the program (`program_counter`). None where the program
keeps no such counters, or no cluster crossed."""

import spans_window


def read(run):
    win = spans_window.window(run)
    if win is None:
        return None
    cross = win.counters.get("raster_clip_cross", 0)
    kept = win.counters.get("raster_clip_kept", 0)
    return 100.0 * kept / cross if cross else None

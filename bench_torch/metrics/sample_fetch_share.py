"""sample_fetch_share: share (%) of the lanes the ray tracer's material
sample (kernel K, shade/sampling.py::sample_hits) is launched over whose
48-byte heap row it reads: the program's counters sample_fetch_d* (the
lanes that hit at each depth) over the traced window's replayed frames,
against the lanes sample_hits launches a frame (tracing.lanes, the
graph's span table) times those frames (spans_window.py). The counters
are read from the program (`program_counter`). None where the program
keeps no such counter."""

import spans_window


def read(run):
    win = spans_window.window(run)
    if win is None:
        return None
    fetched = [v for k, v in win.counters.items()
               if k.startswith("sample_fetch_d")]
    lanes = sum(n for k, _, n in win.lanes if k == "sample_hits") * win.n
    return 100.0 * sum(fetched) / lanes if fetched and lanes else None

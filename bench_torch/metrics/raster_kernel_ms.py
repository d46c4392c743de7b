"""raster_kernel_ms: device ms a frame of kernel G (raster/edge.py,
csrc/raster_edge.cu): the traced window's ops of layer 'raster'
(stats.layer_of) summed over its frames; torch.profiler. None where the
window ran none."""

import stats


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = sum(e - s for n, s, e in tr.ops if stats.layer_of(n) == "raster")
    return 1e3 * t / tr.frames if t > 0 else None

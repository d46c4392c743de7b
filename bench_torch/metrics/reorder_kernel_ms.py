"""reorder_kernel_ms: device ms a frame of kernels C-F
(wavefront/pack.py, wavefront/lanesort.py): the traced window's ops of
layer 'reorder' (stats.layer_of) summed over its frames; torch.profiler.
None where the window ran none."""

import stats


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = sum(e - s for n, s, e in tr.ops if stats.layer_of(n) == "reorder")
    return 1e3 * t / tr.frames if t > 0 else None

"""rt_kernel_ms: device ms a frame of kernels A, A' and B
(rt/dense.py, rt/occl_multi.py): the traced window's ops of layer 'rt'
(stats.layer_of) summed over its frames; torch.profiler. None where the
window ran none."""

import stats


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = sum(e - s for n, s, e in tr.ops if stats.layer_of(n) == "rt")
    return 1e3 * t / tr.frames if t > 0 else None

"""torch_ops_ms: device ms a frame of every kernel that is not one of the
port's own (shading, sampling, engine glue; in c5 the accel update's
PyTorch kernels too): the traced window's ops of layer 'torch'
(stats.layer_of) summed over its frames; torch.profiler. None where the
window ran none."""

import stats


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = sum(e - s for n, s, e in tr.ops if stats.layer_of(n) == "torch")
    return 1e3 * t / tr.frames if t > 0 else None

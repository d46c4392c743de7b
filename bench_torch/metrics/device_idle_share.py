"""device_idle_share: share (%) of the traced window in which no device
operation ran (the window less the union of device activity);
torch.profiler."""

import stats


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * stats.idle_share([(s, e) for _, s, e in tr.ops],
                                    tr.lo, tr.hi)

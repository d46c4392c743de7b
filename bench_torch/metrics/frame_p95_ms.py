"""frame_p95_ms: 95th percentile (nearest rank), over every frame of the
window, of the time from its submit call to its u8 frame on the host;
host clock."""

import stats


def read(run):
    return stats.percentile(run.window.latency_ms, 95)

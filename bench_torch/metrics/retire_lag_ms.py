"""retire_lag_ms: how long a finished frame takes to reach the host as
numpy: the host end of its `vkrt.retire` span (FrameScheduler: the event
wait, the wake-up, the conversion) less the device end of its `frame`
span (its closing mark), which holds the clone and the pinned download
after it too; mean over the traced window's frames after the first
`inflight` (spans_window.py); torch.profiler, the device time put on
the host's clock (spans_window.to_host_clock)."""

import spans_window


def read(run):
    pairs = spans_window.host_vs_frames(spans_window.window(run),
                                        "vkrt.retire")
    if not pairs:
        return None
    return 1e3 * sum(h[1] - f.end for h, f in pairs) / len(pairs)

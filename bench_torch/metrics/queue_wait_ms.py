"""queue_wait_ms: how long a frame waits in the card's queue: the device
start of its `frame` span (its opening mark) less the host start of its
`vkrt.submit` span (FrameScheduler.submit), mean over the traced
window's frames after the first `inflight` (spans_window.py);
torch.profiler, the device time put on the host's clock
(spans_window.to_host_clock)."""

import spans_window


def read(run):
    pairs = spans_window.host_vs_frames(spans_window.window(run),
                                        "vkrt.submit")
    if not pairs:
        return None
    return 1e3 * sum(f.start - h[0] for h, f in pairs) / len(pairs)

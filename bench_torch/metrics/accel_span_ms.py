"""accel_span_ms: device ms of the `accel_update` span of the frame's own
graph (Renderer.frame_body: the instance transform and the rebuild or
refit), from its opening mark's start to its closing mark's end, mean
over the traced window's replayed frames (spans_window.py);
torch.profiler. None where no frame updates the tree or the program
leaves no marks."""

import spans_window


def read(run):
    win = spans_window.window(run)
    if win is None:
        return None
    ms = [(s.end - s.start) * 1e3 for f in win.frames for s in f
          if s.name == "accel_update"]
    return sum(ms) / len(win.frames) if ms else None

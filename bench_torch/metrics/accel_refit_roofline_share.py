"""accel_refit_roofline_share: the per-frame refit's roofline bound over
its device time, in %. The bound is rooflines.refit_bound_ms of the
set-up tree's layout (`Renderer.backend.tree`, whose shapes a refit
keeps): bytes and operations counted by the benchmark, not the program.
The time is the device ms a frame of the kernels inside the frame's
`accel_refit` span (accel/refit.py::refit_clusters under
Renderer.frame_body's `accel_update`), read from the span marks of the
traced window's replayed frames (spans_window.py); torch.profiler. None
where the program leaves no such span (no frame refits its tree, or a
program without the span)."""

import rooflines
import spans_window


def read(run):
    ms = spans_window.span_ms(spans_window.window(run), "accel_refit")
    if not ms:
        return None
    tree = run.state.entry.program.backend.tree
    return 100.0 * rooflines.refit_bound_ms(tree) / ms

"""accel_order_ms: device ms a frame of the kernels inside the frame's
`accel_order` span: the order step of a full rebuild (the Morton codes
and their stable sort in "full_morton", device_sah_order with kernel H
in "full"; accel/clusters.py::build_clusters under
Renderer.frame_body's `accel_update`), read from the span marks of the
traced window's replayed frames (spans_window.py); torch.profiler. None
where no frame rebuilds its tree or the program leaves no such span."""

import spans_window


def read(run):
    return spans_window.span_ms(spans_window.window(run), "accel_order")

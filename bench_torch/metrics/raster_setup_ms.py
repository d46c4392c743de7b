"""raster_setup_ms: device ms a frame of the kernels inside the raster
frame's `raster_setup` span (the vertex and triangle-setup stage in
float64 and the screen boxes, raster/edge.py::build_raster_setup), read
from the span marks of the traced window's replayed frames
(spans_window.py); torch.profiler. None where the program leaves no such
marks."""

import spans_window


def read(run):
    return spans_window.span_ms(spans_window.window(run), "raster_setup")

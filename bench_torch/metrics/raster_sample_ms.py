"""raster_sample_ms: device ms a frame of the kernels inside the raster
frame's `raster_sample` spans (each discard round's material sample,
alpha test and depth floor, raster/pipeline.py), read from the span
marks of the traced window's replayed frames (spans_window.py);
torch.profiler. None where the program leaves no such marks."""

import spans_window


def read(run):
    return spans_window.span_ms(spans_window.window(run), "raster_sample")

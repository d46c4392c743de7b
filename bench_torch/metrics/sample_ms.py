"""sample_ms: device ms a frame of the kernels inside the frame's
`sample_d*` spans (the material samples, shade/sampling.py), read from
the span marks of the traced window's replayed frames (spans_window.py);
torch.profiler. None where the program leaves no marks."""

import spans_window


def read(run):
    return spans_window.span_ms(spans_window.window(run), "sample_d")

"""host_enqueue_ms: host time of one frame call (Renderer.render_async:
the frame's inputs copied in, the graph replayed, its outputs cloned) on
an idle card, mean over the traced window's path frames (run.py's
enqueue_probe); host clock. Submitted to an idle card, the launch does
not wait for room in the card's command buffer, so the reading is the
host's own work and not the device's pace."""


def read(run):
    e = run.trace.enqueue_ms if run.trace else []
    return sum(e) / len(e) if e else None

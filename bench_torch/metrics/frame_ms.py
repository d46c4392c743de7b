"""frame_ms: the window's wall time over the frames retired in it (every
frame submitted in the window, drained); host clock."""


def read(run):
    w = run.window
    return 1e3 * w.wall_s / w.frames

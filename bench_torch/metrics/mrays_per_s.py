"""mrays_per_s: every ray of the window's frames (each frame's own count,
read from its outputs) over the window's seconds, in millions; host
clock."""

import stats


def read(run):
    w = run.window
    return stats.rate(w.rays_total, w.wall_s) / 1e6

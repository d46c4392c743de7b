"""Morton codes — counterpart of vkrt_tpu/accel/lbvh.py's `morton30`.

Only the code computation is here (the Morton order of the per-frame
rebuild, accel/clusters.build_clusters method="morton"); the LBVH build
and its traversal are not ported (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import torch


def _expand_bits10(v):
    """Spread 10 bits so there are 2 zero bits between each."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton30(points, lo, hi):
    """30-bit Morton codes i32[N] of points f32[N,3] normalised into
    [lo, hi] (f32[3] each)."""
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((points - lo) / extent * 1024.0, 0.0, 1023.0)
    q = q.to(torch.int32)
    return ((_expand_bits10(q[:, 0]) << 2) | (_expand_bits10(q[:, 1]) << 1)
            | _expand_bits10(q[:, 2]))

"""Faults planted under the timed path, each a wrapper of an entry's
frame function: what `correct` has to catch. calibrate.py reads them on
the card at a cell's own size; tests/test_faults.py at a size the CPU
holds."""


def stale(fn):
    """A frame that returns its state unchanged: the first frame's
    outputs, whatever the camera."""
    first = []

    def f(pose, m):
        out = fn(pose, m)
        if not first:
            first.append(tuple(t.clone() for t in out))
        return first[0]
    return f


def half(fn):
    """Half of the rays left out: the odd rows are not traced, each takes
    the row above it, the mean over the rest."""
    def f(pose, m):
        fb, rays = fn(pose, m)
        fb = fb.clone()
        fb[1::2] = fb[0:fb.shape[0] - 1:2][: fb[1::2].shape[0]]
        return fb, rays
    return f


def flipped(fn):
    """An answer altered where it is produced: the frame upside down (the
    Vulkan y flip applied twice)."""
    def f(pose, m):
        fb, rays = fn(pose, m)
        return fb.flip(0).contiguous(), rays
    return f


ALL = (stale, half, flipped)

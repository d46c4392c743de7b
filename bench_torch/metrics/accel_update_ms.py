"""accel_update_ms: device time of the per-frame accel update alone
(what Renderer.update_tree enqueues: the instance transform and the
rebuild or refit of the tree), captured as a CUDA graph of its own with
the port's FrameGraph and replayed over the path's instance transforms,
each replay between two CUDA events (its 88-byte input copy included).
The transforms are every path frame's, strided to REPLAYS, the same on
every seed. None where the traffic moves nothing or the program is not
the Renderer."""

REPLAYS = 24


def read(run):
    import torch
    from vkrt_tpu_torch import graphs
    st = run.state
    r = st.entry.program
    if not run.cuda or not hasattr(r, "_update_tree"):
        return None
    mats = [st.frames.at(k)[1] for k in range(len(st.frames))]
    mats = [m for m in mats if m is not None]
    if not mats:
        return None
    mats = mats[::max(1, len(mats) // REPLAYS)][:REPLAYS]
    fg = graphs.FrameGraph()
    key = ("accel_update", r.rebuild)
    fg.run(key, r._update_tree, (r.update_inputs(mats[-1]),), r.device,
           copy=False)                          # warm-up and capture
    total = 0.0
    for m in mats:
        x = r.update_inputs(m)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fg.run(key, r._update_tree, (x,), r.device, copy=False)
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    fg.free()
    return total / len(mats)

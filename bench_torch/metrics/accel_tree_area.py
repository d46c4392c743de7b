"""accel_tree_area: the summed surface area of the cluster boxes of the
tree each frame's accel update built, mean over the traced window's
frames, in % of the same sum over the tree the program built at set-up
(`Renderer.backend.tree`, the host SAH build, which no update replaces).
The frames' sums are the program's counter `accel_cl_area`
(program_counter: Renderer.frame_body counts it while tracing is on,
in 1/2^16 squared world units); the set-up tree's by the program's own
`accel/clusters.py::cluster_area_fixed`. A larger share is a worse
tree: more rays enter each cluster box, so kernels A, A' and B sweep
more (ray, triangle) pairs. None where the program counts no such area
(no frame updates its tree, or a program without the counter)."""

import spans_window


def read(run):
    win = spans_window.window(run)
    if win is None or not win.counters.get("accel_cl_area"):
        return None
    try:
        from vkrt_tpu_torch.accel.clusters import cluster_area_fixed
    except ImportError:
        return None
    base = int(cluster_area_fixed(run.state.entry.program.backend.tree
                                  .cl_boxes))
    return 100.0 * win.counters["accel_cl_area"] / win.n / base

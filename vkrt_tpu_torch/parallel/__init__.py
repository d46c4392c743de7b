from vkrt_tpu_torch.parallel.mesh import make_mesh, render_frame_sharded

__all__ = ["make_mesh", "render_frame_sharded"]

"""vkrt_tpu_torch — the wavefront ray tracer on PyTorch + CUDA (NVIDIA H100).

A second implementation of the `vkrt_tpu` renderer beside the JAX package,
which stays the reference it is tested against. Module paths and function
names mirror `vkrt_tpu/` so each counterpart is easy to find:

  config            constants, RenderConfig, the five benchmark configs
  scene/            glTF loader, flatten, texture and material heaps, and
                    the seeded procedural scene (test and smoke scaffolding)
  accel/clusters    numpy host cluster build → torch ClusterTree
  accel/lbvh        LBVH build (the reference backend), Morton codes
  rt/dense          closest-hit trace with attributes (CUDA kernel A)
  rt/occl_multi     multi-light occlusion trace (CUDA kernel B)
  rt/traverse       LBVH traversal in plain PyTorch (reference backend)
  shade/            interpolation, normal mapping, material sampling
                    (bilinear, and trilinear at a per-ray mip level)
  wavefront/        trace → shade → shadow → reflection rounds, Renderer;
                    the depth>=1 shadow reorder (CUDA kernels C-F)
  raster/           raster renderer: setup stage, edge-function
                    rasterizer (CUDA kernel G), Rasterizer
  app/              CLI, camera, fly-through path, framebuffer, FPS
                    overlay, metrics, checkpoints
  parallel/         frames split over a device list (rays or raster pixel
                    blocks), scene replicated, one framebuffer gather;
                    the multi-device dry run
  golden/           oracles (brute-force and native ray tracer with its
                    stability mask, raster oracle) and the golden harness
  native/           the C++ oracle tracer (g++, ctypes)
  runtime           float32 policy, device report, kernel build,
                    FrameScheduler (frames in flight)
  graphs            frames captured as CUDA graphs and replayed (the
                    counterpart of jax.jit's cache), a replay's
                    launches read from torch.profiler
  kernels           nvcc build + ctypes binding of csrc/*.cu
  version           __version__

The numpy-only modules (config, scene, utils/mathutils and log, app,
golden, native) are the port's own copies of the JAX package's, kept at
the same paths. This package imports torch and numpy, never jax and
nothing of vkrt_tpu.
"""

from vkrt_tpu_torch.version import __version__

__all__ = ["__version__"]

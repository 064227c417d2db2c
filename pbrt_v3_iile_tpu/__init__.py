"""pbrt_v3_iile_tpu — a differentiable wavefront path tracer with neural
indirect lighting ("One Shot Radiance" / IILE), built from scratch in
JAX/XLA/Pallas.

Capability reference: giuliojiang/pbrt-v3-IILE (C++ pbrt-v3 fork + PyTorch
CNN sidecar).  This framework re-designs every layer as batched device
work for NVIDIA GPUs (and the CPU):

- wavefront path integration (SoA ray arrays, `lax.scan` over bounces)
  instead of recursive per-ray `Li` calls (ref: src/integrators/path.cpp),
- flat-array BVH traversal vectorized over ray wavefronts (ref:
  src/accelerators/bvh.cpp), with a Pallas cluster kernel for the hot loop
  on GPUs,
- the IISPT U-Net (ref: ml/iispt_net.py) as an in-graph lax module — the
  C++<->python stdio pipe protocol (ref: tools/childprocess.hpp) disappears,
- probe (hemispherical G-buffer) rendering batched `(P, 32, 32, 7)` (ref:
  src/integrators/iispt_d.cpp),
- multi-device scaling via `jax.sharding.Mesh` + shard_map with psum film
  reduction (replaces ParallelFor2D tiling, ref: src/core/parallel.cpp).
"""

__version__ = "0.1.0"

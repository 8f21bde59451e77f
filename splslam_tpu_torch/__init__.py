"""splslam_tpu_torch — the PyTorch/CUDA port of splslam_tpu.

The JAX package `splslam_tpu` is the reference; this package mirrors its
layout and module names so each module's counterpart is easy to find.
It imports `torch` and never `jax`. The only module it borrows from the
reference is the numpy-only `splslam_tpu.io.synthetic`, and only in
tests and `chip_smoke.py`.

Slices covered so far: stereo, points only (the reference's benchmark
path), with local mapping (cull, triangulate, fuse, local BA, keyframe
culling) on by default — `slam.system.System(settings, Sensor.STEREO,
device)`.
The ORB patch/descriptor stage runs as a hand-written CUDA kernel on a
GPU (`ops/orb_kernel.py`, `csrc/orb_describe.cu`) and as its plain
PyTorch version on the CPU.
"""

__version__ = "0.1.0"

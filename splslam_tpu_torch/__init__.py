"""splslam_tpu_torch — the PyTorch/CUDA port of splslam_tpu.

The JAX package `splslam_tpu` is the reference; this package mirrors its
layout and module names so each module's counterpart is easy to find.
It imports `torch` and never `jax`, and nothing of the JAX package: the
synthetic sequences it is driven with are its own copy,
`splslam_tpu_torch.io.synthetic`.

Covered: every sensor (`slam.system.System(settings, Sensor.STEREO |
RGBD | MONOCULAR, device)`), points and lines, one frame a call or in
batches (`track_*_batch`), with local mapping, BoW relocalization and
loop detection with Sim3 verification on by default, and loop
correction off as in the reference. The BoW vocabularies are the JAX
package's bundled `.npz` files, read by path as data.
The ORB orientation/descriptor stage (with the descriptor blur) runs as
a hand-written CUDA kernel on a GPU, one launch for both images of a
stereo frame (`ops/orb_kernel.py`, `csrc/orb_describe.cu`), and as its
plain PyTorch version on the CPU.
"""

__version__ = "0.1.0"

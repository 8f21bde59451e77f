"""Dataset and live drivers of the port (reference Examples/{Monocular,
Stereo,RGB-D}; port of splslam_tpu/examples/).

Each module runs as

    python -m splslam_tpu_torch.examples.rgbd_tum <settings.yaml> <sequence_dir> [out.txt] [--device cpu]

with the reference's YAMLs (the bundled ones are read by path from
`CONFIGS`, the JAX package's configs folder). The System runs on "cuda"
unless `--device` (or the `device` keyword of `main`) asks for another
device. The flow is the reference drivers': LoadImages -> System -> one
Track* per frame -> Shutdown -> SaveTrajectory, with the median and mean
track time, the stage timers and the solver-guard health printed.
"""

import os

CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "splslam_tpu", "examples", "configs",
)

"""Where the time of the ORB kernel goes, on one GPU.

    python3 scripts/orb_kernel_stages.py [NAME=SOURCE ...]

Times copies of `splslam_tpu_torch/csrc/orb_describe.cu` cut short after
each stage, and the whole kernel, on chip_smoke.py's phase-3 inputs (both
images of one 1241x376 stereo frame, 8 levels, 2 x 2000 slots). Each copy
keeps the work before its cut:
  stage0  the launch and the slots' patch corners;
  stage1  + the copies of the blur windows into shared memory;
  stage2  + the vertical pass;
  stage3  + the horizontal pass and the moments' per-thread sums;
  full    + the moment reduction, the angle and the 256 tests.
A cut copy ends by reading the shared buffers, so the compiler keeps the
work before the cut. Extra NAME=SOURCE pairs time other kernel sources
with the same C interface beside these. Device time per launch comes
from CUDA events around CUDA graphs of 20 launches (`chip_smoke.graph_ms`),
every variant in turns, twice. Prints ptxas's registers and shared memory,
resident blocks per SM, the full kernel's agreement with the plain
version, and one JSON line of times in ms. Copies are written under
build/kernels/stages/.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "splslam_tpu_torch" / "csrc" / "orb_describe.cu"
# (anchor in the source, text inserted after it, stages that take it)
CUTS = [
    ("  const int cx = min(max(xi - kCenter, 0), pyr.packed_cols - kPatch);\n",
     "  if (tid == 0) angle[blockIdx.x] = (float)(cy + cx);\n  return;\n", {0}),
    ("    cp_async_wait_all();\n    __syncthreads();\n",
     "    i += rows;\n    __syncthreads();\n    continue;\n", {1}),
    ("        if (r0 + u < rows) vert[(r0 + u) * kStride + c] = s;\n"
     "      }\n    }\n    __syncthreads();\n",
     "    i += rows;\n    __syncthreads();\n    continue;\n", {2}),
    ("    i += rows;\n    __syncthreads();  // win and vert are refilled by the next segment\n  }\n  __syncthreads();\n",
     "  if (tid < kThreads) angle[blockIdx.x] = m10 + m01 + win[tid] + vert[tid]"
     " + __bfloat162float(patch[tid]);\n  return;\n", {1, 2, 3}),
]


def cut_source(stage: int) -> str:
    s = SOURCE.read_text()
    for anchor, insert, stages in CUTS:
        if s.count(anchor) != 1:
            raise SystemExit(f"orb_kernel_stages: anchor not found once: {anchor!r}")
        if stage in stages:
            s = s.replace(anchor, anchor + insert)
    return s


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        raise SystemExit("orb_kernel_stages: no CUDA device")
    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.ops.orb import detect
    from splslam_tpu_torch.ops.pyramid import PyramidSpec

    out_dir = ROOT / "build" / "kernels" / "stages"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for st in range(4):
        p = out_dir / f"orb_describe_stage{st}.cu"
        p.write_text(cut_source(st))
        sources[f"stage{st}"] = p
    sources["full"] = SOURCE
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        sources[name] = Path(path).resolve()

    _, _, frames, _ = make_stereo_sequence(
        n_frames=1, width=CS.KITTI_W, height=CS.KITTI_H, fx=718.0,
        baseline=0.54, motion="forward", seed=3)
    spec = PyramidSpec.create(CS.KITTI_H, CS.KITTI_W, 8, 1.2, 2000)
    found = [detect(torch.from_numpy(f.astype(np.uint8)).cuda().float(), spec)
             for f in frames[0]]
    levels = [lv for lv, _ in found]
    xy = torch.stack([torch.cat([d[1] for d in det]) for _, det in found])
    a_p, d_p = OK.orb_describe_reference(levels, xy, spec)

    libs = {}
    for name, src in sources.items():
        OK._SOURCE, OK._LIB = src, None
        lib = libs[name] = OK.build()
        info = [ln.split("info    :")[-1].strip() for ln in lib.log.splitlines()
                if "registers" in ln or "stack frame" in ln]
        print(f"{name}: {info}, {lib.lib.orb_describe_occupancy()} blocks/SM")
        if name not in [f"stage{st}" for st in range(4)]:
            a, d = OK.orb_describe(levels, xy, spec)
            torch.cuda.synchronize()
            print(f"{name}: angle max abs err {float((a - a_p).abs().max()):.3e}, "
                  f"words equal {float((d == d_p).float().mean()):.6f}")
    times = {name: [] for name in sources}
    order = list(sources) + list(sources)[::-1]
    for _ in range(2):
        for name in order:
            OK._LIB = libs[name]
            times[name].append(CS.graph_ms(lambda: OK.orb_describe(levels, xy, spec)))
    print(CS.card_line())
    print(json.dumps({name: {"median_ms": float(np.median(t)), "ms": t}
                      for name, t in times.items()}))


if __name__ == "__main__":
    main()

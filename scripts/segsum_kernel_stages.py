"""Where the time of the segment-sum kernel goes, on one GPU.

    python3 scripts/segsum_kernel_stages.py

Times copies of `splslam_tpu_torch/csrc/segment_sum.cu` cut short after
each stage, and the whole kernel, at the `tests/test_torch_gpu.py::
SEGSUM_SHAPES` shapes (made from their seeds). Each copy keeps the work
before its cut, and the empty cells' zeros:
  stage0  the launch, each warp's row records and order window;
  stage1  + the staging of the chunks' rows in shared memory;
  stage2  + each chunk's sum, a column a lane, written (no long cell's
          groups added);
  stage3  + each long cell's chunks' release and ticket (no group added;
          its tickets are never reset, so after its first launch no
          warp draws a last ticket);
  full    + the groups of the long cells, up the tree.
A cut copy writes something of what it read, so the compiler keeps the
work before the cut; its sums are wrong. Whole-kernel variants beside
them: `staging_ldg` stages the rows through registers (`__ldg`) instead
of cp.async; `six_blocks_an_sm` asks the compiler for 6 resident blocks
an SM (80 registers a thread) instead of 4 (95); `release_then_acquire`
takes a ticket with a release atomic and fences only the last arrival;
`fences_around_relaxed` fences before a relaxed atomic, and the last
arrival after it. Device time a launch comes from
CUDA events around CUDA graphs of 20 launches (`chip_smoke.graph_ms`),
the variants in turns, twice. Prints ptxas's registers and shared memory
of each copy, the full kernel's and the variants' agreement with the
plain version, and one
JSON line of times in ms with the card's name and power limit. Copies are
written under build/kernels/stages/.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "splslam_tpu_torch" / "csrc" / "segment_sum.cu"
# (anchor in the source, text inserted after it, stages that take it)
CUTS = [
    ("  const unsigned multi = __ballot_sync(kFull, count > 1);\n  __syncwarp();\n",
     "  if (lane == 0) out[(size_t)(task % n_cells) * width] = "
     "(float)(cs[nch] + o0 + o1 + (int)multi);\n  return;\n", {0}),
    ("      copy_wait();\n      __syncwarp();\n",
     "      if (lane == 0) out[(size_t)cr[ja].x * width] = buf[lane];\n      continue;\n",
     {1}),
    ("    ja = jb;\n  }\n",
     "  return;\n", {1, 2}),
    ("      if (lane == 0) last = ticket_last(tickets + slot + level, m);\n",
     "      return;\n", {3}),
]
STAGES = {"stage0": 0, "stage1": 1, "stage2": 2, "stage3": 3, "full": 4}
# whole-kernel variants: (anchor, replacement) pairs on the full source
VARIANTS = {
    "staging_ldg": [(
        "  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);\n  if (vec == 4)",
        "  if (vec == 4) { *(float4*)dst = __ldg((const float4*)src); return; }\n"
        "  if (vec == 2) { *(float2*)dst = __ldg((const float2*)src); return; }\n"
        "  *dst = __ldg(src); return;\n"
        "  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);\n  if (vec == 4)")],
    "six_blocks_an_sm": [("__launch_bounds__(kWarps * 32, 4)",
                          "__launch_bounds__(kWarps * 32, 6)")],
    "release_then_acquire": [(
        "  asm volatile(\"atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\\n\"\n"
        "               : \"=r\"(old) : \"l\"(p) : \"memory\");\n"
        "  return old == arrivals - 1;\n",
        "  asm volatile(\"atom.release.gpu.global.add.u32 %0, [%1], 1;\\n\"\n"
        "               : \"=r\"(old) : \"l\"(p) : \"memory\");\n"
        "  if (old != arrivals - 1) return false;\n"
        "  asm volatile(\"fence.acq_rel.gpu;\\n\" ::: \"memory\");\n"
        "  return true;\n")],
    "fences_around_relaxed": [(
        "  asm volatile(\"atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\\n\"\n"
        "               : \"=r\"(old) : \"l\"(p) : \"memory\");\n"
        "  return old == arrivals - 1;\n",
        "  asm volatile(\"fence.acq_rel.gpu;\\n\" ::: \"memory\");\n"
        "  asm volatile(\"atom.relaxed.gpu.global.add.u32 %0, [%1], 1;\\n\"\n"
        "               : \"=r\"(old) : \"l\"(p) : \"memory\");\n"
        "  if (old != arrivals - 1) return false;\n"
        "  asm volatile(\"fence.acq_rel.gpu;\\n\" ::: \"memory\");\n"
        "  return true;\n")],
}


def cut_source(stage: int) -> str:
    s = SOURCE.read_text()
    for anchor, insert, stages in CUTS:
        if s.count(anchor) != 1:
            raise SystemExit(f"segsum_kernel_stages: anchor not found once: {anchor!r}")
        if stage in stages:
            s = s.replace(anchor, anchor + insert)
    return s


def variant_source(name: str) -> str:
    s = SOURCE.read_text()
    for anchor, text in VARIANTS[name]:
        if s.count(anchor) != 1:
            raise SystemExit(f"segsum_kernel_stages: anchor not found once: {anchor!r}")
        s = s.replace(anchor, text)
    return s


def launch(lib, seg, rows, tickets):
    """One launch of a build of the source on `seg`'s tables (the wrapper's
    call, `ops/segsum.py::_launch`, with another library and its own
    tickets: a cut copy leaves its tickets unreset)."""
    import torch

    out = torch.empty((seg.n_cells, rows.shape[1]), device=rows.device)
    code = lib.segment_sum_launch(
        rows.data_ptr(), rows.shape[1], seg.rows, seg.order32.data_ptr(),
        seg.records.data_ptr(), seg.start.data_ptr(), seg.n_tasks, seg.n_cells,
        seg.partials.data_ptr(), tickets.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {code}")
    return out


def main() -> None:
    import torch

    from splslam_tpu_torch.ops import segsum as SS
    from splslam_tpu_torch.ops.nvcc import NVCC_FLAGS, build_library

    if not torch.cuda.is_available():
        raise SystemExit("segsum_kernel_stages: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    spec = importlib.util.spec_from_file_location(
        "test_torch_gpu", ROOT / "tests" / "test_torch_gpu.py")
    gpu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gpu)
    card = CS.card_line()
    stage_dir = ROOT / "build" / "kernels" / "stages"
    stage_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    sources = {name: cut_source(stage) for name, stage in STAGES.items()}
    sources.update({name: variant_source(name) for name in VARIANTS})
    for name, text in sources.items():
        path = stage_dir / f"segment_sum_{name}.cu"
        path.write_text(text)
        lib, _, log = build_library(path, NVCC_FLAGS)
        ptr, n = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum_launch.argtypes = [ptr, n, n, ptr, ptr, ptr, n, n,
                                           ptr, ptr, ptr, ptr]
        lib.segment_sum_launch.restype = ctypes.c_int
        libs[name] = lib
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: {regs}", flush=True)
    dev = torch.device("cuda")
    times = {}
    for shape in gpu.SEGSUM_SHAPES:
        cell, rows = gpu.segsum_table(shape, dev)
        seg = SS.Segments(cell, gpu.SEGSUM_SHAPES[shape][1])
        tickets = {name: torch.zeros_like(seg.tickets) for name in libs}
        ref = SS.segment_sum_reference(seg, rows)
        equal = {name: torch.equal(launch(libs[name], seg, rows, tickets[name]), ref)
                 for name in ("full", *VARIANTS)}
        runs = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                runs[name].append(CS.graph_ms(
                    lambda: launch(lib, seg, rows, tickets[name])))
        times[shape] = {name: min(t) for name, t in runs.items()}
        print(f"{shape}: equal to plain {equal}; " + ", ".join(
            f"{name} {t * 1e3:.2f} us" for name, t in times[shape].items()), flush=True)
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()

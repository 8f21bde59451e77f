"""Multi-device scaling over `torch.distributed` (port of
splslam_tpu/parallel/mesh.py).

The reference is a single-process CPU system (SURVEY §2.4: no distributed
anything); its scaling axes here are:

- **data parallel over sequences**: B independent SLAM instances, each
  rank tracking its contiguous rows of the batch (`shard_batch`,
  `batched_track_step`);
- **sharded bundle adjustment**: the edge table sharded over ranks, the
  per-shard Hessian contributions summed by `all_reduce`
  (`parallel/gba_sharded.py`).

A `Mesh` is one rank's view of a process group: its rank, the world size
and its device. `launch` starts n local ranks (the counterpart of the
JAX package's virtual host devices): NCCL on cards, one card a rank;
gloo on the CPU, or on cards that ranks share.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D device mesh: `group` (None: the default group),
    this rank, the number of ranks and this rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "data"

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the mesh in place and return it."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None) -> Mesh:
    """This rank's mesh over the first `n_devices` ranks (default: all)
    of the initialized default process group. `device` defaults to the
    current card under NCCL and the CPU otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or launch)")
    world = dist.get_world_size()
    n = n_devices or world
    if world < n:
        raise RuntimeError(f"make_mesh: {n} devices asked for, the process "
                           f"group has {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(group, dist.get_rank(group), n, torch.device(device), axis)


def _tree_map(f, *trees):
    """f over the leaves of equal-structured trees of (named) tuples,
    lists and dicts; None stays None."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(f, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(f, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _tree_map(f, *(x[k] for x in trees)) for k in t}
    return f(*trees)


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous rows of every [B, ...] leaf (tensors or
    arrays), on the mesh's device. B must divide by the mesh size."""

    def take(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"shard_batch: a batch of {x.shape[0]} does not "
                             f"divide over {mesh.size} ranks")
        s = x.shape[0] // mesh.size
        return x[mesh.rank * s:(mesh.rank + 1) * s].to(mesh.device)

    return _tree_map(take, tree)


def batched_track_step(cam, scales, scale_factor: float, n_levels: int):
    """Returns a function tracking B frames (one per sequence) at once:
    `slam.tracking.track_step` once per row of the leading batch axis of
    every argument, with no line inputs, the outputs stacked. (The port's
    scatters and data-dependent indexing do not go through
    `torch.func.vmap`: the loop is the counterpart of the reference's
    vmap.) Arguments: (cur FrameData, last_octave, last_angle, last_desc
    (packed [N,8] int32), lm_xyz, lm_gid, T_pred, win LocalWindow), each
    with a leading B."""
    from splslam_tpu_torch.slam.tracking import LineWindow, track_step

    def one(cur, last_oct, last_ang, last_desc, lm_xyz, lm_gid, T_pred, win):
        lcap = cur.lines.capacity
        dev = T_pred.device
        return track_step(
            cam, scales, cur, last_oct, last_ang, last_desc, lm_xyz, lm_gid,
            T_pred, win,
            cur.lines, torch.full((lcap,), -1, dtype=torch.int32, device=dev),
            torch.zeros((lcap, 3, 3), device=dev),
            torch.zeros((lcap,), device=dev), LineWindow.empty(1, dev),
            scale_factor=scale_factor, n_levels=n_levels,
        )

    def step(*batched):
        B = batched[6].shape[0]          # T_pred [B,4,4]
        outs = [one(*_tree_map(lambda x, b=b: x[b], batched)) for b in range(B)]
        return _tree_map(lambda *xs: torch.stack(xs), *outs)

    return step


def check_group(mesh: Mesh, fail_rank: int = -1) -> int:
    """A rank function for `launch` that checks a launched group: every
    rank adds one in an all-reduce on its device and gets the group's
    size back. Rank `fail_rank` raises before the collective instead,
    leaving the others waiting in it (the launcher's failure path)."""
    if mesh.rank == fail_rank:
        raise RuntimeError(f"rank {fail_rank} failed on request")
    return int(mesh.allsum(torch.ones((), device=mesh.device)).item())


def _rank_main(fn, rank, n, store, dev_type, backend, args, results):
    """One spawned rank: join the group, run fn(mesh, *args), report."""
    try:
        if dev_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)   # the ranks share the host's cores
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=n)
        out = fn(make_mesh(n, device=device), *args)
        dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except Exception:   # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn, n: int, device="cuda", backend: str | None = None,
           timeout_s: float = 600.0, args: tuple = (),
           share_cards: bool = False) -> list:
    """Run `fn(mesh, *args)` on `n` spawned local ranks and return their
    results in rank order. `fn` must be a module-level function and its
    arguments and result picklable (return host data, not card tensors).

    On "cuda" each rank takes card `rank`, NCCL by default; asking for
    more ranks than cards raises unless `share_cards` (rank r on card
    r % count, for gloo, which copies card tensors through the host; NCCL
    refuses two ranks on one card). On "cpu" the ranks use gloo with one
    torch thread each. The group meets in a `file://` store in a fresh
    temporary directory (no port). A rank that raises, dies or outlives
    `timeout_s` fails the call: every rank still running is killed and
    the error names each rank's failure."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("launch: no CUDA device")
        if n > count and not share_cards:
            raise RuntimeError(f"launch: {n} ranks asked for on {count} "
                               "card(s)")
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    done: dict[int, bytes] = {}
    errors: dict[int, str] = {}

    def take(item):
        rank, ok, payload = item
        (done if ok else errors)[rank] = payload

    with tempfile.TemporaryDirectory(prefix="splslam-launch-") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, os.path.join(tmp, "store"),
                                   dev_type, backend, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        late = f"no result within {timeout_s:.0f} s"
        try:
            while len(done) + len(errors) < n and time.monotonic() < deadline:
                try:
                    take(results.get(timeout=1.0))
                except queue.Empty:
                    if all(p.exitcode is not None for p in procs):
                        break
                    if not any(p.exitcode not in (None, 0) for p in procs):
                        continue
                if errors or any(p.exitcode not in (None, 0) for p in procs):
                    # the others may wait on a failed rank in a collective
                    deadline = min(deadline, time.monotonic() + 10.0)
                    late = "still running 10 s after another rank failed"
            while len(done) + len(errors) < n:
                try:
                    take(results.get(timeout=0.5))
                except queue.Empty:
                    break
            exits = [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    for r in range(n):
        if r not in done and r not in errors:
            errors[r] = (f"{late} (killed)" if exits[r] is None else
                         f"exited with code {exits[r]} without a result")
    if errors:
        raise RuntimeError("launch: " + "; ".join(
            f"rank {r}: {errors[r]}" for r in sorted(errors)))
    return [pickle.loads(done[r]) for r in range(n)]

"""CUDA activities (kernels, copies, memsets) in the traced window over the
frames its calls tracked: what the host enqueues a frame."""

LAYER = "host control"
UNIT = "ops/frame"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    t = ctx.window.trace
    frames = sum(c.n_frames for c in ctx.window.calls if c.traced)
    if t is None or not t.device or not frames:
        return None
    return len(t.device) / frames

"""The device's idle share of the traced window: 1 - the union of its CUDA
activities (kernels, copies, memsets) over the window's wall."""

LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    t = ctx.window.trace
    if t is None or not t.device:
        return None
    return 1.0 - t.busy_s() / t.window_s

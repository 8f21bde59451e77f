"""The ORB description kernel's share of its roofline: the least time the
H100 could take for the work its calls need (`harness/orb_work.py`) over
the device time of its launches in the traced window, by kernel name."""

from harness import orb_work

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNEL = "orb_describe"


def read(ctx):
    t = ctx.window.trace
    if t is None:
        return None
    runs = [(s, e) for name, s, e in t.device if KERNEL in name]
    if not runs or not ctx.keypoints_per_image:
        return None
    y = ctx.cell.yaml
    pixels = orb_work.pyramid_pixels(int(y["Camera.height"]), int(y["Camera.width"]),
                                     int(y["ORBextractor.nLevels"]),
                                     float(y["ORBextractor.scaleFactor"]))
    images = 2 if ctx.cell.sensor == "stereo" else 1
    nbytes, flops = orb_work.work(images, images * ctx.keypoints_per_image, pixels)
    least = orb_work.least_seconds(nbytes, flops) * len(runs)
    measured = sum(e - s for s, e in runs) / 1e6
    return 100.0 * least / measured

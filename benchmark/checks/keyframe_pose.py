"""`kf_pose_err_m`: the largest distance between the camera position of a
keyframe made in the window, as local BA left it, and the one the scene
was rendered from; infinite where the window made no keyframe. Control:
one frame late (`compare.late`).
"""

from harness import compare


def read(cell, scene, out, control: bool) -> dict:
    kfs = dict(out.keyframes)
    kfs = compare.late(scene, kfs) if control else kfs
    return {"kf_pose_err_m": compare.pose_err(kfs, scene.gt) if kfs else float("inf")}

"""`pose_err_m`: the largest distance between the camera position a
tracking call answered and the one the scene was rendered from, over
every frame of the window (stereo and RGB-D poses are metric, in the
first camera's frame). Control: one frame late (`compare.late`).
"""

from harness import compare


def read(cell, scene, out, control: bool) -> dict:
    answers = compare.late(scene, out.answers) if control else out.answers
    return {"pose_err_m": compare.pose_err(answers, scene.gt)}

"""`pose_rmse_m`: the root mean square over every frame of the window of
the distance between the camera position a tracking call answered and
the one the scene was rendered from (the absolute trajectory error).
Control: one frame late (`compare.late`).
"""

from harness import compare


def read(cell, scene, out, control: bool) -> dict:
    answers = compare.late(scene, out.answers) if control else out.answers
    return {"pose_rmse_m": compare.pose_rmse(answers, scene.gt)}

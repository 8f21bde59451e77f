"""`orb_keypoints_off`: over the window's frames that the comparison
sampled (drawn from the seed), the keypoints (level, x, y) of the first
view that the program and the plain ORB of `reference/orb.py` do not
share, over all they find; `orb_bits_off`: the descriptor bits that differ
on the keypoints both find, over all their bits. Control: the plain ORB
computed in bfloat16, the precision below the configuration's float32.
"""

import numpy as np
import torch

from reference import orb as RO


def program_keypoints(feat, scale: float) -> RO.Keypoints:
    """The program's valid keypoints at their pyramid level's pixel."""
    valid = feat.valid.cpu().numpy()
    lv = feat.octave.cpu().numpy()[valid].astype(np.int64)
    xy = feat.xy.cpu().numpy()[valid].astype(np.float64) / scale ** lv[:, None]
    return RO.Keypoints(lv, np.rint(xy[:, 0]).astype(np.int64), np.rint(xy[:, 1]).astype(np.int64),
                        feat.desc.cpu().numpy()[valid].view(np.uint32))


def _keyset(kp: RO.Keypoints) -> dict:
    return {(int(l), int(x), int(y)): i for i, (l, x, y) in enumerate(zip(kp.level, kp.x, kp.y))}


def orb_gaps(pairs: list) -> tuple[float, float]:
    """(keypoints off, descriptor bits off) of (candidate, reference)
    keypoint tables, pooled over frames."""
    diff = union = bits = compared = 0
    for cand, ref in pairs:
        a, b = _keyset(cand), _keyset(ref)
        both = a.keys() & b.keys()
        diff += len(a.keys() ^ b.keys())
        union += len(a.keys() | b.keys())
        if both:
            ia = np.array([a[k] for k in both])
            ib = np.array([b[k] for k in both])
            x = np.bitwise_xor(cand.desc[ia], ref.desc[ib])
            bits += int(np.unpackbits(x.view(np.uint8)).sum())
            compared += 256 * len(both)
    return diff / max(union, 1), (bits / compared if compared else 1.0)


def read(cell, scene, out, control: bool) -> dict:
    y = cell.yaml
    scale = float(y["ORBextractor.scaleFactor"])
    args = (int(y["ORBextractor.nFeatures"]), int(y["ORBextractor.nLevels"]), scale)
    pairs = []
    for f, frame in out.sample:
        image = scene.views(f)[0]
        ref = RO.extract(image, *args)
        cand = (RO.extract(image, *args, dtype=torch.bfloat16) if control
                else program_keypoints(frame.feat, scale))
        pairs.append((cand, ref))
    keypoints_off, bits_off = orb_gaps(pairs)
    return {"orb_keypoints_off": keypoints_off, "orb_bits_off": bits_off}

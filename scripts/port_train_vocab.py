"""Train a BoW vocabulary with the PyTorch port from ORB descriptors of a
diverse synthetic image set, with true per-image idf weights (DBoW2
setNodeWeights semantics), and write it with `bow.vocabulary.save`.

    python3 scripts/port_train_vocab.py [--small] [--out PATH] [--device cpu]

The image set, the descriptors' budget and the tree are those of the JAX
package's scripts/train_vocab.py: 10^5 words (k=10, depth=5) from ~480
images of 24 scene seeds at 512x384 and 1400 features, or with `--small`
10^4 words (k=10, depth=4) from 12 seeds at 320x240 and 800 features.
ORB runs on `--device` (the card by default); the k-medians training is
host numpy, as the reference's. The output goes to PATH (default
build/vocab/vocab_100k.npz or vocab_10k.npz, outside both packages),
and loads with `splslam_tpu_torch.bow.vocabulary.load` or the JAX
package's `load`. The reference's ~10^6-word ORBvoc is trained on real
images that are not in this repository.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def collect(n_seeds: int, frames_per_seq: int, W: int, H: int,
            n_features: int, device):
    """Descriptors ([N,8] uint32) and image ids from varied textures,
    motions and scenes, as scripts/train_vocab.py draws them."""
    import torch

    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.ops.orb import extract_orb
    from splslam_tpu_torch.ops.pyramid import PyramidSpec

    spec = PyramidSpec.create(H, W, n_features=n_features, n_levels=4,
                              scale_factor=1.2)
    descs, img_ids = [], []
    img_id = 0
    for seed in range(n_seeds):
        _, _, frames, _ = make_stereo_sequence(
            n_frames=frames_per_seq, width=W, height=H,
            motion=("forward", "lateral", "arc")[seed % 3], seed=seed,
            texture="grid" if seed % 4 == 3 else "blobs",
            scene="corridor" if seed % 5 == 4 else "planes",
        )
        for l, r in frames:
            for img in (l, r) if seed % 2 == 0 else (l,):
                f = extract_orb(torch.from_numpy(np.asarray(img, np.float32))
                                .to(device), spec)
                v = f.valid.cpu().numpy()
                d = f.desc.cpu().numpy().view(np.uint32)[v]
                descs.append(d)
                img_ids.append(np.full(len(d), img_id))
                img_id += 1
        print(f"seed {seed}: {img_id} images, "
              f"{sum(len(d) for d in descs)} descriptors", flush=True)
    return np.concatenate(descs), np.concatenate(img_ids), img_id


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="10^4 words from the smaller image set")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from splslam_tpu_torch.bow import vocabulary as V

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("port_train_vocab: no CUDA device (pass --device cpu)")
    if args.small:
        D, I, n_img = collect(12, 10, 320, 240, 800, args.device)
        depth, name = 4, "vocab_10k.npz"
    else:
        D, I, n_img = collect(24, 12, 512, 384, 1400, args.device)
        depth, name = 5, "vocab_100k.npz"
    out = args.out or str(ROOT / "build" / "vocab" / name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    print(f"training k=10 depth={depth} on {len(D)} descriptors from "
          f"{n_img} images", flush=True)
    voc = V.train(D, k=10, depth=depth, seed=0, image_ids=I, verbose=True,
                  device=args.device)
    V.save(voc, out)
    nz = int((voc.weights > 0).sum())
    print(f"saved {out}: {voc.n_words} words, {nz} with nonzero idf", flush=True)


if __name__ == "__main__":
    main()

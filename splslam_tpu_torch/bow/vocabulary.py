"""Hierarchical binary bag-of-words vocabulary and the keyframe database
(port of splslam_tpu/bow/vocabulary.py, query side).

The k-ary tree of depth L is stored as per-level descriptor tables in
the complete-tree layout (children of node (l, i) are (l+1, i*k ...
i*k+k-1)); a descriptor's word is found by L rounds of gather-children +
Hamming argmin (DBoW2 TemplatedVocabulary::transform), batched over all
features of a frame. Hamming distances are exact integer popcounts of
the int32 descriptor words; ties go to the first child, as the
reference's argmin. Scores are DBoW2's L1 score of L1-normalized tf-idf
vectors, sum of minima.

Vocabularies are `.npz` files in the reference's format (`level{i}`
uint32 tables, `weights`, `k`, `depth`). The bundled ones live in the
JAX package's `assets/` folder; `default_vocab_path` finds them by file
path and they are read as data, never imported, so the 3.7 MB of
vocabularies are not duplicated. `load_orbslam_txt` reads the reference's
ORBvoc.txt into the same layout. `train` builds a vocabulary offline by
hierarchical binary k-medians on host numpy, as the reference's does.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from splslam_tpu_torch.ops.match import popcount32

# Largest bundled true-idf vocabulary first (10^5 words, k=10, L=5); the
# smaller ones are fallbacks for trimmed checkouts, as in the reference.
BUNDLED = ("vocab_100k.npz", "vocab_10k.npz", "vocab_small.npz")
ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "splslam_tpu", "assets",
)


class Vocab(NamedTuple):
    """Device-side vocabulary. level_desc[l]: [k^(l+1), 8] int32 (the
    bits of the reference's uint32 words)."""

    level_desc: tuple          # of [k^(l+1), 8] int32 tensors, l = 0..L-1
    weights: torch.Tensor      # [W] f32 idf word weights
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return int(self.k ** self.depth)


# ----------------------------------------------------------------------
# host-side training
# ----------------------------------------------------------------------
def _unpack_np(desc: np.ndarray) -> np.ndarray:
    """[N,8] u32 -> [N,256] u8 bits."""
    bits = (desc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(desc.shape[0], -1).astype(np.uint8)


def _pack_np(bits: np.ndarray) -> np.ndarray:
    words = bits.reshape(-1, 8, 32).astype(np.uint32)
    return (words << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)


def train(descriptors: np.ndarray, k: int = 10, depth: int = 3,
          seed: int = 0, image_ids: np.ndarray | None = None,
          iters: int = 8, verbose: bool = False, device="cpu") -> Vocab:
    """Train a k^depth-word vocabulary from [N,8] u32 descriptors by
    hierarchical binary k-medians (majority-vote medoids — the analog of
    DBoW2's offline k-means++ on the FORB mean/distance).

    Fully vectorized: distances are packed-uint64 XOR + popcount
    (np.bitwise_count) over all N descriptors at once per Lloyd
    iteration, and medoid votes are 256 weighted bincounts — a 10^5-word
    (k=10, depth=5) vocabulary trains from ~500k descriptors in a few
    minutes on host numpy, vs hours for a per-parent Python loop.

    `image_ids` ([N] int, which image each descriptor came from) enables
    the TRUE DBoW2 idf weight idf(w) = log(N_images / N_images(w))
    (TemplatedVocabulary::setNodeWeights); without it a features-per-
    image proxy stands in (fine for the bundled toy vocabulary, wrong
    for serious retrieval — pass image_ids when training at scale)."""
    rng = np.random.default_rng(seed)
    desc_u32 = np.ascontiguousarray(np.asarray(descriptors, np.uint32))
    N = desc_u32.shape[0]
    u64 = desc_u32.view(np.uint64)              # [N,4]
    bits = _unpack_np(desc_u32)                 # [N,256] u8 (medoid votes)
    level_desc = []
    assign = np.zeros(N, np.int64)              # parent node per sample
    CHUNK = 1 << 17
    for l in range(depth):
        n_par = k ** l
        n_nodes = k ** (l + 1)
        # --- init: k random members per parent (k-medians seeding) ---
        centers_bits = rng.integers(0, 2, (n_nodes, 256)).astype(np.uint8)
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        starts = np.searchsorted(sa, np.arange(n_par))
        ends = np.searchsorted(sa, np.arange(n_par) + 1)
        for p in range(n_par):
            s, e = int(starts[p]), int(ends[p])
            if e > s:
                pick = order[s + rng.choice(e - s, size=min(k, e - s),
                                            replace=False)]
                centers_bits[p * k:p * k + len(pick)] = bits[pick]
        # --- Lloyd iterations (assignment restricted to the k children
        # of each sample's parent; fully vectorized across parents) ---
        child = np.zeros(N, np.int64)
        cand_base = (assign * k).astype(np.int64)

        def assign_pass() -> None:
            centers_u64 = np.ascontiguousarray(
                _pack_np(centers_bits)).view(np.uint64)  # [n_nodes,4]
            for c0 in range(0, N, CHUNK):
                c1 = min(c0 + CHUNK, N)
                cand = cand_base[c0:c1, None] + np.arange(k)[None, :]
                d = np.bitwise_count(
                    u64[c0:c1, None, :] ^ centers_u64[cand]
                ).sum(-1)                                # [n,k]
                child[c0:c1] = cand[np.arange(c1 - c0), d.argmin(1)]

        for _ in range(iters):
            assign_pass()
            # recenter: majority bit per cluster
            cnt = np.bincount(child, minlength=n_nodes)
            sums = np.empty((n_nodes, 256), np.int64)
            for b in range(256):
                sums[:, b] = np.bincount(
                    child, weights=bits[:, b], minlength=n_nodes
                )
            live = cnt > 0
            centers_bits[live] = (
                sums[live] * 2 >= cnt[live, None]
            ).astype(np.uint8)
        # One closing assignment against the FINAL recentred centers so the
        # stored tree, the next level's parent partition, and the idf
        # occupancy below all agree with what query-time transform will
        # compute (otherwise they lag the last recenter by a half Lloyd
        # step: words that gained/lost members in the final recenter would
        # get idf for the wrong occupancy).
        assign_pass()
        assign = child
        if verbose:
            occ = int((np.bincount(assign, minlength=n_nodes) > 0).sum())
            print(f"  level {l + 1}/{depth}: {occ}/{n_nodes} nodes "
                  f"occupied", flush=True)
        level_desc.append(_pack_np(centers_bits))
    W = k ** depth
    if image_ids is not None:
        img = np.asarray(image_ids, np.int64)
        n_images = int(img.max()) + 1
        # number of distinct images containing each word
        pairs = np.unique(np.stack([assign, img], 1), axis=0)
        n_i = np.bincount(pairs[:, 0], minlength=W).astype(np.float64)
        # unseen words get weight 0 (DBoW2 convention), not the max idf
        idf = np.where(
            n_i > 0, np.log(n_images / np.maximum(n_i, 1.0)), 0.0
        )
    else:
        counts = np.bincount(assign, minlength=W).astype(np.float64)
        n_img_proxy = max(bits.shape[0] / 500.0, 1.0)  # ~features per image
        idf = np.log(n_img_proxy * 500.0 / np.maximum(counts, 1.0))
    weights = np.maximum(idf, 0.0).astype(np.float32)
    return Vocab(tuple(torch.from_numpy(d.view(np.int32)).to(device) for d in level_desc),
                 torch.from_numpy(weights).to(device), k, depth)


def default_vocab_path() -> str:
    """The largest bundled vocabulary that exists on disk."""
    for name in BUNDLED:
        path = os.path.join(ASSETS, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no bundled vocabulary under {ASSETS}")


def load(path: str, device) -> Vocab:
    """Read a vocabulary `.npz` onto `device`."""
    z = np.load(path)
    depth = int(z["depth"])
    return Vocab(
        tuple(torch.from_numpy(np.ascontiguousarray(z[f"level{i}"], np.uint32)
                               .view(np.int32)).to(device)
              for i in range(depth)),
        torch.from_numpy(np.asarray(z["weights"], np.float32)).to(device),
        int(z["k"]),
        depth,
    )


def load_orbslam_txt(path: str, device) -> Vocab:
    """Read the ORB-SLAM2 text vocabulary (ORBvoc.txt: header `k L s1 s2`,
    then one node per line: `parent is_leaf d0..d31 weight`, node id = line
    index + 1, the root is node 0; DBoW2 TemplatedVocabulary::
    loadFromTextFile) into the complete-tree layout on `device`. Missing
    branches get the all-ones sentinel descriptor; the leaves' weights
    become the word weights."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        nodes = []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            nodes.append((int(parts[0]),
                          np.array([int(x) for x in parts[2:34]], np.uint8),
                          float(parts[34])))
    by_parent: dict[int, list[int]] = {}
    for i, (p, _, _) in enumerate(nodes):
        by_parent.setdefault(p, []).append(i)

    level_desc = []
    weights = np.zeros(k ** depth, np.float32)
    frontier = [(0, 0)]  # (DBoW2 node id, complete-tree slot)
    for l in range(depth):
        table = np.full((k ** (l + 1), 32), 255, np.uint8)
        next_frontier = []
        for node_id, slot in frontier:
            for j, kid in enumerate(by_parent.get(node_id, [])[:k]):
                _, d, w = nodes[kid]
                table[slot * k + j] = d
                if l == depth - 1:
                    weights[slot * k + j] = w
                next_frontier.append((kid + 1, slot * k + j))
        # 32 bytes -> 8 little-endian words: bit i of word j is bit i % 8
        # of byte 4j + i // 8, the reference's packing
        level_desc.append(torch.from_numpy(table.view("<u4").view(np.int32)).to(device))
        frontier = next_frontier
    return Vocab(tuple(level_desc), torch.from_numpy(weights).to(device), k, depth)


def _popcount_dist(desc: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """[N,8] vs [N,C,8] -> [N,C] Hamming."""
    return torch.sum(popcount32(desc[:, None, :] ^ cands), dim=-1,
                     dtype=torch.int32)


def _descend(level_desc: tuple, k: int, depth: int, desc: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    node = torch.zeros(desc.shape[0], dtype=torch.long, device=desc.device)
    children = torch.arange(k, device=desc.device)
    for l in range(depth):
        cand_idx = node[:, None] * k + children[None, :]        # [N,k]
        d = _popcount_dist(desc, level_desc[l][cand_idx])
        node = cand_idx.gather(1, torch.argmin(d, dim=1)[:, None])[:, 0]
    return torch.where(valid, node.to(torch.int32), -1)


def transform_words(vocab: Vocab, desc: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """[N,8] int32 descriptors -> [N] int32 word ids (-1 for invalid rows)."""
    return _descend(vocab.level_desc, vocab.k, vocab.depth, desc, valid)


def _tfidf(words: torch.Tensor, weights: torch.Tensor, size: int,
           slot: torch.Tensor) -> torch.Tensor:
    """Sum of the idf weights of valid words, scattered at `slot`, [size]."""
    ok = words >= 0
    w = torch.where(ok, weights[words.clamp(min=0).long()], 0.0)
    return torch.zeros((size,), device=words.device).index_add_(0, slot.long(), w)


class BowTable(NamedTuple):
    """The KeyFrameDatabase's inverted file as a sparse per-keyframe word
    list (reference include/KeyFrameDatabase.h:66 keeps word -> list of
    keyframes; this is the transpose, keyframe -> words).

    ids:  [K, S] int32 word ids, ascending per row; empty slots hold the
          out-of-vocabulary sentinel W.
    vals: [K, S] f32 tf-idf weights, L1-normalized per row; 0 at
          sentinel slots.
    `score_rows` reproduces the dense [K, W] L1 scores exactly."""

    ids: torch.Tensor
    vals: torch.Tensor

    @staticmethod
    def empty(n_kf: int, n_slots: int, n_words: int, device) -> "BowTable":
        return BowTable(
            torch.full((n_kf, n_slots), n_words, dtype=torch.int32,
                       device=device),
            torch.zeros((n_kf, n_slots), device=device),
        )


def update_bow_row(ids: torch.Tensor, vals: torch.Tensor, level_desc: tuple,
                   weights: torch.Tensor, k: int, depth: int,
                   desc: torch.Tensor, valid: torch.Tensor, row: int):
    """Transform + tf-idf + sparse row write, in place on `ids`/`vals`.

    Duplicate words across features are summed in one dense [W+1]
    scratch (a float scatter-add, whose order may move a value by an
    ulp), then compacted: sort the word ids, keep first occurrences, sort
    again with the sentinel W last, gather the sums. Returns (ids, vals)."""
    words = _descend(level_desc, k, depth, desc, valid)
    W = weights.shape[0]
    wc = torch.where(words >= 0, words, W)
    dense = _tfidf(words, weights, W + 1, wc)[:W]
    dense = torch.cat([dense, dense.new_zeros((1,))])   # the sentinel's slot
    norm = torch.clamp(torch.sum(dense), min=1e-9)
    ws = torch.sort(wc).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=ws.device),
                       ws[1:] != ws[:-1]]) & (ws < W)
    uniq = torch.sort(torch.where(first, ws, W)).values[: ids.shape[1]]
    ids[row] = uniq
    vals[row] = dense[uniq.long()] / norm    # sentinel slots read 0
    return ids, vals


def score_rows(ids: torch.Tensor, vals: torch.Tensor,
               query: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of a dense [W] query against sparse rows [K,S] ->
    [K]: the sum over shared words of the minima."""
    qp = torch.cat([query, query.new_zeros((1,))])
    return torch.sum(torch.minimum(qp[ids.long()], vals), dim=-1)


def densify_bow_row(ids: torch.Tensor, vals: torch.Tensor, row: int,
                    n_words: int) -> torch.Tensor:
    """One sparse row -> dense [W] vector (for use as a query)."""
    dense = torch.zeros((n_words + 1,), device=vals.device)
    return dense.index_add_(0, ids[row].long(), vals[row])[:n_words]


def query_bow(level_desc: tuple, weights: torch.Tensor, k: int, depth: int,
              desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Transform + L1-normalized tf-idf vector [W] of a query frame."""
    words = _descend(level_desc, k, depth, desc, valid)
    v = _tfidf(words, weights, weights.shape[0], words.clamp(min=0))
    return v / torch.clamp(torch.sum(v), min=1e-9)


def bow_vector(vocab: Vocab, words: torch.Tensor) -> torch.Tensor:
    """[N] word ids -> dense L1-normalized tf-idf vector [W]."""
    v = _tfidf(words, vocab.weights, vocab.n_words, words.clamp(min=0))
    return v / torch.clamp(torch.sum(v), min=1e-9)


def score_l1(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score for L1-normalized vectors: sum of minima. [W] vs
    [K,W] -> [K]."""
    return torch.sum(torch.minimum(v1, v2), dim=-1)

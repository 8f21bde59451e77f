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
ORBvoc.txt into the same layout. Training a vocabulary is an offline host
tool that stays with the JAX package for now.
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

"""The port's BoW vocabulary and keyframe database
(`splslam_tpu_torch/bow/vocabulary.py`) against the JAX package's on the
same inputs: the bundled vocabularies, random and real ORB descriptors.

Tolerances: word ids, BoW row ids and level tables exact (integer
popcount argmin, ties to the first child on both sides); tf-idf values
and scores within 1e-6 (float scatter-add and sum order). Small
vocabularies are trained with the JAX package's `train` (an offline host
tool the port does not carry) and carried across with `convert`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.bow import vocabulary as JV
from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu_torch import convert
from splslam_tpu_torch.bow import vocabulary as TV
from splslam_tpu_torch.ops.orb import extract_orb
from splslam_tpu_torch.ops.pyramid import PyramidSpec

ATOL = 1e-6


def _bundled(name):
    return os.path.join(TV.ASSETS, name)


@pytest.fixture(scope="module")
def voc100k():
    path = _bundled("vocab_100k.npz")
    return JV.load(path), TV.load(path, "cpu")


@pytest.fixture(scope="module")
def orb_desc():
    """[2, 600, 8] uint32 ORB descriptors of two frames of the synthetic
    forward sequence, with their valid masks."""
    _, _, frames, _ = make_stereo_sequence(n_frames=8, motion="forward",
                                           width=320, height=240)
    spec = PyramidSpec.create(240, 320, 4, 1.2, 600)
    out = [extract_orb(torch.from_numpy(frames[i][0].astype(np.float32)), spec)
           for i in (0, 7)]
    desc = np.stack([f.desc.numpy().view(np.uint32) for f in out])
    valid = np.stack([f.valid.numpy() for f in out])
    return desc, valid


def _small_vocab(seed=2, n=600, k=4, depth=2):
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2 ** 32, (n + 300, 8), dtype=np.uint32)
    jv = JV.train(desc[:n], k=k, depth=depth, seed=0)
    return jv, convert.vocab_from_numpy(jax.device_get(jv), "cpu"), desc[n:]


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("name", TV.BUNDLED)
def test_bundled_vocabularies_load_equal(name):
    jv = JV.load(_bundled(name))
    tv = TV.load(_bundled(name), "cpu")
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words)
    assert len(tv.level_desc) == len(jv.level_desc) == jv.depth
    for l, (a, b) in enumerate(zip(tv.level_desc, jv.level_desc)):
        assert tuple(a.shape) == (jv.k ** (l + 1), 8) and a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))


def test_default_vocab_path_is_the_100k_vocabulary():
    assert TV.default_vocab_path() == _bundled("vocab_100k.npz")


@pytest.mark.parametrize("kind", ["random", "orb"])
def test_transform_words_exact(voc100k, orb_desc, kind):
    jv, tv = voc100k
    if kind == "random":
        rng = np.random.default_rng(0)
        desc = rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32)
        valid = rng.random(2000) < 0.9
    else:
        desc, valid = orb_desc[0][0], orb_desc[1][0]
    want = np.asarray(JV.transform_words(jv, jnp.asarray(desc), jnp.asarray(valid)))
    got = TV.transform_words(tv, _t(desc), _t(valid)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all() and (got[valid] < tv.n_words).all()
    if kind == "orb":
        assert len(np.unique(got[valid])) > 100


def _rows_both(jv, tv, descs, valids, K):
    S = descs[0].shape[0]
    ids_j = jnp.full((K, S), jv.n_words, jnp.int32)
    vals_j = jnp.zeros((K, S), jnp.float32)
    table = TV.BowTable.empty(K, S, tv.n_words, "cpu")
    for row, (d, v) in enumerate(zip(descs, valids)):
        ids_j, vals_j = JV.update_bow_row(
            ids_j, vals_j, jv.level_desc, jv.weights, jv.k, jv.depth,
            jnp.asarray(d), jnp.asarray(v), jnp.int32(row))
        TV.update_bow_row(table.ids, table.vals, tv.level_desc, tv.weights,
                          tv.k, tv.depth, _t(d), _t(v), row)
    return np.asarray(ids_j), np.asarray(vals_j), table


@pytest.mark.parametrize("which", ["100k_orb", "small_random"])
def test_update_bow_row_matches_jax(voc100k, orb_desc, which):
    if which == "100k_orb":
        jv, tv = voc100k
        descs, valids = orb_desc
    else:
        jv, tv, pool = _small_vocab()    # 16 words: many duplicate words
        descs = pool[:192].reshape(3, 64, 8)
        valids = np.stack([np.arange(64) < 64 - 5 * k for k in range(3)])
    ids_j, vals_j, table = _rows_both(jv, tv, descs, valids, K=len(descs) + 1)
    np.testing.assert_array_equal(table.ids.numpy(), ids_j)
    np.testing.assert_allclose(table.vals.numpy(), vals_j, rtol=0, atol=ATOL)
    # ascending unique words, then the sentinel W; the unused row untouched
    for r in range(len(descs)):
        row = table.ids[r].numpy()
        live = row[row < tv.n_words]
        assert (np.diff(live) > 0).all() and (row[len(live):] == tv.n_words).all()
        assert abs(float(table.vals[r].sum()) - 1.0) < 1e-5
    assert (table.ids[-1] == tv.n_words).all() and (table.vals[-1] == 0).all()


def test_query_score_densify_match_jax(voc100k, orb_desc):
    jv, tv = voc100k
    descs, valids = orb_desc
    ids_j, vals_j, table = _rows_both(jv, tv, descs, valids, K=3)
    for d, v in zip(descs, valids):
        qj = np.asarray(JV.query_bow(jv.level_desc, jv.weights, jv.k, jv.depth,
                                     jnp.asarray(d), jnp.asarray(v)))
        qt = TV.query_bow(tv.level_desc, tv.weights, tv.k, tv.depth, _t(d), _t(v))
        np.testing.assert_allclose(qt.numpy(), qj, rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            TV.score_rows(table.ids, table.vals, qt).numpy(),
            np.asarray(JV.score_rows(jnp.asarray(ids_j), jnp.asarray(vals_j),
                                     jnp.asarray(qj))), rtol=0, atol=ATOL)
    for row in range(2):
        np.testing.assert_allclose(
            TV.densify_bow_row(table.ids, table.vals, row, tv.n_words).numpy(),
            np.asarray(JV.densify_bow_row(jnp.asarray(ids_j),
                                          jnp.asarray(vals_j), row, jv.n_words)),
            rtol=0, atol=ATOL)


def test_bow_vector_and_score_l1_match_jax():
    jv, tv, pool = _small_vocab(seed=0, n=1500, k=5, depth=3)
    wj = JV.transform_words(jv, jnp.asarray(pool[:300]), jnp.ones(300, bool))
    wt = TV.transform_words(tv, _t(pool[:300]), torch.ones(300, dtype=torch.bool))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    va, vb = TV.bow_vector(tv, wt[:150]), TV.bow_vector(tv, wt[150:])
    np.testing.assert_allclose(va.numpy(), np.asarray(JV.bow_vector(jv, wj[:150])),
                               rtol=0, atol=ATOL)
    got = float(TV.score_l1(va, vb))
    want = float(JV.score_l1(JV.bow_vector(jv, wj[:150]), JV.bow_vector(jv, wj[150:])))
    assert abs(got - want) <= ATOL
    assert float(TV.score_l1(va, va)) > got


def test_sparse_bow_table_scores_match_dense():
    """Port of tests/test_reloc.py's test: the sparse rows reproduce the
    dense [K,W] L1 scores, duplicate words aggregated per word."""
    _, tv, pool = _small_vocab()
    K, N = 3, 64
    table = TV.BowTable.empty(K, N, tv.n_words, "cpu")
    dense_rows = []
    for k in range(K):
        d = _t(pool[k * N:(k + 1) * N])
        valid = torch.from_numpy(np.arange(N) < N - 5 * k)
        TV.update_bow_row(table.ids, table.vals, tv.level_desc, tv.weights,
                          tv.k, tv.depth, d, valid, k)
        dense_rows.append(TV.query_bow(tv.level_desc, tv.weights, tv.k,
                                       tv.depth, d, valid).numpy())
    dense_rows = np.stack(dense_rows)
    for k in range(K):
        np.testing.assert_allclose(
            TV.densify_bow_row(table.ids, table.vals, k, tv.n_words).numpy(),
            dense_rows[k], rtol=1e-6, atol=1e-7)
    q = TV.query_bow(tv.level_desc, tv.weights, tv.k, tv.depth,
                     _t(pool[200:200 + N]), torch.ones(N, dtype=torch.bool))
    want = np.minimum(dense_rows, q.numpy()[None, :]).sum(-1)
    np.testing.assert_allclose(TV.score_rows(table.ids, table.vals, q).numpy(),
                               want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_vocab_save_load_roundtrip(tmp_path, writer):
    """A vocabulary saved by either package loads into the other with the
    same tables, the same file layout (keys and dtypes), and sends
    descriptors to the same words."""
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 2 ** 32, (800, 8), dtype=np.uint32)
    jv = JV.train(desc, k=4, depth=2, seed=0)
    tv = TV.train(desc, k=4, depth=2, seed=0, device="cpu")
    p = str(tmp_path / "voc.npz")
    ref = str(tmp_path / "ref.npz")
    JV.save(jv, ref)
    if writer == "jax":
        JV.save(jv, p)
        jv2, tv2 = jv, TV.load(p, "cpu")
    else:
        TV.save(tv, p)
        jv2, tv2 = JV.load(p), tv
    with np.load(p) as got, np.load(ref) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for tl, jl in zip(tv2.level_desc, jv2.level_desc):
        np.testing.assert_array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    np.testing.assert_array_equal(tv2.weights.numpy(), np.asarray(jv2.weights))
    w1 = JV.transform_words(jv2, jnp.asarray(desc[:100]), jnp.ones(100, bool))
    w2 = TV.transform_words(tv2, _t(desc[:100]), torch.ones(100, dtype=torch.bool))
    np.testing.assert_array_equal(w2.numpy(), np.asarray(w1))


def test_bow_table_crosses_convert(voc100k, orb_desc):
    jv, tv = voc100k
    ids_j, vals_j, table = _rows_both(jv, tv, *orb_desc, K=3)
    back = convert.bow_table_to_numpy(table)
    assert back.ids.dtype == np.int32 and back.vals.dtype == np.float32
    again = convert.bow_table_from_numpy(JV.BowTable(ids_j, vals_j), "cpu")
    np.testing.assert_array_equal(again.ids.numpy(), back.ids)
    np.testing.assert_allclose(again.vals.numpy(), back.vals, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k,depth,with_images", [(4, 2, False), (10, 3, False),
                                                 (10, 3, True)])
def test_train_matches_jax(k, depth, with_images):
    """The port's `train` (host numpy, the reference's draws) against the
    JAX package's on the same descriptors: level tables and weights exactly
    equal, with the features-per-image idf proxy and with image ids (the
    true idf)."""
    rng = np.random.default_rng(7)
    n = 600 if depth == 2 else 6000
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    kw = dict(k=k, depth=depth, seed=3)
    if with_images:
        kw["image_ids"] = rng.integers(0, 40, n)
    jv = JV.train(desc, **kw)
    tv = TV.train(desc, **kw, device="cpu")
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words)
    assert len(tv.level_desc) == len(jv.level_desc) == depth
    for tl, jl in zip(tv.level_desc, jv.level_desc):
        assert tl.dtype == torch.int32 and tl.shape == (jl.shape[0], 8)
        np.testing.assert_array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    assert float(tv.weights.max()) > 0
    # and the port's vocabulary sends descriptors to the JAX package's words
    w1 = JV.transform_words(jv, jnp.asarray(desc[:200]), jnp.ones(200, bool))
    w2 = TV.transform_words(tv, _t(desc[:200]), torch.ones(200, dtype=torch.bool))
    np.testing.assert_array_equal(w2.numpy(), np.asarray(w1))

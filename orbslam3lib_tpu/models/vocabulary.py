"""Binary BoW vocabulary: k-medians Hamming tree + batched descent + dense
tf-idf scoring.

Replacement for the reference's DBoW2 stack
(/root/reference app/src/main/cpp: CustomVocabulary.h binary fast-loader over
DBoW2 TemplatedVocabulary; KeyFrameDatabase.{h,cc} inverted-file index with
DetectNBestCandidates / DetectRelocalizationCandidates). Differences, by
design (SURVEY.md §2.3 "batched tree descent as gather/argmin kernels"):

  * training is plain NumPy k-medians (majority bit) on the host — the
    reference ships a pre-trained vocabulary file; here we can train from
    any descriptor sample (there is no downloadable ORB vocab in this
    environment) and save/load as .npz;
  * descent is fully batched: every level is one gather of k child centroids
    per descriptor + one Hamming argmin (matmul), N descriptors at once;
  * the inverted file becomes a dense (K, W) tf-idf matrix: database query =
    one matvec; similarity scores for ALL keyframes in one shot. At W=4096
    words and K<=1024 keyframes this is a few MB — brute force on the
    device instead of index chasing.

L1 similarity score follows DBoW2: s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class Vocabulary(NamedTuple):
    """Flat tree: level l has k^l nodes; centroids stored per level.

    centroids: tuple of (k^l_prev * k, 256) int8 arrays, one per level
               (level arrays are indexed by parent*k + child).
    idf:       (W,) float32 inverse document frequency (1 at train time,
               refreshed from the database if desired).
    k, depth:  branching factor and number of levels; W = k**depth.
    """
    centroids: tuple
    idf: jnp.ndarray
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.k ** self.depth


def train_vocabulary(descriptors: np.ndarray, k: int = 8, depth: int = 4,
                     n_iter: int = 8, seed: int = 0,
                     doc_ids: np.ndarray | None = None) -> Vocabulary:
    """Hierarchical k-medians on 0/1 descriptor bits (host-side, NumPy).

    descriptors: (N, 256) 0/1. Returns a Vocabulary with k^depth words.
    doc_ids: optional (N,) int document (image) label per descriptor; when
    given, per-word idf = log(n_docs / (1 + df)) is computed from the
    training corpus (DBoW2's TF_IDF weighting, TemplatedVocabulary
    setNodeWeights), else idf = 1.

    Degenerate (empty / tiny) clusters replicate the group's first real
    centroid, so unused children can never strictly win a descent argmin
    over a populated sibling.
    """
    rng = np.random.default_rng(seed)
    desc = descriptors.astype(np.int8)

    def kmedians(data, k):
        if len(data) == 0:
            return np.zeros((k, data.shape[1] if data.ndim > 1 else 256), np.int8)
        init = data[rng.choice(len(data), min(k, len(data)), replace=False)]
        cents = np.zeros((k, data.shape[1]), np.int8)
        cents[:len(init)] = init
        cents[len(init):] = init[0]          # pad with a real centroid
        for _ in range(n_iter):
            d = (data[:, None, :] != cents[None, :, :]).sum(-1)
            assign = d.argmin(1)
            for c in range(k):
                sel = data[assign == c]
                if len(sel):
                    cents[c] = (sel.mean(0) > 0.5).astype(np.int8)
                else:
                    cents[c] = cents[0]      # dead cluster: mirror a live one
        return cents

    levels = []
    groups = [desc]
    for lvl in range(depth):
        cents = np.zeros((len(groups) * k, desc.shape[1]), np.int8)
        next_groups = []
        for gi, g in enumerate(groups):
            c = kmedians(g, k)
            cents[gi * k:(gi + 1) * k] = c
            if len(g):
                d = (g[:, None, :] != c[None, :, :]).sum(-1)
                assign = d.argmin(1)
            else:
                assign = np.zeros(0, np.int64)
            for ci in range(k):
                next_groups.append(g[assign == ci] if len(g) else g)
        levels.append(jnp.asarray(cents))
        groups = next_groups

    W = k ** depth
    voc = Vocabulary(centroids=tuple(levels), idf=jnp.ones(W, jnp.float32),
                     k=k, depth=depth)
    if doc_ids is not None:
        words = np.asarray(word_ids(voc, jnp.asarray(desc)))
        n_docs = len(np.unique(doc_ids))
        df = np.zeros(W, np.float64)
        for w in {(int(w), int(d)) for w, d in zip(words, doc_ids)}:
            df[w[0]] += 1.0
        idf = np.log(n_docs / (1.0 + df)).clip(min=0.0) + 1e-3
        voc = voc._replace(idf=jnp.asarray(idf.astype(np.float32)))
    return voc


DEFAULT_VOCAB_PATH = __file__.rsplit("/", 2)[0] + "/data/orb_vocab.npz"


def save_vocabulary(voc: Vocabulary, path: str):
    np.savez_compressed(
        path, k=voc.k, depth=voc.depth, idf=np.asarray(voc.idf),
        **{f"level_{i}": np.asarray(c) for i, c in enumerate(voc.centroids)})


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    k, depth = int(z["k"]), int(z["depth"])
    cents = tuple(jnp.asarray(z[f"level_{i}"]) for i in range(depth))
    return Vocabulary(centroids=cents, idf=jnp.asarray(z["idf"]), k=k, depth=depth)


@partial(jax.jit, static_argnames=("k", "depth"))
def _descend(centroid_levels, desc_bits, k: int, depth: int):
    N = desc_bits.shape[0]
    node = jnp.zeros(N, jnp.int32)
    d = desc_bits.astype(jnp.bfloat16)
    s_d = jnp.sum(desc_bits.astype(jnp.float32), axis=1)
    for lvl in range(depth):
        cents = centroid_levels[lvl]                       # (nodes*k, 256)
        child_base = node * k
        cand = cents[child_base[:, None] + jnp.arange(k)[None, :]]  # (N,k,256)
        # DEFAULT precision: 0/1 bit dots are exact in bf16 (see __init__.py)
        dot = jnp.einsum("nkc,nc->nk", cand.astype(jnp.bfloat16), d,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.DEFAULT)
        s_c = jnp.sum(cand.astype(jnp.float32), axis=2)
        ham = s_c + s_d[:, None] - 2.0 * dot
        node = child_base + jnp.argmin(ham, axis=1).astype(jnp.int32)
    return node  # word ids in [0, k^depth)


def word_ids(voc: Vocabulary, desc_bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) 0/1 -> (N,) word ids via batched tree descent."""
    return _descend(voc.centroids, desc_bits, voc.k, voc.depth)


@partial(jax.jit, static_argnames=("n_words",))
def bow_vector(words: jnp.ndarray, valid: jnp.ndarray, idf: jnp.ndarray,
               n_words: int) -> jnp.ndarray:
    """Word ids (N,) + validity -> L1-normalized tf-idf vector (W,)."""
    w = jnp.where(valid, words, n_words)
    hist = jnp.zeros(n_words + 1, jnp.float32).at[w].add(1.0)[:n_words]
    v = hist * idf
    return v / jnp.maximum(jnp.sum(v), 1e-9)


def bow_from_descriptors(voc: Vocabulary, desc_bits, valid):
    return bow_vector(word_ids(voc, desc_bits), valid, voc.idf, voc.n_words)


@jax.jit
def l1_scores(bow_db: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 score of query q (W,) against a database (K, W):
    s = 1 - 0.5 |v - w|_1 (vectors already L1-normalized). One fused pass."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(bow_db - q[None, :]), axis=1)

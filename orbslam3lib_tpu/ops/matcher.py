"""Brute-force Hamming kNN-2 matcher as a matmul.

Re-design of the reference's HVX matcher
(/root/reference dsp/src/orbslam_dsp_matcher.cpp: knnMatchORB:32 — per left
descriptor, splat + XOR + vpopcount against 64 right descriptors per vector,
tree-add, dual running (min, second-min, argmin); outputs indices/dist1/dist2
for all pairs; work split across the two extractor threads,
orbslam_dsp.cpp:747-800).

This formulation replaces XOR+popcount entirely: with descriptors stored as
0/1 bit matrices A (Na,256), B (Nb,256),

    hamming(a, b) = sum(a) + sum(b) - 2 a.b

so the full Na x Nb distance matrix is one 256-deep bf16 matmul with f32
accumulation (exact for 0/1 operands) plus a rank-1 correction (the "work
splitting" of the DSP threads becomes a single batched matmul; the
eye/frame batch dim is handled by vmap at the call site). At Na, Nb <= 1024
the distance matrix is at most 4 MB and XLA's GEMM plus one fused row
reduction is the whole kNN-2.

Validity masking uses arithmetic gates (ops/masks.py).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .masks import BIG, penalize, step01


def hamming_matrix(a_bits: jnp.ndarray, b_bits: jnp.ndarray,
                   a_valid: jnp.ndarray | None = None,
                   b_valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """(Na,256) x (Nb,256) 0/1 int8 -> (Na,Nb) float32 Hamming distances.
    Invalid rows/cols are pushed to >= BIG."""
    a = a_bits.astype(jnp.bfloat16)
    b = b_bits.astype(jnp.bfloat16)
    # precision pinned DEFAULT: 0/1 bit dots (<= 256) are exact in bf16, so
    # the package-wide HIGHEST default (geometry-driven, see __init__.py)
    # would only cost matmul throughput here
    dot = jax.lax.dot_general(a, b, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.DEFAULT)
    sa = jnp.sum(a_bits.astype(jnp.float32), axis=1)
    sb = jnp.sum(b_bits.astype(jnp.float32), axis=1)
    d = sa[:, None] + sb[None, :] - 2.0 * dot
    if a_valid is not None:
        d = d + (1.0 - a_valid.astype(jnp.float32))[:, None] * BIG
    if b_valid is not None:
        d = d + (1.0 - b_valid.astype(jnp.float32))[None, :] * BIG
    return d


def knn2(dist: jnp.ndarray):
    """Per row: (best_idx, best_dist, second_dist). Matches the reference's
    (indices, dist1, dist2) output contract (orbslam_dsp_matcher.cpp:32).

    Arithmetic two-pass min instead of top_k: find the row min, penalize the
    argmin column, min again — elementwise work and reductions, no sort.
    """
    n = dist.shape[1]
    best = jnp.argmin(dist, axis=1)
    d1 = jnp.min(dist, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    # gate "is the argmin column" without pred: |col - best| >= 1 keeps
    not_best = step01(jnp.abs(cols - best[:, None]).astype(jnp.float32))
    d2 = jnp.min(dist + (1.0 - not_best) * BIG, axis=1)
    return best, d1, d2


def knn_match(a_bits, b_bits, a_valid=None, b_valid=None):
    """Full kNN-2 BF match a->b. Returns (best_idx, d1, d2) each (Na,)."""
    return knn2(hamming_matrix(a_bits, b_bits, a_valid, b_valid))


def mutual_best(dist: jnp.ndarray):
    """Mutual nearest-neighbor: (Na,) best idx into b plus a float gate where
    a and b agree (SearchForInitialization-style)."""
    best_ab = jnp.argmin(dist, axis=1)
    best_ba = jnp.argmin(dist, axis=0)
    agree = best_ba[best_ab] == jnp.arange(dist.shape[0])
    return best_ab, agree


# ---------------------------------------------------------------------------
# NumPy oracle (scalar popcount loop, mirrors ORBmatcher::DescriptorDistance /
# knnMatchORB semantics)
# ---------------------------------------------------------------------------

def hamming_oracle(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    return (a_bits[:, None, :] != b_bits[None, :, :]).sum(-1).astype(np.float32)


def knn2_oracle(a_bits: np.ndarray, b_bits: np.ndarray,
                a_valid: np.ndarray | None = None,
                b_valid: np.ndarray | None = None):
    """NumPy kNN-2 with the knn_match contract: (best_idx, d1, d2) per row
    of a; invalid rows/cols carry +BIG; ties go to the lowest index."""
    d = hamming_oracle(np.asarray(a_bits), np.asarray(b_bits))
    if a_valid is not None:
        d = d + np.where(np.asarray(a_valid), 0.0, BIG)[:, None]
    if b_valid is not None:
        d = d + np.where(np.asarray(b_valid), 0.0, BIG)[None, :]
    d = d.astype(np.float32)
    best = np.argmin(d, axis=1)            # first minimum = lowest index
    rows = np.arange(d.shape[0])
    d1 = d[rows, best]
    d_rest = d.copy()
    d_rest[rows, best] = np.inf
    return best.astype(np.int32), d1, d_rest.min(axis=1)

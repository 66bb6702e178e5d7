"""Closed-form batched small-matrix kernels.

XLA lowers `jnp.linalg.{inv,svd}` on batched tiny matrices to iterative /
LU routines; the closed-form adjugate formulations below are pure
elementwise arithmetic over the batch. These sit in the per-keyframe mapper
hot path (Schur landmark-block inverses, DLT triangulation). Their time on
the GPU against `jnp.linalg` is not measured yet.

All functions are batched over arbitrary leading dims and differentiable.
"""
from __future__ import annotations

import jax.numpy as jnp


def inv3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of (...,3,3) matrices via the adjugate.

    Intended for well-conditioned blocks (e.g. LM-damped landmark Hessians);
    no pivoting. Singular inputs produce inf/nan, as with jnp.linalg.inv.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A00 = e * i - f * h
    A10 = f * g - d * i
    A20 = d * h - e * g
    A01 = c * h - b * i
    A11 = a * i - c * g
    A21 = b * g - a * h
    A02 = b * f - c * e
    A12 = c * d - a * f
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    adj = jnp.stack([jnp.stack([A00, A01, A02], -1),
                     jnp.stack([A10, A11, A12], -1),
                     jnp.stack([A20, A21, A22], -1)], -2)
    return adj / det[..., None, None]


def adjugate4(M: jnp.ndarray) -> jnp.ndarray:
    """Adjugate of (...,4,4) matrices (adj(M) = det(M) M^-1) by cofactor
    expansion over 2x2 minors — ~200 flops of elementwise arithmetic."""
    m00, m01, m02, m03 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2], M[..., 0, 3]
    m10, m11, m12, m13 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2], M[..., 1, 3]
    m20, m21, m22, m23 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2], M[..., 2, 3]
    m30, m31, m32, m33 = M[..., 3, 0], M[..., 3, 1], M[..., 3, 2], M[..., 3, 3]
    s0 = m00 * m11 - m10 * m01
    s1 = m00 * m12 - m10 * m02
    s2 = m00 * m13 - m10 * m03
    s3 = m01 * m12 - m11 * m02
    s4 = m01 * m13 - m11 * m03
    s5 = m02 * m13 - m12 * m03
    c5 = m22 * m33 - m32 * m23
    c4 = m21 * m33 - m31 * m23
    c3 = m21 * m32 - m31 * m22
    c2 = m20 * m33 - m30 * m23
    c1 = m20 * m32 - m30 * m22
    c0 = m20 * m31 - m30 * m21
    a00 = m11 * c5 - m12 * c4 + m13 * c3
    a01 = -m01 * c5 + m02 * c4 - m03 * c3
    a02 = m31 * s5 - m32 * s4 + m33 * s3
    a03 = -m21 * s5 + m22 * s4 - m23 * s3
    a10 = -m10 * c5 + m12 * c2 - m13 * c1
    a11 = m00 * c5 - m02 * c2 + m03 * c1
    a12 = -m30 * s5 + m32 * s2 - m33 * s1
    a13 = m20 * s5 - m22 * s2 + m23 * s1
    a20 = m10 * c4 - m11 * c2 + m13 * c0
    a21 = -m00 * c4 + m01 * c2 - m03 * c0
    a22 = m30 * s4 - m31 * s2 + m33 * s0
    a23 = -m20 * s4 + m21 * s2 - m23 * s0
    a30 = -m10 * c3 + m11 * c1 - m12 * c0
    a31 = m00 * c3 - m01 * c1 + m02 * c0
    a32 = -m30 * s3 + m31 * s1 - m32 * s0
    a33 = m20 * s3 - m21 * s1 + m22 * s0
    return jnp.stack([jnp.stack([a00, a01, a02, a03], -1),
                      jnp.stack([a10, a11, a12, a13], -1),
                      jnp.stack([a20, a21, a22, a23], -1),
                      jnp.stack([a30, a31, a32, a33], -1)], -2)


def smallest_eigvec4_psd(M: jnp.ndarray, n_refine: int = 2) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of a (...,4,4) symmetric PSD
    matrix, closed form + power refinement — the SVD-free null-space step
    of DLT triangulation.

    adj(M) = sum_i (prod_{j!=i} lambda_j) v_i v_i^T is dominated by the
    smallest-eigenvalue term by a factor lambda_2/lambda_1, so its best
    column is already ~v_min; each extra multiply by adj(M) gains another
    factor. For near-exact triangulation data lambda_1 ~ 0 and one pass is
    exact. Rank-deficient M (parallel rays) yields adj(M) ~ 0; callers gate
    such cases (parallax/chirality gates) — the guarded normalization
    returns e_4 there rather than NaN.
    """
    # normalize scale so the cubic-in-M adjugate stays in f32 range
    s = jnp.maximum(jnp.trace(M, axis1=-2, axis2=-1) / 4.0, 1e-20)
    A = adjugate4(M / s[..., None, None])
    # start from the column with the largest diagonal entry (adj is PSD too)
    j = jnp.argmax(jnp.diagonal(A, axis1=-2, axis2=-1), axis=-1)
    idx = jnp.broadcast_to(j[..., None, None], j.shape + (4, 1))
    x = jnp.take_along_axis(A, idx, axis=-1)[..., 0]
    e4 = jnp.zeros_like(x).at[..., 3].set(1.0)

    def _norm(v):
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        return jnp.where(n > 1e-12, v / jnp.maximum(n, 1e-30), e4)

    x = _norm(x)
    for _ in range(n_refine):
        x = _norm(jnp.einsum("...ij,...j->...i", A, x))
    return x

"""Two-view reconstruction for monocular initialization.

Re-design of the reference's TwoViewReconstruction
(/root/reference app/src/main/cpp/src/TwoViewReconstruction.cc: parallel
8-point F and 4-point H RANSAC with sigma-scored symmetric errors, model
selection by score ratio, motion-hypothesis cheirality check, triangulation —
used by Pinhole::ReconstructWithTwoViews for Tracking's
MonocularInitialization, Tracking.cc:2505).

The reference's sequential 200-iteration RANSAC with early exits becomes two
fully batched hypothesis sweeps (vmap over hypotheses, each solving a small
SVD), and the 4-way (R,t) disambiguation evaluates all four chirality
candidates in parallel.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import cameras, lie


def _normalize(pts):
    """Hartley normalization: zero-mean, mean abs deviation 1. (N,2)."""
    mu = jnp.mean(pts, axis=0)
    d = jnp.mean(jnp.abs(pts - mu), axis=0)
    s = 1.0 / jnp.maximum(d, 1e-9)
    T = jnp.asarray
    Tm = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    Tm = Tm.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    Tm = Tm.at[0, 2].set(-mu[0] * s[0]).at[1, 2].set(-mu[1] * s[1])
    return (pts - mu) * s, Tm


def _eight_point_F(x1, x2, w=None):
    """(S,2),(S,2) -> rank-2 fundamental matrix (coords pre-normalized).
    Optional per-row weights w (S,) enable inlier re-fits on all matches."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                   jnp.ones_like(u1)], axis=1)
    if w is not None:
        A = A * w[:, None]
    _, _, vt = jnp.linalg.svd(A)
    F = vt[-1].reshape(3, 3)
    U, D, Vt = jnp.linalg.svd(F)
    D = D.at[2].set(0.0)
    return U @ jnp.diag(D) @ Vt


def _four_point_H(x1, x2):
    """(4,2),(4,2) -> homography x2 ~ H x1."""
    def rows(p1, p2):
        u1, v1 = p1[0], p1[1]
        u2, v2 = p2[0], p2[1]
        r1 = jnp.array([0.0, 0.0, 0.0, -u1, -v1, -1.0, v2 * u1, v2 * v1, v2])
        r2 = jnp.array([u1, v1, 1.0, 0.0, 0.0, 0.0, -u2 * u1, -u2 * v1, -u2])
        return jnp.stack([r1, r2])
    A = jax.vmap(rows)(x1, x2).reshape(-1, 9)
    _, _, vt = jnp.linalg.svd(A)
    return vt[-1].reshape(3, 3)


def _score_F(F, p1, p2, valid, sigma: float = 1.0):
    """Reference CheckFundamental scoring: symmetric epipolar chi2 with
    per-direction threshold 3.841, capped contribution 5.991."""
    ones = jnp.ones((p1.shape[0], 1))
    x1 = jnp.concatenate([p1, ones], axis=1)
    x2 = jnp.concatenate([p2, ones], axis=1)
    l2 = x1 @ F.T      # lines in image 2
    l1 = x2 @ F        # lines in image 1
    s2 = (jnp.sum(l2 * x2, 1) ** 2) / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    s1 = (jnp.sum(l1 * x1, 1) ** 2) / (l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    inv_s2 = 1.0 / (sigma * sigma)
    c1 = s1 * inv_s2
    c2 = s2 * inv_s2
    v = valid.astype(jnp.float32)
    in1 = jnp.clip(3.841 - c1 + 1.0, 0.0, 1.0)
    in2 = jnp.clip(3.841 - c2 + 1.0, 0.0, 1.0)
    score = jnp.sum(v * (in1 * (5.991 - c1) + in2 * (5.991 - c2)))
    inlier = (v * in1 * in2) > 0.5
    return score, inlier


def _score_H(H, p1, p2, valid, sigma: float = 1.0):
    """CheckHomography: symmetric transfer chi2, threshold 5.991."""
    ones = jnp.ones((p1.shape[0], 1))
    x1 = jnp.concatenate([p1, ones], axis=1)
    x2 = jnp.concatenate([p2, ones], axis=1)
    Hx1 = x1 @ H.T
    Hx1 = Hx1[:, :2] / jnp.where(jnp.abs(Hx1[:, 2:]) < 1e-9, 1e-9, Hx1[:, 2:])
    Hinv = jnp.linalg.inv(H)
    Hx2 = x2 @ Hinv.T
    Hx2 = Hx2[:, :2] / jnp.where(jnp.abs(Hx2[:, 2:]) < 1e-9, 1e-9, Hx2[:, 2:])
    c1 = jnp.sum((Hx2 - p1) ** 2, 1) / (sigma * sigma)
    c2 = jnp.sum((Hx1 - p2) ** 2, 1) / (sigma * sigma)
    v = valid.astype(jnp.float32)
    in1 = jnp.clip(5.991 - c1 + 1.0, 0.0, 1.0)
    in2 = jnp.clip(5.991 - c2 + 1.0, 0.0, 1.0)
    score = jnp.sum(v * (in1 * (5.991 - c1) + in2 * (5.991 - c2)))
    inlier = (v * in1 * in2) > 0.5
    return score, inlier


@partial(jax.jit, static_argnames=("n_hyp",))
def reconstruct_two_views(uv1, uv2, valid, cam_params, n_hyp: int = 200,
                          sigma: float = 1.0, seed: int = 0):
    """Full monocular initialization from matched keypoints (pinhole).

    uv1/uv2 (N,2) pixel matches, valid (N,). Returns dict with:
    success (bool-ish f32), R, t (unit-norm), p3d (N,3) in cam-1 frame,
    tri_ok (N,) triangulation validity, model_is_H score ratio.
    """
    N = uv1.shape[0]
    key = jax.random.PRNGKey(seed)
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 8), p=probs)

    n1, T1 = _normalize(uv1)
    n2, T2 = _normalize(uv2)

    def hyp_F(si):
        Fn = _eight_point_F(n1[si], n2[si])
        F = T2.T @ Fn @ T1
        return F / jnp.maximum(jnp.abs(F[2, 2]), 1e-12)

    def hyp_H(si):
        Hn = _four_point_H(n1[si[:4]], n2[si[:4]])
        H = jnp.linalg.inv(T2) @ Hn @ T1
        return H / jnp.where(jnp.abs(H[2, 2]) < 1e-12, 1e-12, H[2, 2])

    Fs = jax.vmap(hyp_F)(idx)
    Hs = jax.vmap(hyp_H)(idx)
    sF, inlF = jax.vmap(lambda F: _score_F(F, uv1, uv2, valid, sigma))(Fs)
    sH, inlH = jax.vmap(lambda H: _score_H(H, uv1, uv2, valid, sigma))(Hs)
    bF = jnp.argmax(sF)
    bH = jnp.argmax(sH)
    ratio_H = jnp.max(sH) / jnp.maximum(jnp.max(sH) + jnp.max(sF), 1e-9)

    # polish: re-fit F on all inliers of the best hypothesis, twice
    F = Fs[bF]
    inl_fit = inlF[bF]
    for _ in range(2):
        Fn = _eight_point_F(n1, n2, inl_fit.astype(jnp.float32))
        F = T2.T @ Fn @ T1
        F = F / jnp.maximum(jnp.abs(F[2, 2]), 1e-12)
        _, inl_fit = _score_F(F, uv1, uv2, valid, sigma)

    # E from F, 4-way decomposition, chirality (ReconstructF semantics)
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    K = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    K = K.at[0, 0].set(fx).at[1, 1].set(fy).at[0, 2].set(cx).at[1, 2].set(cy)
    E = K.T @ F @ K
    U, D, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    tu = U[:, 2]
    tu = tu / jnp.maximum(jnp.linalg.norm(tu), 1e-12)

    ray1 = cameras.pinhole_unproject(cam_params, uv1)
    ray2 = cameras.pinhole_unproject(cam_params, uv2)
    inl = inl_fit

    def check(R21, t21):
        # camera 1 at origin; camera 2 pose Tc2w = (R21, t21). Triangulate in
        # cam1 frame: relative cam1<-cam2: R12 = R21^T, t12 = -R21^T t21
        R12 = R21.T
        t12 = -R21.T @ t21
        p3d, cosp, z1, z2 = cameras.triangulate_two_view(
            ray1, ray2, jnp.broadcast_to(R12, (N, 3, 3)),
            jnp.broadcast_to(t12, (N, 3)))
        uv1_hat = cameras.pinhole_project(cam_params, p3d)
        p_c2 = jnp.einsum("ij,nj->ni", R21, p3d) + t21
        uv2_hat = cameras.pinhole_project(cam_params, p_c2)
        e1 = jnp.sum((uv1_hat - uv1) ** 2, 1)
        e2 = jnp.sum((uv2_hat - uv2) ** 2, 1)
        ok = (inl & (z1 > 0.01) & (z2 > 0.01) & (cosp < 0.99998)
              & (e1 < 4.0 * sigma * sigma * 5.991)
              & (e2 < 4.0 * sigma * sigma * 5.991))
        n_ok = jnp.sum(ok.astype(jnp.int32))
        # parallax statistic (CheckRT, TwoViewReconstruction.cc): cos of the
        # 50th-largest-parallax inlier (sorted ascending cos = descending
        # parallax would be wrong way: reference sorts cosParallax ascending
        # and reads index min(50, size-1), i.e. the 50th SMALLEST cos =
        # 50th LARGEST parallax)
        cosp_m = jnp.where(ok, cosp, 1.0)
        cosp_sorted = jnp.sort(cosp_m)
        idx50 = jnp.clip(jnp.minimum(jnp.int32(50), n_ok) - 1, 0, N - 1)
        return n_ok, p3d, ok, cosp_sorted[idx50]

    cands = [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]
    counts = []
    p3ds = []
    oks = []
    cos50s = []
    for R21, t21 in cands:
        c, p, o, c50 = check(R21, t21)
        counts.append(c)
        p3ds.append(p)
        oks.append(o)
        cos50s.append(c50)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    n_good = counts[best]
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # reference acceptance (ReconstructF, TwoViewReconstruction.cc): clear
    # winner with enough triangulated points AND >= minParallax (1 deg) —
    # without the parallax gate a one-frame forward-motion baseline passes
    # and seeds a map whose translation direction is unconstrained
    second = jnp.sort(counts)[-2]
    parallax_ok = jnp.stack(cos50s)[best] < 0.99985  # cos(1 deg)
    success = ((n_good > 0.7 * jnp.maximum(n_valid, 1)) |
               ((n_good > 50) & (second < 0.75 * n_good))) & parallax_ok
    Rb = jnp.stack([c[0] for c in cands])[best]
    tb = jnp.stack([c[1] for c in cands])[best]
    p3d = jnp.stack(p3ds)[best]
    tri_ok = jnp.stack(oks)[best]
    return {
        "success": success, "R": Rb, "t": tb, "p3d": p3d, "tri_ok": tri_ok,
        "n_good": n_good, "ratio_H": ratio_H,
    }

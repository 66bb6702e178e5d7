"""Sim(3) estimation between keyframes: closed-form Horn + batched RANSAC +
GN refinement.

Replacement for the reference's Sim3Solver
(/root/reference app/src/main/cpp/src/Sim3Solver.cc: 3-point Horn absolute
orientation with scale inside a sequential RANSAC, reprojection-checked in
both cameras) and Optimizer::OptimizeSim3 (Optimizer.cc:2134: g2o solve over
VertexSim3Expmap with bidirectional EdgeSim3ProjectXYZ, Huber, chi2 th 10).

The RANSAC is a vmapped hypothesis sweep; the refinement is a 7-dof GN with
autodiff Jacobians (same pattern as tracking/inertial_opt.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import cameras, lie
from ..utils.robust import huber_weight


def horn_sim3(p1: jnp.ndarray, p2: jnp.ndarray, w: jnp.ndarray,
              fix_scale: bool = False):
    """Weighted Horn/Umeyama: (R12, t12, s12) minimizing
    sum w |p1 - (s R p2 + t)|^2. p1/p2 (N,3), w (N,) weights."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    mu1 = jnp.einsum("n,ni->i", w, p1) / wsum
    mu2 = jnp.einsum("n,ni->i", w, p2) / wsum
    x1 = p1 - mu1
    x2 = p2 - mu2
    cov = jnp.einsum("n,ni,nj->ij", w, x1, x2) / wsum
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(U @ Vt)
    S = jnp.diag(jnp.stack([jnp.float32(1.0), jnp.float32(1.0), det]))
    R = U @ S @ Vt
    var2 = jnp.einsum("n,ni->", w, x2 * x2) / wsum
    s = jnp.where(fix_scale, 1.0,
                  jnp.sum(D * jnp.diag(S)) / jnp.maximum(var2, 1e-9))
    t = mu1 - s * R @ mu2
    return R, t, s


@partial(jax.jit, static_argnames=("cam_model", "n_hyp", "fix_scale"))
def sim3_ransac(p1_c, p2_c, uv1, uv2, valid, cam_params,
                cam_model: int = cameras.PINHOLE, n_hyp: int = 128,
                inlier_px: float = 9.21 ** 0.5 * 2.0,
                fix_scale: bool = False, seed: int = 0):
    """Batched Sim3 RANSAC between matched landmark sets.

    p1_c/p2_c (N,3): matched landmark positions in each keyframe's CAMERA
    frame; uv1/uv2 (N,2): their keypoint measurements. Scoring projects
    s12*R12*p2+t12 into image 1 and the inverse into image 2 (both-direction
    reprojection, Sim3Solver::CheckInliers semantics).

    Returns (R12, t12, s12, inlier_mask, n_inliers)."""
    N = p1_c.shape[0]
    key = jax.random.PRNGKey(seed)
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 3), p=probs)

    def solve(si):
        return horn_sim3(p1_c[si], p2_c[si], jnp.ones(3), fix_scale)

    Rs, ts, ss = jax.vmap(solve)(idx)

    p2in1 = ss[:, None, None] * jnp.einsum("hij,nj->hni", Rs, p2_c) + ts[:, None, :]
    uv1_hat = cameras.project(cam_model, cam_params, p2in1)
    # inverse transform
    Rinv = jnp.swapaxes(Rs, -1, -2)
    sinv = 1.0 / ss
    tinv = -sinv[:, None] * jnp.einsum("hij,hj->hi", Rinv, ts)
    p1in2 = sinv[:, None, None] * jnp.einsum("hij,nj->hni", Rinv, p1_c) + tinv[:, None, :]
    uv2_hat = cameras.project(cam_model, cam_params, p1in2)

    e1 = jnp.sum((uv1_hat - uv1[None]) ** 2, axis=-1)
    e2 = jnp.sum((uv2_hat - uv2[None]) ** 2, axis=-1)
    ok = ((e1 < inlier_px ** 2) & (e2 < inlier_px ** 2)
          & (p2in1[..., 2] > 0.05) & (p1in2[..., 2] > 0.05) & valid[None, :])
    scores = jnp.sum(ok, axis=1)
    best = jnp.argmax(scores)
    return Rs[best], ts[best], ss[best], ok[best], scores[best]


@partial(jax.jit, static_argnames=("cam_model", "n_iters", "fix_scale"))
def optimize_sim3(R12, t12, s12, p1_c, p2_c, uv1, uv2, valid, cam_params,
                  cam_model: int = cameras.PINHOLE, n_iters: int = 10,
                  fix_scale: bool = False, chi2_th: float = 10.0,
                  lm_lambda: float = 1e-3):
    """GN refinement of the Sim3 (OptimizeSim3 semantics: bidirectional
    reprojection, Huber delta sqrt(10), outliers removed by chi2).

    Returns (R12, t12, s12, inlier_mask, n_inliers)."""
    delta = jnp.sqrt(chi2_th)

    def apply(dx, R, t, s):
        dR, dt, dss = lie.sim3_exp(dx)
        R2, t2, s2 = lie.sim3_compose(dR, dt, dss, R, t, s)
        if fix_scale:
            s2 = s
        return lie.normalize_rotation(R2), t2, s2

    def residuals(dx, inlier, R, t, s):
        R2, t2, s2 = apply(dx, R, t, s)
        p2in1 = s2 * (p2_c @ R2.T) + t2
        uv1_hat = cameras.project(cam_model, cam_params, p2in1)
        Ri, ti, si = lie.sim3_inverse(R2, t2, s2)
        p1in2 = si * (p1_c @ Ri.T) + ti
        uv2_hat = cameras.project(cam_model, cam_params, p1in2)
        r = jnp.concatenate([uv1_hat - uv1, uv2_hat - uv2], axis=-1)  # (N,4)
        chi2 = jnp.maximum(jnp.sum(r[:, :2] ** 2, -1), jnp.sum(r[:, 2:] ** 2, -1))
        w = jax.lax.stop_gradient(
            huber_weight(chi2, delta) * inlier * valid)
        return (r * jnp.sqrt(w)[:, None]).reshape(-1), chi2

    def it(carry, _):
        dx, inlier = carry
        r, chi2 = residuals(dx, inlier, R12, t12, s12)
        J = jax.jacfwd(lambda d: residuals(d, inlier, R12, t12, s12)[0])(dx)
        H = J.T @ J
        H = H + lm_lambda * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(7)
        dx2 = dx - jnp.linalg.solve(H, J.T @ r)
        _, chi2n = residuals(dx2, inlier, R12, t12, s12)
        inlier = (chi2n <= chi2_th).astype(jnp.float32)
        return (dx2, inlier), None

    dx0 = jnp.zeros(7, jnp.float32)
    (dx, inlier), _ = jax.lax.scan(it, (dx0, valid.astype(jnp.float32)),
                                   None, length=n_iters)
    R2, t2, s2 = apply(dx, R12, t12, s12)
    mask = (inlier > 0) & valid
    return R2, t2, s2, mask, jnp.sum(mask.astype(jnp.int32))

"""Motion-only pose optimization: batched Gauss-Newton/LM on SE(3).

Replacement for the reference's g2o PoseOptimization
(/root/reference app/src/main/cpp/src/Optimizer.cc:813-1120: per-frame solve
with EdgeSE3ProjectXYZOnlyPose / EdgeStereoSE3ProjectXYZOnlyPose, Huber
kernels with deltas sqrt(5.991)/sqrt(7.815), 4 outer rounds with chi2
re-classification between rounds; the Lynx build cuts the schedule to
2 rounds x {1,2} iterations, Optimizer.cc:990-995).

Design: instead of a graph of edge objects, all observations live in fixed-
capacity masked arrays and every LM iteration is one fused batched pass:
residuals/Jacobians for all edges at once (elementwise), 6x6 normal
equations by einsum reduction, closed-form 6x6 solve. The outer chi2-gating
rounds of the reference become iterations of a lax.fori_loop whose inlier
mask is recomputed each round — identical semantics, no host round trips.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import cameras, lie
from ..utils.robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class PoseObs(NamedTuple):
    """Fixed-capacity observation set for one frame's pose solve.

    p_world   (N, 3)  landmark positions
    uv        (N, 2)  measured pixel coords (left camera)
    inv_sigma2(N,)    per-observation information (1/sigma^2, from pyramid level)
    u_right   (N,)    measured right-cam u for rectified stereo obs (else 0)
    is_stereo (N,)    bool — use the 3D rectified-stereo residual
    valid     (N,)    bool
    """
    p_world: jnp.ndarray
    uv: jnp.ndarray
    inv_sigma2: jnp.ndarray
    u_right: jnp.ndarray
    is_stereo: jnp.ndarray
    valid: jnp.ndarray


def _residuals_jacobians(R, t, obs: PoseObs, cam_model: int, cam_params, bf):
    """Residuals r (N,3), Jacobians J (N,3,6), per-obs chi2 (N,).

    Mono rows use only the first 2 residual components (third is zeroed).
    Stereo adds the rectified right-u residual u_r = u - bf/z (reference
    EdgeStereoSE3ProjectXYZOnlyPose).
    Pose parameterization: left-multiplicative update on Tcw,
    xi = [rho, phi]: d(p_c)/d(xi) = [I | -hat(p_c)].
    """
    p_c = lie.se3_apply(R, t, obs.p_world)  # (N,3)
    uv_hat = cameras.project(cam_model, cam_params, p_c)
    z = p_c[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u_r_hat = uv_hat[..., 0] - bf / z_safe

    r2 = uv_hat - obs.uv
    r3 = jnp.where(obs.is_stereo, u_r_hat - obs.u_right, 0.0)
    r = jnp.concatenate([r2, r3[..., None]], axis=-1)  # (N,3)

    Jproj = cameras.project_jac(cam_model, cam_params, p_c)  # (N,2,3)
    # right-u row: d(u - bf/z)/dp_c = [du/dp] + bf/z^2 * dz/dp
    dz = jnp.zeros_like(p_c).at[..., 2].set(1.0)
    Jur = Jproj[..., 0, :] + (bf / (z_safe * z_safe))[..., None] * dz  # (N,3)
    Jur = jnp.where(obs.is_stereo[..., None], Jur, 0.0)
    Jfull = jnp.concatenate([Jproj, Jur[..., None, :]], axis=-2)  # (N,3,3)

    # d p_c / d xi = [I | -hat(p_c)]  (N,3,6)
    I = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), p_c.shape[:-1] + (3, 3))
    Dp = jnp.concatenate([I, -lie.hat(p_c)], axis=-1)
    J = Jfull @ Dp  # (N,3,6)

    behind = z <= 0.05
    chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
    return r, J, chi2, behind


@partial(jax.jit, static_argnames=("cam_model", "n_rounds", "iters_per_round"))
def pose_optimization(R0, t0, obs: PoseObs, cam_params,
                      cam_model: int = cameras.PINHOLE, bf: float = 0.0,
                      n_rounds: int = 4, iters_per_round: int = 10,
                      lm_lambda: float = 1e-3):
    """Optimize Tcw from 3D-2D matches. Returns (R, t, inlier_mask, n_inliers).

    Matches the reference schedule semantics (Optimizer.cc:984-1050): each
    round re-evaluates the chi2 outlier classification (5.991 mono / 7.815
    stereo) and outliers are excluded from the next round's normal equations
    but re-tested every round (so they can return to the inlier set).
    """
    chi2_th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)

    def gn_iter(carry, _):
        R, t, inlier = carry
        r, J, chi2, behind = _residuals_jacobians(R, t, obs, cam_model, cam_params, bf)
        w_huber = huber_weight(chi2, delta)
        w = obs.inv_sigma2 * w_huber * inlier * obs.valid * (~behind)
        # H = sum_e J^T w J ; b = sum_e J^T w r    (einsum reduction)
        H = jnp.einsum("nri,n,nrj->ij", J, w, J)
        b = jnp.einsum("nri,n,nr->i", J, w, r)
        H = H + lm_lambda * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6)
        dx = -jnp.linalg.solve(H, b)
        dR, dt = lie.se3_exp(dx)
        R_new, t_new = lie.se3_compose(dR, dt, R, t)
        R_new = lie.normalize_rotation(R_new)
        return (R_new, t_new, inlier), None

    def round_body(k, carry):
        R, t, inlier = carry
        (R, t, inlier), _ = jax.lax.scan(gn_iter, (R, t, inlier), None,
                                         length=iters_per_round)
        # re-classify (reference: e->chi2() > chi2th -> level 1; else level 0)
        _, _, chi2, behind = _residuals_jacobians(R, t, obs, cam_model, cam_params, bf)
        inlier = ((chi2 <= chi2_th) & (~behind)).astype(R.dtype)
        return (R, t, inlier)

    inlier0 = jnp.ones(obs.valid.shape, dtype=R0.dtype)
    R, t, inlier = jax.lax.fori_loop(0, n_rounds, round_body, (R0, t0, inlier0))
    inlier_mask = (inlier > 0) & obs.valid
    return R, t, inlier_mask, jnp.sum(inlier_mask.astype(jnp.int32))

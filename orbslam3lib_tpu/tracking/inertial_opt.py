"""Visual-inertial per-frame optimization and IMU initialization solves.

Replacement for the reference's inertial g2o solves:
  * PoseInertialOptimizationLastKeyFrame / LastFrame
    (/root/reference app/src/main/cpp/src/Optimizer.cc:4531, 4918): optimize
    the current frame's 15-dof state [pose, velocity, gyro bias, accel bias]
    against reprojection edges + one EdgeInertial to the anchor state +
    bias random-walk edges (+ marginalization prior for LastFrame).
  * InertialOptimization x3 (Optimizer.cc:3068, 3255, 3420): the staged IMU
    initialization — estimate gravity direction, (mono) scale, and biases
    over a keyframe window with poses fixed.

Design: residuals are assembled as one flat vector r(x) over a parameter
vector x, Jacobians come from jax.jacfwd (closed forms add nothing at
these sizes — the solve is a 15x15 / ~(6+3K)-dim dense system), and damping /
iteration happens in a lax.scan. All fixed capacity + masks.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import cameras, lie
from ..utils.robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight
from . import imu as imu_mod
from .pose_opt import PoseObs


class InertialFrameState(NamedTuple):
    """One frame's inertial state: Tcw CAMERA pose + world velocity +
    biases. All inertial math converts through the T_bc extrinsic passed to
    the optimizers (ImuCamPose semantics, G2oTypes.h:74)."""
    R: jnp.ndarray    # (3,3) world->cam
    t: jnp.ndarray    # (3,)
    v: jnp.ndarray    # (3,) world velocity of the BODY frame
    bg: jnp.ndarray   # (3,)
    ba: jnp.ndarray   # (3,)


def _apply_delta(st: InertialFrameState, dx):
    dR, dt = lie.se3_exp(dx[:6])
    R2, t2 = lie.se3_compose(dR, dt, st.R, st.t)
    return InertialFrameState(
        R=lie.normalize_rotation(R2), t=t2, v=st.v + dx[6:9],
        bg=st.bg + dx[9:12], ba=st.ba + dx[12:15])





@partial(jax.jit, static_argnames=("cam_model", "n_iters"))
def pose_inertial_optimization(cur: InertialFrameState,
                               anchor: InertialFrameState,
                               pre: imu_mod.Preintegrated,
                               obs: PoseObs, cam_params,
                               cam_model: int = cameras.PINHOLE,
                               bf: float = 0.0, n_iters: int = 10,
                               lm_lambda: float = 1e-3,
                               R_bc=None, t_bc=None):
    """Optimize the current frame's 15-dof state; the anchor (last KF or last
    frame) is fixed (PoseInertialOptimizationLastKeyFrame semantics). R_bc /
    t_bc: IMU-from-camera extrinsic (identity when omitted).

    Returns (state, inlier_mask, n_inliers, H_marg) where H_marg is the
    15x15 Gauss-Newton Hessian at the solution — the seed of the
    ConstraintPoseImu chain consumed by
    pose_inertial_optimization_last_frame on subsequent frames.
    """
    if R_bc is None:
        R_bc = jnp.eye(3, dtype=jnp.float32)
    if t_bc is None:
        t_bc = jnp.zeros(3, jnp.float32)
    info9 = jnp.linalg.inv(pre.cov + 1e-8 * jnp.eye(9))
    # factorize information for whitened residuals (sqrt-info)
    L9 = jnp.linalg.cholesky(info9)
    chi2_th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)
    # bias random-walk information from the accumulated walk covariance
    # (EdgeGyroRW/EdgeAccRW with InfoG/InfoA = NgaWalk^-1, Optimizer.cc:4918)
    # floor the regularizer at the old fixed priors (1e4 gyro / 1e2 acc):
    # a preintegration built without walk densities (cov_bias == 0) must
    # keep a sane bias prior, not a ~1e10 weight that freezes the bias
    info_bg = jnp.linalg.inv(pre.cov_bias[:3, :3] + 1e-4 * jnp.eye(3))
    info_ba = jnp.linalg.inv(pre.cov_bias[3:, 3:] + 1e-2 * jnp.eye(3))
    Lbg = jnp.linalg.cholesky(info_bg)
    Lba = jnp.linalg.cholesky(info_ba)

    def residuals(dx, inlier):
        st = _apply_delta(cur, dx)
        # reprojection
        p_c = lie.se3_apply(st.R, st.t, obs.p_world)
        uv_hat = cameras.project(cam_model, cam_params, p_c)
        z = p_c[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        r2 = uv_hat - obs.uv
        r3 = jnp.where(obs.is_stereo, uv_hat[..., 0] - bf / z_safe - obs.u_right, 0.0)
        r_vis = jnp.concatenate([r2, r3[..., None]], axis=-1)  # (N,3)
        chi2 = jnp.sum(r_vis * r_vis, axis=-1) * obs.inv_sigma2
        w_h = huber_weight(chi2, delta)
        behind = z <= 0.05
        # IRLS: weights are constants w.r.t. the state (stop_gradient also
        # keeps jacfwd finite — d(sqrt w)/dx at w=0 would be inf)
        w = jax.lax.stop_gradient(
            obs.inv_sigma2 * w_h * inlier * obs.valid * (~behind))
        r_vis = r_vis * jnp.sqrt(w)[:, None]

        # inertial edge anchor -> current (body poses through T_bc)
        R1, p1 = imu_mod.body_from_cam(anchor.R, anchor.t, R_bc, t_bc)
        R2_, p2 = imu_mod.body_from_cam(st.R, st.t, R_bc, t_bc)
        r_imu = imu_mod.inertial_residual(R1, anchor.v, p1, R2_, st.v, p2,
                                          st.bg, st.ba, pre)
        r_imu = L9.T @ r_imu

        # bias random walk vs anchor bias, whitened by the walk covariance
        r_bg = Lbg.T @ (st.bg - anchor.bg)
        r_ba = Lba.T @ (st.ba - anchor.ba)
        return jnp.concatenate([r_vis.reshape(-1), r_imu, r_bg, r_ba]), chi2, behind

    def iteration(carry, _):
        dx, inlier = carry
        r, chi2, behind = residuals(dx, inlier)
        J = jax.jacfwd(lambda d: residuals(d, inlier)[0])(dx)  # (M,15)
        H = J.T @ J
        g = J.T @ r
        H = H + lm_lambda * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(15)
        step = -jnp.linalg.solve(H, g)
        dx2 = dx + step
        # re-classify outliers on the updated state
        _, chi2n, behindn = residuals(dx2, inlier)
        inlier = ((chi2n <= chi2_th) & (~behindn)).astype(dx.dtype)
        return (dx2, inlier), None

    dx0 = jnp.zeros(15, jnp.float32)
    inl0 = jnp.ones(obs.valid.shape, jnp.float32)
    (dx, inlier), _ = jax.lax.scan(iteration, (dx0, inl0), None, length=n_iters)
    st = _apply_delta(cur, dx)
    inlier_mask = (inlier > 0) & obs.valid
    # marginal information of the solved state (the next frame's
    # ConstraintPoseImu): Gauss-Newton H = J^T J at the solution
    J_fin = jax.jacfwd(lambda d: residuals(d, inlier)[0])(dx)
    H_marg = J_fin.T @ J_fin
    return st, inlier_mask, jnp.sum(inlier_mask.astype(jnp.int32)), H_marg


@partial(jax.jit, static_argnames=("cam_model", "n_iters"))
def pose_inertial_optimization_last_frame(
        cur: InertialFrameState, last: InertialFrameState,
        prior_H, pre: imu_mod.Preintegrated, obs: PoseObs, cam_params,
        cam_model: int = cameras.PINHOLE, bf: float = 0.0,
        n_iters: int = 10, lm_lambda: float = 1e-3,
        R_bc=None, t_bc=None):
    """PoseInertialOptimizationLastFrame (Optimizer.cc:4918): a TWO-vertex
    solve over [last frame state, current frame state] (30 dof). The last
    frame is anchored by the ConstraintPoseImu marginalization prior
    (G2oTypes.h:706 EdgePriorPoseImu: its own state mean `last` weighted by
    the 15x15 information `prior_H` recovered from the previous solve); the
    current frame carries the visual edges; an inertial edge + bias
    random-walk edges connect the two. On return the last-frame block is
    marginalized out by Schur complement — the returned H_marg is the next
    frame's prior, so information propagates down the frame chain instead
    of being forgotten at every step.

    Returns (cur_state, inlier_mask, n_inliers, H_marg(15,15)).
    """
    if R_bc is None:
        R_bc = jnp.eye(3, dtype=jnp.float32)
    if t_bc is None:
        t_bc = jnp.zeros(3, jnp.float32)
    info9 = jnp.linalg.inv(pre.cov + 1e-8 * jnp.eye(9))
    L9 = jnp.linalg.cholesky(info9)
    chi2_th = jnp.where(obs.is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.where(obs.is_stereo, DELTA_STEREO, DELTA_MONO)
    info_bg = jnp.linalg.inv(pre.cov_bias[:3, :3] + 1e-4 * jnp.eye(3))
    info_ba = jnp.linalg.inv(pre.cov_bias[3:, 3:] + 1e-2 * jnp.eye(3))
    Lbg = jnp.linalg.cholesky(info_bg)
    Lba = jnp.linalg.cholesky(info_ba)
    Hp = 0.5 * (prior_H + prior_H.T)
    L_prior = jnp.linalg.cholesky(Hp + 1e-4 * jnp.eye(15))

    def residuals(dx, inlier):
        st_l = _apply_delta(last, dx[:15])
        st_c = _apply_delta(cur, dx[15:])
        # visual edges on the current frame
        p_c = lie.se3_apply(st_c.R, st_c.t, obs.p_world)
        uv_hat = cameras.project(cam_model, cam_params, p_c)
        z = p_c[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        r2 = uv_hat - obs.uv
        r3 = jnp.where(obs.is_stereo, uv_hat[..., 0] - bf / z_safe - obs.u_right, 0.0)
        r_vis = jnp.concatenate([r2, r3[..., None]], axis=-1)
        chi2 = jnp.sum(r_vis * r_vis, axis=-1) * obs.inv_sigma2
        w_h = huber_weight(chi2, delta)
        behind = z <= 0.05
        w = jax.lax.stop_gradient(
            obs.inv_sigma2 * w_h * inlier * obs.valid * (~behind))
        r_vis = r_vis * jnp.sqrt(w)[:, None]
        # inertial edge last -> current
        R1, p1 = imu_mod.body_from_cam(st_l.R, st_l.t, R_bc, t_bc)
        R2_, p2 = imu_mod.body_from_cam(st_c.R, st_c.t, R_bc, t_bc)
        r_imu = L9.T @ imu_mod.inertial_residual(
            R1, st_l.v, p1, R2_, st_c.v, p2, st_l.bg, st_l.ba, pre)
        # bias random walk between the frames
        r_bg = Lbg.T @ (st_c.bg - st_l.bg)
        r_ba = Lba.T @ (st_c.ba - st_l.ba)
        # marginalization prior on the LAST frame (its mean is `last`, i.e.
        # the dx[:15] chart origin — residual is the whitened delta itself)
        r_prior = L_prior.T @ dx[:15]
        return (jnp.concatenate([r_vis.reshape(-1), r_imu, r_bg, r_ba,
                                 r_prior]), chi2, behind)

    def iteration(carry, _):
        dx, inlier = carry
        r, chi2, behind = residuals(dx, inlier)
        J = jax.jacfwd(lambda d: residuals(d, inlier)[0])(dx)   # (M,30)
        H = J.T @ J
        g = J.T @ r
        H = H + lm_lambda * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(30)
        dx2 = dx - jnp.linalg.solve(H, g)
        _, chi2n, behindn = residuals(dx2, inlier)
        inlier = ((chi2n <= chi2_th) & (~behindn)).astype(dx.dtype)
        return (dx2, inlier), None

    dx0 = jnp.zeros(30, jnp.float32)
    inl0 = jnp.ones(obs.valid.shape, jnp.float32)
    (dx, inlier), _ = jax.lax.scan(iteration, (dx0, inl0), None,
                                   length=n_iters)
    st_c = _apply_delta(cur, dx[15:])
    inlier_mask = (inlier > 0) & obs.valid
    # Schur-marginalize the last-frame block: H_cur = Hcc - Hcl Hll^-1 Hlc
    J_fin = jax.jacfwd(lambda d: residuals(d, inlier)[0])(dx)
    H = J_fin.T @ J_fin
    Hll = H[:15, :15] + 1e-6 * jnp.eye(15)
    Hcc = H[15:, 15:]
    Hcl = H[15:, :15]
    H_marg = Hcc - Hcl @ jnp.linalg.solve(Hll, Hcl.T)
    return st_c, inlier_mask, jnp.sum(inlier_mask.astype(jnp.int32)), H_marg


@partial(jax.jit, static_argnames=("n_iters", "opt_scale"))
def inertial_init_optimization(kf_R, kf_t, kf_valid, pres: imu_mod.Preintegrated,
                               pre_valid, n_iters: int = 60,
                               opt_scale: bool = False,
                               prior_g: float = 1e2, prior_a: float = 1e6,
                               R_bc=None, t_bc=None):
    """Gravity-direction + bias (+ scale) estimation over a KF window with
    poses fixed — InertialOptimization (Optimizer.cc:3068) used by
    LocalMapping::InitializeIMU.

    kf_R/kf_t: (K,3,3),(K,3) Tcw poses. pres: per-gap preintegrations stacked
    along axis 0 (K-1 gaps), pre_valid (K-1,). Velocities are estimated in
    closed form per iteration from consecutive positions; parameters are
    x = [rg(2): gravity rotation, bg(3), ba(3), s(1 if opt_scale)].

    Returns (R_wg gravity rotation, bg, ba, scale, velocities (K,3)).
    """
    K = kf_R.shape[0]
    G = 9.81
    g_ref = jnp.asarray([0.0, G, 0.0], jnp.float32)  # +y down
    if R_bc is None:
        R_bc = jnp.eye(3, dtype=jnp.float32)
    if t_bc is None:
        t_bc = jnp.zeros(3, jnp.float32)

    Rwc = jnp.swapaxes(kf_R, -1, -2)
    c_w = -jnp.einsum("kij,kj->ki", Rwc, kf_t)        # camera centers
    Rwb = jnp.einsum("kij,lj->kil", Rwc, R_bc)        # R_wc @ R_bc^T
    lever = -jnp.einsum("kij,j->ki", Rwb, t_bc)       # metric, UNscaled
    dts = pres.dt                                      # (K-1,)

    # whitening per gap (reference EdgeInertialGS weights by the preintegration
    # information); without it the bias priors dominate the tiny residuals
    info9 = jnp.linalg.inv(pres.cov + 1e-10 * jnp.eye(9))
    L9 = jnp.linalg.cholesky(info9)                  # (K-1, 9, 9)

    def unpack(x):
        # 2-dof gravity rotation about the axes orthogonal to g_ref (+y):
        # x and z (a y-rotation would be a null direction)
        rg = jnp.stack([x[0], jnp.float32(0.0), x[1]])
        R_wg = lie.so3_exp(rg)
        bg = x[2:5]
        ba = x[5:8]
        s = jnp.exp(x[8]) if opt_scale else jnp.float32(1.0)
        return R_wg, bg, ba, s

    def velocities(bg, ba, s, g_w):
        """Closed-form per-gap velocity from the position preintegration:
        p2 = p1 + v1 dt + 0.5 g dt^2 + R1 dP  =>  v1. Body positions are
        s * camera_center + lever (the T_bc lever arm is metric and does
        not scale with the mono map)."""
        dR, dV, dP = jax.vmap(lambda pr: imu_mod.corrected_deltas(pr, bg, ba))(pres)
        p = s * c_w + lever
        p1, p2 = p[:-1], p[1:]
        dt = jnp.maximum(dts, 1e-4)[:, None]
        v1 = (p2 - p1 - 0.5 * g_w * (dt ** 2) -
              jnp.einsum("kij,kj->ki", Rwb[:-1], dP)) / dt
        v_last = v1[-1] + g_w * dt[-1, 0] + Rwb[-2] @ dV[-1]
        return jnp.concatenate([v1, v_last[None]], axis=0)

    def residual(x):
        R_wg, bg, ba, s = unpack(x)
        g_w = R_wg @ g_ref
        v = velocities(bg, ba, s, g_w)
        p = s * c_w + lever
        def gap_res(i):
            r = imu_mod.inertial_residual(
                Rwb[i], v[i], p[i], Rwb[i + 1], v[i + 1], p[i + 1],
                bg, ba, jax.tree_util.tree_map(lambda a: a[i], pres),
                g_w=g_w)
            return (L9[i].T @ r) * pre_valid[i]
        r_gaps = jax.vmap(gap_res)(jnp.arange(K - 1)).reshape(-1)
        r_prior = jnp.concatenate([bg * jnp.sqrt(prior_g), ba * jnp.sqrt(prior_a)])
        return jnp.concatenate([r_gaps, r_prior])

    n_par = 9 if opt_scale else 8
    def it(x, _):
        r = residual(jnp.pad(x, (0, 9 - n_par)) if n_par < 9 else x)
        J = jax.jacfwd(lambda y: residual(jnp.pad(y, (0, 9 - n_par)) if n_par < 9 else y))(x)
        H = J.T @ J + 1e-6 * jnp.eye(n_par)
        x2 = x - jnp.linalg.solve(H, J.T @ r)
        return x2, None

    x0 = jnp.zeros(n_par, jnp.float32)
    x, _ = jax.lax.scan(it, x0, None, length=n_iters)
    xfull = jnp.pad(x, (0, 9 - n_par)) if n_par < 9 else x
    R_wg, bg, ba, s = unpack(xfull)
    v = velocities(bg, ba, s, R_wg @ g_ref)
    return R_wg, bg, ba, s, v

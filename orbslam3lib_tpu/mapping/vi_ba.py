"""Sliding-window visual-inertial bundle adjustment (LocalInertialBA).

Re-design of the reference's LocalInertialBA
(/root/reference app/src/main/cpp/src/Optimizer.cc:2405: temporal window of
10 (or 25 when bLarge) keyframes with VertexPose/VertexVelocity/Vertex*Bias
per KF, EdgeMono/EdgeStereo reprojection, EdgeInertial between consecutive
KFs, EdgeGyroRW/EdgeAccRW bias random walks, the KF before the window fixed).

Design decisions (documented deviations):
  * The pass alternates with the visual Schur BA (mapping/map_ba.py): the
    visual pass refines poses + landmarks, this pass jointly refines pose +
    velocity per window keyframe and a window-shared bias against the IMU
    preintegration chain with landmarks held fixed. Alternation keeps each
    solve dense-small (9C+6 parameters <= ~100) instead of porting g2o's
    15-dof-block Schur machinery; at window sizes of 10-25 the reference's
    per-KF bias vertices are tied by strong RW edges anyway, which the shared
    window bias approximates.
  * Velocities initialize in closed form from consecutive keyframe positions
    and the position preintegration (same construction as the IMU-init solve,
    tracking/inertial_opt.py).
  * Everything is one jitted lax.scan of Gauss-Newton steps with jacfwd
    Jacobians, whitened inertial residuals (sqrt-information), Huber IRLS on
    reprojection (stop-gradient weights).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import map_state as ms
from ..tracking import imu as imu_mod
from ..utils import cameras, lie
from ..utils.robust import DELTA_MONO, DELTA_STEREO, huber_weight
from .map_ba import inv_sigma2


class VIWindowResult(NamedTuple):
    kf_R: jnp.ndarray   # (C,3,3) updated window poses
    kf_t: jnp.ndarray   # (C,3)
    v: jnp.ndarray      # (C,3) world velocities
    bg: jnp.ndarray     # (3,) window gyro bias — or (C,3) per-KF bias
    ba: jnp.ndarray     # (3,) window accel bias — or (C,3)

    @property
    def last_bias(self):
        """(bg, ba) of the newest keyframe regardless of bias mode."""
        if self.bg.ndim == 1:
            return self.bg, self.ba
        return self.bg[-1], self.ba[-1]


def _closed_form_velocities(Rwb, p, pres, bg, ba, g_w):
    """v1 per gap from p2 = p1 + v1 dt + 0.5 g dt^2 + R1 dP."""
    dR, dV, dP = jax.vmap(
        lambda pr: imu_mod.corrected_deltas(pr, bg, ba))(pres)
    dt = jnp.maximum(pres.dt, 1e-4)[:, None]
    v1 = (p[1:] - p[:-1] - 0.5 * g_w * (dt ** 2) -
          jnp.einsum("kij,kj->ki", Rwb[:-1], dP)) / dt
    v_last = v1[-1] + g_w * dt[-1, 0] + Rwb[-2] @ dV[-1]
    return jnp.concatenate([v1, v_last[None]], axis=0)


@partial(jax.jit, static_argnames=("bf", "cam_model", "n_iters", "n_levels",
                                   "per_kf_bias"))
def local_inertial_ba(m: ms.MapState, window_ids, fixed_mask,
                      pres: imu_mod.Preintegrated, pre_valid,
                      bg0, ba0, cam_params, bf: float,
                      cam_model: int = cameras.PINHOLE,
                      n_iters: int = 8, n_levels: int = 8,
                      R_bc=None, t_bc=None,
                      v_init=None, v_init_valid=None,
                      per_kf_bias: bool = False) -> VIWindowResult:
    """Windowed VI-BA over keyframes `window_ids` (C,), landmarks fixed.

    pres: stacked preintegrations for the C-1 consecutive gaps; pre_valid
    (C-1,) masks gaps without IMU data. fixed_mask (C,) holds anchor
    keyframes (and empty slots) constant. R_bc/t_bc: IMU-from-camera
    extrinsic (identity when omitted). v_init/v_init_valid: per-KF stored
    velocities (MapState.kf_v — the reference KeyFrames carry velocity,
    KeyFrame.h:206) seeding the solve; slots without one fall back to the
    closed-form construction.

    per_kf_bias=True switches to the reference's exact vertex structure
    (Optimizer.cc:2405: VertexGyroBias/VertexAccBias PER keyframe, tied by
    EdgeGyroRW/EdgeAccRW whitened with the per-gap walk covariance) — a
    15C-parameter dense solve instead of 9C+6. The shared-window bias is
    the fast default; tests/test_viba_staging.py quantifies the gap under
    a time-varying bias (the one regime where sharing loses).
    """
    if R_bc is None:
        R_bc = jnp.eye(3, dtype=jnp.float32)
    if t_bc is None:
        t_bc = jnp.zeros(3, jnp.float32)
    C = window_ids.shape[0]
    F = m.n_feat
    ids = jnp.clip(window_ids, 0, m.max_kf - 1)
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]

    # --- visual observations: each window KF vs its own (fixed) landmarks
    kf_mp = jnp.clip(m.kf_mp[ids], 0, m.max_mp - 1)                # (C,F)
    obs_ok = (cam_ok[:, None] & m.kf_feat_valid[ids] &
              (m.kf_mp[ids] >= 0) & m.mp_valid[kf_mp])             # (C,F)
    p_w = m.mp_pos[kf_mp]                                          # (C,F,3)
    uv = m.kf_xy[ids]                                              # (C,F,2)
    w_sig = inv_sigma2(m.kf_level[ids], n_levels)                  # (C,F)
    depth = m.kf_depth[ids]
    is_stereo = obs_ok & (depth > 0.05)
    z_safe = jnp.maximum(depth, 0.05)
    u_right = jnp.where(is_stereo, uv[..., 0] - bf / z_safe, 0.0)
    delta = jnp.where(is_stereo, DELTA_STEREO, DELTA_MONO)

    R0 = m.kf_R[ids]
    t0 = m.kf_t[ids]
    Rwb0, p0 = jax.vmap(
        lambda R, t: imu_mod.body_from_cam(R, t, R_bc, t_bc))(R0, t0)
    g_w = jnp.asarray([0.0, imu_mod.GRAVITY, 0.0], jnp.float32)
    v_cf = _closed_form_velocities(Rwb0, p0, pres, bg0, ba0, g_w)
    if v_init is None:
        v0 = v_cf
    else:
        use = (v_init_valid & cam_ok)[:, None]
        v0 = jnp.where(use, v_init, v_cf)

    # inertial whitening (sqrt-information per gap)
    info9 = jnp.linalg.inv(pres.cov + 1e-8 * jnp.eye(9))
    L9 = jnp.linalg.cholesky(info9)                                # (C-1,9,9)
    gap_ok = (pre_valid & cam_ok[:-1] & cam_ok[1:]).astype(jnp.float32)
    # fixed anchors hold their POSE; velocities stay free for every valid KF
    # (the closed-form velocity init is only as good as the neighbor poses —
    # freezing it would push the error into the accel bias)
    free_pose = (cam_ok & (~fixed_mask)).astype(jnp.float32)      # (C,)
    free_vel = cam_ok.astype(jnp.float32)

    n_par = 15 * C if per_kf_bias else 9 * C + 6
    if per_kf_bias:
        # per-gap bias-walk whitening (EdgeGyroRW/EdgeAccRW information =
        # the inverse accumulated walk covariance of the gap)
        info_bg = jnp.linalg.inv(pres.cov_bias[:, :3, :3] + 1e-4 * jnp.eye(3))
        info_ba = jnp.linalg.inv(pres.cov_bias[:, 3:, 3:] + 1e-2 * jnp.eye(3))
        Lbg_rw = jnp.linalg.cholesky(info_bg)                      # (C-1,3,3)
        Lba_rw = jnp.linalg.cholesky(info_ba)

    def unpack(x):
        if per_kf_bias:
            dkf = x.reshape(C, 15)
            dpose = dkf[:, :6] * free_pose[:, None]
            dvel = dkf[:, 6:9] * free_vel[:, None]
            bg = bg0 + dkf[:, 9:12] * free_vel[:, None]            # (C,3)
            ba = ba0 + dkf[:, 12:15] * free_vel[:, None]
        else:
            dkf9 = x[:9 * C].reshape(C, 9)
            dpose = dkf9[:, :6] * free_pose[:, None]
            dvel = dkf9[:, 6:9] * free_vel[:, None]
            bg = bg0 + x[9 * C:9 * C + 3]                          # (3,)
            ba = ba0 + x[9 * C + 3:]
        dR, dt = jax.vmap(lambda d: lie.se3_exp(d))(dpose)
        R, t = jax.vmap(lie.se3_compose)(dR, dt, R0, t0)
        R = jax.vmap(lie.normalize_rotation)(R)
        v = v0 + dvel
        return R, t, v, bg, ba

    def residuals(x):
        R, t, v, bg, ba = unpack(x)
        # reprojection (C,F,3)
        p_c = jax.vmap(lie.se3_apply)(R, t, p_w)
        uv_hat = cameras.project(cam_model, cam_params, p_c)
        z = p_c[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        r2 = uv_hat - uv
        r3 = jnp.where(is_stereo, uv_hat[..., 0] - bf / zs - u_right, 0.0)
        r_vis = jnp.concatenate([r2, r3[..., None]], axis=-1)
        chi2 = jnp.sum(r_vis * r_vis, axis=-1) * w_sig
        w_h = huber_weight(chi2, delta)
        behind = z <= 0.05
        w = jax.lax.stop_gradient(
            w_sig * w_h * obs_ok.astype(jnp.float32) *
            (1.0 - behind.astype(jnp.float32)))
        r_vis = (r_vis * jnp.sqrt(w)[..., None]).reshape(-1)

        # inertial chain (body poses through T_bc)
        Rwb, p = jax.vmap(
            lambda Ri_, ti_: imu_mod.body_from_cam(Ri_, ti_, R_bc, t_bc))(R, t)

        def gap_res(i):
            bg_i = bg[i] if per_kf_bias else bg
            ba_i = ba[i] if per_kf_bias else ba
            r = imu_mod.inertial_residual(
                Rwb[i], v[i], p[i], Rwb[i + 1], v[i + 1], p[i + 1],
                bg_i, ba_i, jax.tree_util.tree_map(lambda a: a[i], pres))
            return (L9[i].T @ r) * gap_ok[i]
        r_imu = jax.vmap(gap_res)(jnp.arange(C - 1)).reshape(-1)

        if per_kf_bias:
            # EdgeGyroRW/EdgeAccRW between consecutive window biases,
            # whitened by the gap's walk covariance; prior ties the first
            # bias to the incoming estimate
            def rw_res(i):
                return jnp.concatenate([
                    Lbg_rw[i].T @ (bg[i + 1] - bg[i]),
                    Lba_rw[i].T @ (ba[i + 1] - ba[i])]) * gap_ok[i]
            r_rw = jax.vmap(rw_res)(jnp.arange(C - 1)).reshape(-1)
            r_bias = jnp.concatenate([
                (bg[0] - bg0) * jnp.sqrt(1e2),
                (ba[0] - ba0) * jnp.sqrt(1e1), r_rw])
        else:
            # window-bias prior (the RW edges of the reference tie biases to
            # the incoming estimate; shared-bias equivalent: delta prior)
            r_bias = jnp.concatenate([(bg - bg0) * jnp.sqrt(1e2),
                                      (ba - ba0) * jnp.sqrt(1e1)])
        return jnp.concatenate([r_vis, r_imu, r_bias])

    def it(x, _):
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = J.T @ J + 1e-5 * jnp.eye(n_par)
        x2 = x - jnp.linalg.solve(H, J.T @ r)
        return x2, None

    x, _ = jax.lax.scan(it, jnp.zeros(n_par, jnp.float32), None,
                        length=n_iters)
    R, t, v, bg, ba = unpack(x)
    return VIWindowResult(kf_R=R, kf_t=t, v=v, bg=bg, ba=ba)


def apply_vi_window(m: ms.MapState, window_ids, fixed_mask,
                    res: VIWindowResult) -> ms.MapState:
    """Scatter optimized window poses back into the map (valid, non-fixed)
    and record per-KF inertial state (velocity + window bias) — the
    reference KeyFrames carry velocity/bias (KeyFrame.h:206-216)."""
    ids = jnp.clip(window_ids, 0, m.max_kf - 1)
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]
    upd = cam_ok & (~fixed_mask)
    bgs = jnp.broadcast_to(res.bg, res.v.shape)
    bas = jnp.broadcast_to(res.ba, res.v.shape)
    return m._replace(
        kf_R=m.kf_R.at[ids].set(
            jnp.where(upd[:, None, None], res.kf_R, m.kf_R[ids])),
        kf_t=m.kf_t.at[ids].set(
            jnp.where(upd[:, None], res.kf_t, m.kf_t[ids])),
        kf_v=m.kf_v.at[ids].set(
            jnp.where(cam_ok[:, None], res.v, m.kf_v[ids])),
        kf_bg=m.kf_bg.at[ids].set(
            jnp.where(cam_ok[:, None], bgs, m.kf_bg[ids])),
        kf_ba=m.kf_ba.at[ids].set(
            jnp.where(cam_ok[:, None], bas, m.kf_ba[ids])),
    )

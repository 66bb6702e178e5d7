"""IMU preintegration on the SO(3) manifold + inertial state prediction.

Re-design of the reference's ImuTypes
(/root/reference app/src/main/cpp/src/ImuTypes.{h,cc}: Preintegrated with
15x15 covariance, bias Jacobians JRg/JVg/JVa/JPg/JPa — ImuTypes.h:159-168,
IntegrateNewMeasurement:126; SO3 right-Jacobians :193-199) following the
Forster et al. on-manifold preintegration. Differences from the reference:

  * a whole measurement batch integrates in ONE lax.scan (the reference
    integrates sample-by-sample on the CPU between frames);
  * everything is a pure NamedTuple pytree — re-preintegration after a bias
    update (Reintegrate, ImuTypes.cc) is just calling integrate again.

State conventions: R_wb (world-from-body), v_w, p_w; gravity vector g_w
points down (+y in our world frame, see io/synthetic.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import lie

GRAVITY = 9.81


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurements between two frames/keyframes.

    cov + cov_bias together are the reference's 15x15 covariance over
    [phi, v, p, bg, ba] (ImuTypes.h:159-168): in ImuTypes.cc the cross
    blocks between the 9-dim preintegration state and the biases stay zero
    (A's bias rows are identity, B's bias columns zero; only
    C.block<6,6>(9,9) += NgaWalk accumulates), so the faithful layout is
    this block-diagonal pair."""
    dt: jnp.ndarray    # () total time
    dR: jnp.ndarray    # (3,3)
    dV: jnp.ndarray    # (3,)
    dP: jnp.ndarray    # (3,)
    cov: jnp.ndarray   # (9,9) covariance of [phi, v, p]
    cov_bias: jnp.ndarray  # (6,6) accumulated bias random-walk covariance
    JRg: jnp.ndarray   # (3,3) d dR / d bias_gyro
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    bg: jnp.ndarray    # (3,) gyro bias linearization point
    ba: jnp.ndarray    # (3,) accel bias linearization point


def empty_preintegrated(bg=None, ba=None) -> Preintegrated:
    z3 = jnp.zeros(3, jnp.float32)
    I = jnp.eye(3, dtype=jnp.float32)
    Z = jnp.zeros((3, 3), jnp.float32)
    return Preintegrated(
        dt=jnp.zeros((), jnp.float32), dR=I, dV=z3, dP=z3,
        cov=jnp.zeros((9, 9), jnp.float32),
        cov_bias=jnp.zeros((6, 6), jnp.float32),
        JRg=Z, JVg=Z, JVa=Z, JPg=Z, JPa=Z,
        bg=z3 if bg is None else bg, ba=z3 if ba is None else ba)


@partial(jax.jit, static_argnames=())
def integrate(pre: Preintegrated, gyro: jnp.ndarray, acc: jnp.ndarray,
              dts: jnp.ndarray, valid: jnp.ndarray,
              sigma_g: jnp.ndarray, sigma_a: jnp.ndarray,
              walk_g: jnp.ndarray = 0.0,
              walk_a: jnp.ndarray = 0.0) -> Preintegrated:
    """Integrate a (N,3) batch of gyro/accel samples with per-sample dt.

    `valid` (N,) masks padding samples (fixed-capacity batches). sigma_g/a
    are continuous-time noise densities * sqrt(freq) (discrete sigmas);
    walk_g/walk_a are the continuous-time bias random-walk densities
    (NgaWalk, ImuTypes.cc) accumulated into cov_bias as walk^2 * dt.
    Semantics of Preintegrated::IntegrateNewMeasurement (ImuTypes.cc):
    position/velocity first with the pre-update dR, then the rotation.
    """
    Ng = jnp.eye(3) * (sigma_g * sigma_g)
    Na = jnp.eye(3) * (sigma_a * sigma_a)
    Wg = jnp.eye(3) * (walk_g * walk_g)
    Wa = jnp.eye(3) * (walk_a * walk_a)

    def step(c, x):
        g, a, dt, ok = x
        dt = jnp.where(ok, dt, 0.0)
        w = g - c.bg
        ah = a - c.ba
        dt2 = dt * dt

        acc_w = c.dR @ ah                         # accel rotated into frame-i
        dP = c.dP + c.dV * dt + 0.5 * acc_w * dt2
        dV = c.dV + acc_w * dt

        # covariance propagation (Forster eq. A.7-A.9); state [phi, v, p]
        A = jnp.eye(9, dtype=jnp.float32)
        W = lie.hat(ah)
        dRi = lie.so3_exp(w * dt)
        Jr = lie.so3_right_jacobian(w * dt)
        A = A.at[0:3, 0:3].set(dRi.T)
        A = A.at[3:6, 0:3].set(-c.dR @ W * dt)
        A = A.at[6:9, 0:3].set(-0.5 * c.dR @ W * dt2)
        A = A.at[6:9, 3:6].set(jnp.eye(3) * dt)
        B = jnp.zeros((9, 6), jnp.float32)
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(c.dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * c.dR * dt2)
        N = jnp.zeros((6, 6), jnp.float32)
        N = N.at[0:3, 0:3].set(Ng / jnp.maximum(dt, 1e-6))
        N = N.at[3:6, 3:6].set(Na / jnp.maximum(dt, 1e-6))
        cov = A @ c.cov @ A.T + B @ N @ B.T
        cov = jnp.where(ok, cov, c.cov)
        cov_bias = c.cov_bias + jax.scipy.linalg.block_diag(Wg, Wa) * dt

        # bias Jacobians (update position/velocity before rotation)
        JPa = c.JPa + c.JVa * dt - 0.5 * c.dR * dt2
        JPg = c.JPg + c.JVg * dt - 0.5 * (c.dR @ W) @ c.JRg * dt2
        JVa = c.JVa - c.dR * dt
        JVg = c.JVg - (c.dR @ W) @ c.JRg * dt
        JRg = dRi.T @ c.JRg - Jr * dt

        dR = lie.normalize_rotation(c.dR @ dRi)
        new = c._replace(dt=c.dt + dt, dR=dR, dV=dV, dP=dP, cov=cov,
                         cov_bias=cov_bias,
                         JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa)
        return new, None

    out, _ = jax.lax.scan(step, pre, (gyro, acc, dts, valid))
    return out


def corrected_deltas(pre: Preintegrated, bg_new, ba_new):
    """First-order bias-corrected deltas (GetDeltaRotation/Velocity/Position
    in ImuTypes.cc): applies the stored bias Jacobians."""
    dbg = bg_new - pre.bg
    dba = ba_new - pre.ba
    dR = pre.dR @ lie.so3_exp(pre.JRg @ dbg)
    dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    return dR, dV, dP


def predict_state(R_wb, v_w, p_w, pre: Preintegrated, bg, ba,
                  g_w=None):
    """IMU dead-reckoning prediction (Tracking::PredictStateIMU,
    Tracking.cc:1791): propagate (R, v, p) through the preintegrated deltas."""
    if g_w is None:
        g_w = jnp.asarray([0.0, GRAVITY, 0.0], jnp.float32)  # +y down
    dR, dV, dP = corrected_deltas(pre, bg, ba)
    dt = pre.dt
    R2 = lie.normalize_rotation(R_wb @ dR)
    v2 = v_w + g_w * dt + R_wb @ dV
    p2 = p_w + v_w * dt + 0.5 * g_w * dt * dt + R_wb @ dP
    return R2, v2, p2


def body_from_cam(Rcw, tcw, R_bc, t_bc):
    """Tcw camera pose -> (R_wb, p_wb) body pose through T_bc (p_b = R_bc p_c
    + t_bc; the reference's ImuCamPose, G2oTypes.h:74 / EuRoC IMU.T_b_c1)."""
    Rwc, c_w = lie.se3_inverse(Rcw, tcw)
    R_wb = Rwc @ R_bc.T
    p_wb = c_w - R_wb @ t_bc
    return R_wb, p_wb


def cam_from_body(R_wb, p_wb, R_bc, t_bc):
    """(R_wb, p_wb) body pose -> Tcw camera pose through T_bc."""
    R_wc = R_wb @ R_bc
    c_w = p_wb + R_wb @ t_bc
    Rcw = jnp.swapaxes(R_wc, -1, -2)
    return Rcw, -(Rcw @ c_w)


def inertial_residual(R1, v1, p1, R2, v2, p2, bg, ba, pre: Preintegrated,
                      g_w=None):
    """9-dim preintegration residual [er, ev, ep] (reference EdgeInertial,
    G2oTypes.h:495, Forster eq. 45)."""
    if g_w is None:
        g_w = jnp.asarray([0.0, GRAVITY, 0.0], jnp.float32)
    dR, dV, dP = corrected_deltas(pre, bg, ba)
    dt = pre.dt
    er = lie.so3_log(dR.T @ R1.T @ R2)
    ev = R1.T @ (v2 - v1 - g_w * dt) - dV
    ep = R1.T @ (p2 - p1 - v1 * dt - 0.5 * g_w * dt * dt) - dP
    return jnp.concatenate([er, ev, ep])

"""Lie-group substrate: SO(3), SE(3), Sim(3) as pure jnp functions.

Replacement for the reference's Sophus dependency (see
/root/reference app/src/main/cpp: Sophus is used throughout Tracking/Optimizer,
e.g. G2oTypes.h:74 ImuCamPose). Everything here is functional, batched over
arbitrary leading dimensions, and safe under jit/vmap/grad.

Representation conventions:
  * rotations: 3x3 matrices (..., 3, 3)
  * SE(3): tuple (R, t) with R (..., 3, 3), t (..., 3)  -- or a packed (...,3,4)
  * tangent vectors: so3 (...,3); se3 (...,6) ordered [rho, phi]
    (translation first, rotation second -- matches the common g2o ordering).
  * Sim(3): (R, t, s) with scalar s (...,)

All small-angle branches are handled with Taylor expansions selected by
jnp.where on a safe denominator (no data-dependent control flow).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sin_cos_coeffs(theta2: jnp.ndarray):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with
    Taylor fallbacks for small angles. theta2 is the squared angle."""
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    return A, B, C


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (...,3) -> (...,3,3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    A, B, _ = _sin_cos_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Matrix log of a rotation: (...,3,3) -> (...,3).

    Quaternion route for robustness near pi; written with the "safe where"
    pattern so jax.jacfwd/jacrev stay NaN-free at the identity (both branches
    of every where must be finite AND have finite derivatives).
    """
    q = rotmat_to_quat(R)  # (w, x, y, z), w >= 0
    qw = q[..., 0]
    qv = q[..., 1:]
    nv2 = jnp.sum(qv * qv, axis=-1)
    small = nv2 < 1e-12
    nv2_safe = jnp.where(small, 1.0, nv2)       # keeps sqrt grad finite
    nv = jnp.sqrt(nv2_safe)
    qw_safe = jnp.maximum(qw, _EPS)
    scale_big = 2.0 * jnp.arctan2(nv, qw) / nv
    # series in nv2 (differentiable at 0): 2/qw * (1 - nv2/(3 qw^2))
    scale_small = 2.0 / qw_safe - 2.0 * nv2 / (3.0 * qw_safe ** 3)
    scale = jnp.where(small, scale_small, scale_big)
    return scale[..., None] * qv


def so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian Jl of SO(3): (...,3) -> (...,3,3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    _, B, C = _sin_cos_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + B[..., None, None] * W + C[..., None, None] * W2


def so3_right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian Jr(w) = Jl(-w). Reference semantics: ImuTypes.h:193-199."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian, with Taylor fallback."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    # coefficient of W2: 1/theta2 - (1 + cos)/(2 theta sin)
    s, c = jnp.sin(theta), jnp.cos(theta)
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / theta2 - (1.0 + c) / (2.0 * theta * s + _EPS),
    )
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + 0.5 * W + coef[..., None, None] * W2


def rotmat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z), w >= 0.

    Branch-free Shepperd-style: compute all four candidate constructions and
    select the best-conditioned one with where-masks (jit friendly)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates scaled by 4*q_k^2 (k = w, x, y, z)
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cands = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    k = jnp.argmax(cands, axis=-1)
    sq = jnp.sqrt(jnp.maximum(jnp.max(cands, axis=-1), _EPS)) * 2.0  # 4 q_k

    q_w = jnp.stack([0.25 * sq, (m21 - m12) / sq, (m02 - m20) / sq, (m10 - m01) / sq], axis=-1)
    q_x = jnp.stack([(m21 - m12) / sq, 0.25 * sq, (m01 + m10) / sq, (m02 + m20) / sq], axis=-1)
    q_y = jnp.stack([(m02 - m20) / sq, (m01 + m10) / sq, 0.25 * sq, (m12 + m21) / sq], axis=-1)
    q_z = jnp.stack([(m10 - m01) / sq, (m02 + m20) / sq, (m12 + m21) / sq, 0.25 * sq], axis=-1)
    q = jnp.select(
        [k[..., None] == 0, k[..., None] == 1, k[..., None] == 2],
        [q_w, q_x, q_y],
        q_z,
    )
    # Canonical sign: w >= 0
    q = q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1)
    r1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1)
    r2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([r0, r1, r2], axis=-2)


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation matrix back onto SO(3) (via quaternion)."""
    return quat_to_rotmat(rotmat_to_quat(R))


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_exp(xi: jnp.ndarray):
    """se(3) exp. xi = [rho, phi] (...,6) -> (R (...,3,3), t (...,3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log -> (...,6) [rho, phi]."""
    phi = so3_log(R)
    Vinv = _left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def _left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    return so3_right_jacobian_inv(-w)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb)."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, p):
    """Apply transform to points p (...,3)."""
    return jnp.einsum("...ij,...j->...i", R, p) + t


def se3_matrix(R, t):
    """Pack into a (...,4,4) homogeneous matrix."""
    bot = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), R.shape[:-2] + (1, 4)
    )
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# ---------------------------------------------------------------------------
# Sim(3) — needed for loop closing (reference: Sim3Solver, OptimizeSim3)
# ---------------------------------------------------------------------------

def _sim3_W(phi: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """The Sim(3) 'W' matrix: t = W rho in sim3_exp. (...,3)x(...,) -> (...,3,3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    s = jnp.exp(sigma)
    W = hat(phi)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)

    small_s = jnp.abs(sigma) < 1e-4
    small_t = theta < 1e-4
    sig = jnp.where(small_s, jnp.ones_like(sigma), sigma)   # safe denominator
    th = jnp.where(small_t, jnp.ones_like(theta), theta)

    cI = jnp.where(small_s, jnp.ones_like(s), (s - 1.0) / sig)

    sin_t, cos_t = jnp.sin(th), jnp.cos(th)
    c = th * th + sig * sig
    a_g = s * sin_t
    b_g = s * cos_t
    cW_gen = (a_g * sig + (1.0 - b_g) * th) / (th * c)
    cW2_gen = (cI - ((b_g - 1.0) * sig + a_g * th) / c) / (th * th)

    cW_st = ((sig - 1.0) * s + 1.0) / (sig * sig)            # theta -> 0
    cW2_st = (s * (0.5 * sig * sig - sig + 1.0) - 1.0) / (sig ** 3)

    cW_ss = (1.0 - cos_t) / (th * th)                        # sigma -> 0
    cW2_ss = (th - sin_t) / (th ** 3)

    half = jnp.full_like(sigma, 0.5)
    sixth = jnp.full_like(sigma, 1.0 / 6.0)
    cW = jnp.where(small_s, jnp.where(small_t, half, cW_ss),
                   jnp.where(small_t, cW_st, cW_gen))
    cW2 = jnp.where(small_s, jnp.where(small_t, sixth, cW2_ss),
                    jnp.where(small_t, cW2_st, cW2_gen))

    return cI[..., None, None] * I + cW[..., None, None] * W + cW2[..., None, None] * W2


def sim3_exp(xi: jnp.ndarray):
    """sim(3) exp. xi = [rho, phi, sigma] (...,7) -> (R, t, s).

    t = W rho with W = \\int_0^1 e^{sigma u} exp(u hat(phi)) du (closed forms
    per small-angle/small-scale regime in _sim3_W, jit/vmap-safe).
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    s = jnp.exp(sigma)
    Wmat = _sim3_W(phi, sigma)
    t = jnp.einsum("...ij,...j->...i", Wmat, rho)
    return R, t, s


def sim3_log(R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Sim(3) log -> (...,7) [rho, phi, sigma]. Inverse of sim3_exp."""
    phi = so3_log(R)
    sigma = jnp.log(s)
    Wmat = _sim3_W(phi, sigma)
    rho = jnp.linalg.solve(Wmat, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_apply(R, t, s, p):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, p) + t


def sim3_inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return (
        Ra @ Rb,
        sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta,
        sa * sb,
    )

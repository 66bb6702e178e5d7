"""Camera models: Pinhole and Kannala-Brandt8 (fisheye), pure jnp.

Re-design of the reference's GeometricCamera hierarchy
(/root/reference app/src/main/cpp/include/CameraModels/GeometricCamera.h:42-72,
Pinhole.cpp, KannalaBrandt8.cpp). Instead of virtual dispatch over camera
objects, each model is a set of batched pure functions parameterised by a
flat parameter vector, so that a whole frame's keypoints project in one
vectorised call and Jacobians come from the closed forms below (all
jit/vmap/grad-safe).

Parameter layouts (float32 vectors):
  Pinhole:        [fx, fy, cx, cy]
  KannalaBrandt8: [fx, fy, cx, cy, k0, k1, k2, k3]
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

PINHOLE = 0
KANNALA_BRANDT = 1
PINHOLE_RADTAN = 2

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Pinhole
# ---------------------------------------------------------------------------

def pinhole_project(params: jnp.ndarray, p3d: jnp.ndarray) -> jnp.ndarray:
    """(...,3) camera-frame points -> (...,2) pixels."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = p3d[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    u = fx * p3d[..., 0] * inv_z + cx
    v = fy * p3d[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def pinhole_unproject(params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """(...,2) pixels -> (...,3) unit-depth rays (z=1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def pinhole_project_jac(params: jnp.ndarray, p3d: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(p3d): (...,2,3). Reference: Pinhole::projectJac."""
    fx, fy = params[0], params[1]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    inv_z2 = inv_z * inv_z
    zeros = jnp.zeros_like(x)
    row0 = jnp.stack([fx * inv_z, zeros, -fx * x * inv_z2], axis=-1)
    row1 = jnp.stack([zeros, fy * inv_z, -fy * y * inv_z2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Pinhole + radial-tangential distortion (reference: the pinhole +
# Camera.k1/k2/p1/p2[/k3] path — Settings.cc:485 reads distCoeffs and
# Frame.cc:156 UndistortKeyPoints corrects measurements through
# cv::undistortPoints. Here the distorted model is first-class: projection
# applies the distortion closed-form and unprojection inverts it by Newton
# iterations, so mono/RGB-D pipelines consume RAW distorted images with no
# undistortion pass at all — every matcher/optimizer already routes through
# project()/unproject()/project_jac(). Only rectified-stereo needs image
# remap (utils/rectify.py).
#
# Parameter layout: [fx, fy, cx, cy, k1, k2, p1, p2, k3]
# ---------------------------------------------------------------------------

def _radtan_distort(k: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Apply radial-tangential distortion to normalized coords."""
    k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def radtan_project(params: jnp.ndarray, p3d: jnp.ndarray) -> jnp.ndarray:
    """(...,3) camera-frame points -> (...,2) distorted pixels."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = p3d[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    x = p3d[..., 0] * inv_z
    y = p3d[..., 1] * inv_z
    xd, yd = _radtan_distort(params[4:9], x, y)
    return jnp.stack([fx * xd + cx, fy * yd + cy], axis=-1)


def radtan_unproject(params: jnp.ndarray, uv: jnp.ndarray,
                     n_iter: int = 8) -> jnp.ndarray:
    """Distorted pixels -> z=1 rays, fixed-point undistortion (the
    cv::undistortPoints iteration: x = (xd - dx(x)) / radial(x))."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:9]
    k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy

    def body(_, xy):
        x, y = xy
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / jnp.where(jnp.abs(radial) < _EPS, _EPS, radial)
        return ((xd - dx) * inv, (yd - dy) * inv)

    x, y = jax.lax.fori_loop(0, n_iter, body, (xd, yd))
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def radtan_project_jac(params: jnp.ndarray, p3d: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(p3d): (...,2,3), closed form through the distortion."""
    fx, fy = params[0], params[1]
    k = params[4:9]
    k1, k2, p1, p2, k3 = k[0], k[1], k[2], k[3], k[4]
    X, Y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    x = X * inv_z
    y = Y * inv_z
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dradial = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)   # d(radial)/d(r2)
    # d(xd)/d(x), d(xd)/d(y), d(yd)/d(x), d(yd)/d(y)
    dxd_dx = radial + x * dradial * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
    dxd_dy = x * dradial * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dx = y * dradial * 2.0 * x + 2.0 * p1 * x + 2.0 * p2 * y
    dyd_dy = radial + y * dradial * 2.0 * y + 6.0 * p1 * y + 2.0 * p2 * x
    # chain with d(x,y)/d(X,Y,z)
    inv_z2 = inv_z * inv_z
    # dx/dX = 1/z, dx/dz = -X/z^2; dy/dY = 1/z, dy/dz = -Y/z^2
    du_dX = fx * dxd_dx * inv_z
    du_dY = fx * dxd_dy * inv_z
    du_dz = fx * (dxd_dx * (-X * inv_z2) + dxd_dy * (-Y * inv_z2))
    dv_dX = fy * dyd_dx * inv_z
    dv_dY = fy * dyd_dy * inv_z
    dv_dz = fy * (dyd_dx * (-X * inv_z2) + dyd_dy * (-Y * inv_z2))
    row0 = jnp.stack([du_dX, du_dY, du_dz], axis=-1)
    row1 = jnp.stack([dv_dX, dv_dY, dv_dz], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (fisheye; reference KannalaBrandt8.cpp)
# ---------------------------------------------------------------------------

def kb8_project(params: jnp.ndarray, p3d: jnp.ndarray) -> jnp.ndarray:
    """Equidistant fisheye projection with theta polynomial d(theta) =
    theta + k0 theta^3 + k1 theta^5 + k2 theta^7 + k3 theta^9."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.maximum(r2, _EPS * _EPS))
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    scale = d / r
    # Degenerate: point on optical axis -> r ~ 0 -> projects to principal point
    scale = jnp.where(r2 < _EPS, jnp.zeros_like(scale), scale)
    u = fx * x * scale + cx
    v = fy * y * scale + cy
    return jnp.stack([u, v], axis=-1)


def kb8_unproject(params: jnp.ndarray, uv: jnp.ndarray, n_iter: int = 10) -> jnp.ndarray:
    """Invert d(theta) by Newton iterations (reference uses 10 iterations in
    KannalaBrandt8::unproject). Returns unit-depth rays (z=1 convention to
    match GeometricCamera::unprojectEig usage)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = jnp.sqrt(mx * mx + my * my)  # = d(theta)
    theta = d  # init

    def body(_, th):
        t2 = th * th
        f = th * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))) - d
        fp = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))
        return th - f / jnp.where(jnp.abs(fp) < _EPS, _EPS, fp)

    theta = jax.lax.fori_loop(0, n_iter, body, theta)
    scale = jnp.tan(theta) / jnp.where(d < _EPS, _EPS, d)
    scale = jnp.where(d < _EPS, jnp.ones_like(scale), scale)
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def kb8_project_jac(params: jnp.ndarray, p3d: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(p3d) for KB8: (...,2,3), closed form (reference
    KannalaBrandt8::projectJac)."""
    fx, fy = params[0], params[1]
    k = params[4:8]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.maximum(r2, _EPS * _EPS))
    r3 = r2 * r
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    dp = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))
    l2 = r2 + z * z
    dtheta_dx = x * z / (l2 * r)
    dtheta_dy = y * z / (l2 * r)
    dtheta_dz = -r / l2

    dd_dx = dp * dtheta_dx
    dd_dy = dp * dtheta_dy
    dd_dz = dp * dtheta_dz

    # u = fx * x * d / r
    du_dx = fx * (dd_dx * x / r + d * (1.0 / r - x * x / r3))
    du_dy = fx * (dd_dy * x / r - d * x * y / r3)
    du_dz = fx * dd_dz * x / r
    dv_dx = fy * (dd_dx * y / r - d * x * y / r3)
    dv_dy = fy * (dd_dy * y / r + d * (1.0 / r - y * y / r3))
    dv_dz = fy * dd_dz * y / r
    row0 = jnp.stack([du_dx, du_dy, du_dz], axis=-1)
    row1 = jnp.stack([dv_dx, dv_dy, dv_dz], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Generic dispatch (static model id — resolved at trace time)
# ---------------------------------------------------------------------------

def project(model: int, params, p3d):
    if model == PINHOLE:
        return pinhole_project(params, p3d)
    if model == PINHOLE_RADTAN:
        return radtan_project(params, p3d)
    return kb8_project(params, p3d)


def unproject(model: int, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    if model == PINHOLE_RADTAN:
        return radtan_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model: int, params, p3d):
    if model == PINHOLE:
        return pinhole_project_jac(params, p3d)
    if model == PINHOLE_RADTAN:
        return radtan_project_jac(params, p3d)
    return kb8_project_jac(params, p3d)


# ---------------------------------------------------------------------------
# Triangulation (reference: GeometricTools::Triangulate DLT, GeometricTools.cc:47;
# KannalaBrandt8::TriangulateMatches, KannalaBrandt8.cpp used by the fisheye
# stereo matcher Frame.cc:1142-1251)
# ---------------------------------------------------------------------------

def triangulate_dlt(ray1: jnp.ndarray, ray2: jnp.ndarray, T1: jnp.ndarray, T2: jnp.ndarray) -> jnp.ndarray:
    """DLT triangulation from two normalized rays and two 3x4 world->cam
    projection matrices. Batched over leading dims. Returns world points.

    Solves A x = 0 with A the standard cross-product rows, taking the
    eigenvector of A^T A for the smallest eigenvalue — same estimator as
    the reference's SVD DLT (GeometricTools::Triangulate), but computed
    with the closed-form adjugate kernel (utils/smallmat.py): batched 4x4
    SVD lowers to an iterative routine that costs ~21 ms on (4096,4,4)
    on-device vs ~1 ms for the arithmetic path.
    """
    from .smallmat import smallest_eigvec4_psd
    x1, y1 = ray1[..., 0] / ray1[..., 2], ray1[..., 1] / ray1[..., 2]
    x2, y2 = ray2[..., 0] / ray2[..., 2], ray2[..., 1] / ray2[..., 2]
    A0 = x1[..., None] * T1[..., 2, :] - T1[..., 0, :]
    A1 = y1[..., None] * T1[..., 2, :] - T1[..., 1, :]
    A2 = x2[..., None] * T2[..., 2, :] - T2[..., 0, :]
    A3 = y2[..., None] * T2[..., 2, :] - T2[..., 1, :]
    A = jnp.stack([A0, A1, A2, A3], axis=-2)  # (...,4,4)
    M = jnp.einsum("...ki,...kj->...ij", A, A)
    X = smallest_eigvec4_psd(M)
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < _EPS, _EPS, w)
    return X[..., :3] / w[..., None]


def triangulate_two_view(ray1, ray2, R12, t12):
    """Triangulate in camera-1 frame given relative pose cam1<-cam2.

    ray1/ray2: (...,3) bearing vectors in each camera. R12,t12: pose of cam2
    in cam1 (x_1 = R12 x_2 + t12). Returns (p3d_c1, parallax_cos, z1, z2).
    Mirrors the acceptance logic of KannalaBrandt8::TriangulateMatches.
    """
    r1 = ray1 / jnp.linalg.norm(ray1, axis=-1, keepdims=True)
    r2w = jnp.einsum("...ij,...j->...i", R12, ray2)
    r2w = r2w / jnp.linalg.norm(r2w, axis=-1, keepdims=True)
    cos_parallax = jnp.sum(r1 * r2w, axis=-1)

    # closed-form MIDPOINT triangulation: depths (s, t) along the two unit
    # rays from the 2x2 Gram system, point = midpoint of the closest
    # approach. Chosen over DLT deliberately: the mapper triangulates
    # small-parallax pairs (neighbor keyframes cm apart, points meters
    # away), where an A^T A eigen-solve conditions as sin^4(theta) and
    # drowns in f32 — the Gram solve conditions as sin^2(theta) and a
    # batched 4x4 SVD costs ~21 ms on-device (see utils/smallmat.py).
    # Accuracy vs the f64 SVD oracle is asserted in
    # tests/test_smallmat.py::test_triangulate_small_parallax.
    b = t12
    r1b = jnp.sum(r1 * b, axis=-1)
    r2b = jnp.sum(r2w * b, axis=-1)
    # denominator 1 - cos^2 = sin^2(theta), computed as |r1 x r2|^2: the
    # direct form cancels catastrophically for near-parallel rays (c -> 1),
    # costing a factor 1/sin(theta) of precision exactly where the mapper
    # operates; the cross product is built from differences of O(sin)
    # products and keeps relative error at O(eps/sin)
    cr = jnp.cross(r1, r2w)
    den = jnp.maximum(jnp.sum(cr * cr, axis=-1), 1e-12)
    s = (r1b - cos_parallax * r2b) / den
    t = (cos_parallax * r1b - r2b) / den
    p3d = 0.5 * (s[..., None] * r1 + t[..., None] * r2w + b)
    z1 = p3d[..., 2]
    R21 = jnp.swapaxes(R12, -1, -2)
    t21 = -jnp.einsum("...ij,...j->...i", R21, t12)
    p3d_c2 = jnp.einsum("...ij,...j->...i", R21, p3d) + t21
    z2 = p3d_c2[..., 2]
    return p3d, cos_parallax, z1, z2

"""Stereo rectification: host-side map precompute + on-device remap.

Re-design of the reference's rectification path
(/root/reference app/src/main/cpp/src/Settings.cc:177 `needToRectify` ->
Settings.cc:485 precomputeRectificationMaps: cv::stereoRectify +
cv::initUndistortRectifyMap, applied per frame with cv::remap in
Tracking/System). The map construction (Bouguet's algorithm) runs ONCE on
the host in NumPy; the per-frame work is a single jitted bilinear gather
that lives inside the frame pipeline, so raw distorted stereo pairs are
rectified on device with no extra host round trip.

After rectification both cameras are ideal pinholes sharing one intrinsic
matrix, rows are epipolar-aligned and the baseline is pure +x — exactly the
contract of matching.match_rectified_stereo.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import cameras


class RectifyResult(NamedTuple):
    """Host-side rectification precompute."""
    maps: np.ndarray       # (2, H, W, 2) sample coords (x, y) per eye
    new_params: np.ndarray  # [fx, fy, cx, cy] shared rectified intrinsics
    baseline: float        # rectified baseline (meters)
    R_rect: np.ndarray     # (2, 3, 3) rect<-cam rotations (left, right)


def _so3_log(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-9:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (th / (2.0 * np.sin(th)))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def stereo_rectify(params_l: np.ndarray, params_r: np.ndarray,
                   model_l: int, model_r: int,
                   R_lr: np.ndarray, t_lr: np.ndarray,
                   width: int, height: int) -> RectifyResult:
    """Bouguet stereo rectification (cv::stereoRectify semantics).

    params_l/r: distorted camera parameter vectors (PINHOLE_RADTAN
    [fx,fy,cx,cy,k1,k2,p1,p2,k3] or KANNALA_BRANDT [fx,fy,cx,cy,k0..k3]).
    R_lr/t_lr: pose of the right camera in the left frame (x_l = R x_r + t).
    Returns the per-eye sample maps and the shared rectified pinhole.
    """
    R_lr = np.asarray(R_lr, np.float64).reshape(3, 3)
    t_lr = np.asarray(t_lr, np.float64).reshape(3)
    # split the relative rotation evenly between the two eyes:
    # x_l_new = Ra x_l, x_r_new = Rb x_r with Rb R_rl Ra^T = I
    om = _so3_log(R_lr)
    Ra0 = _so3_exp(-0.5 * om)          # left half-rotation
    Rb0 = Ra0 @ R_lr                   # = exp(+om/2)
    # align the baseline with +x: t_rl in the new shared orientation
    t_rl = -R_lr.T @ t_lr              # position of left cam in right frame
    t_new = Rb0 @ t_rl
    b = np.linalg.norm(t_new)
    e1 = t_new / b
    if e1[0] < 0:                      # right camera must sit at +x of left
        e1 = -e1
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n2 < 1e-9 else e2 / n2
    e3 = np.cross(e1, e2)
    R_align = np.stack([e1, e2, e3], axis=0)
    Ra = R_align @ Ra0
    Rb = R_align @ Rb0

    # shared rectified intrinsics: mean focal, image-centered principal point
    f_new = 0.25 * float(params_l[0] + params_l[1] + params_r[0] + params_r[1])
    cx_new, cy_new = width * 0.5, height * 0.5
    new_params = np.asarray([f_new, f_new, cx_new, cy_new], np.float32)

    # sample maps: rectified pixel -> source (distorted) pixel
    u, v = np.meshgrid(np.arange(width, dtype=np.float32),
                       np.arange(height, dtype=np.float32))
    ray = np.stack([(u - cx_new) / f_new, (v - cy_new) / f_new,
                    np.ones_like(u)], axis=-1)          # (H, W, 3)
    maps = np.zeros((2, height, width, 2), np.float32)
    for eye, (Rr, prm, mdl) in enumerate(
            [(Ra, params_l, model_l), (Rb, params_r, model_r)]):
        x_cam = ray @ Rr.astype(np.float32)             # Rr^T applied rowwise
        uv_src = np.asarray(cameras.project(
            mdl, jnp.asarray(np.asarray(prm, np.float32)),
            jnp.asarray(x_cam.reshape(-1, 3))))
        maps[eye] = uv_src.reshape(height, width, 2)
    return RectifyResult(maps=maps, new_params=new_params,
                         baseline=float(b),
                         R_rect=np.stack([Ra, Rb]).astype(np.float32))


OOB = -1.0e4   # sentinel source coordinate: always lands outside -> 0


def twopass_maps(mp) -> np.ndarray:
    """Convert a direct 2-D remap map into Catmull-Smith two-pass maps.

    Direct map: out[yo,xo] = img(Y(yo,xo), X(yo,xo)). A naive separable
    remap (vertical then horizontal resample, each reading its map at the
    OUTPUT pixel) evaluates Y at column xo instead of the source column —
    for radtan distortion Y varies by tens of pixels along a row, which is
    a catastrophic warp error. The two-pass construction fixes the
    vertical map by inverting X along each row (host-side, once):
      pass V: imgv[yo, x] = img(Yv(yo, x), x)  with Yv(yo,x) = Y(yo, X^-1(yo, x))
      pass H: out[yo,xo]  = imgv(yo, X(yo,xo))
    so the composition samples img at exactly (Y(yo,xo), X(yo,xo)).
    Requires X monotonic along rows (true for rectification maps).

    Returns a map with the same (..., H, W, 2) layout: [..., 0] = X (the
    horizontal pass map), [..., 1] = Yv (the corrected vertical pass map);
    out-of-image samples are pushed to the OOB sentinel so the shift
    resampler zeroes them."""
    m = np.asarray(mp, np.float64)
    lead = m.shape[:-3]
    H, W = m.shape[-3], m.shape[-2]
    m2 = m.reshape((-1, H, W, 2)).copy()
    xs = np.arange(W, dtype=np.float64)
    for e in range(m2.shape[0]):
        X, Y = m2[e, ..., 0], m2[e, ..., 1]
        inb = (X >= 0) & (X <= W - 1) & (Y >= 0) & (Y <= H - 1)
        for yo in range(H):
            Xrow = X[yo]
            if not np.all(np.diff(Xrow) > 0):
                raise ValueError("twopass_maps requires X monotonic in x")
            # xo_inv(x): output column whose source x equals the integer x
            xo_inv = np.interp(xs, Xrow, xs)
            m2[e, yo, :, 1] = np.interp(xo_inv, xs, Y[yo])
        m2[e, ..., 0] = np.where(inb, X, OOB)
        m2[e, ..., 1] = np.where(
            (m2[e, ..., 1] >= 0) & (m2[e, ..., 1] <= H - 1),
            m2[e, ..., 1], OOB)
    return m2.reshape(lead + (H, W, 2)).astype(np.float32)


def remap_bounds(mp) -> tuple:
    """Static integer displacement bounds (dy_min, dy_max, dx_min, dx_max)
    of a (two-pass) remap map, computed host-side once at setup. Only
    in-image samples count — out-of-bounds pixels are weight-zero in the
    shift resampler, so they must not inflate the shift range."""
    m = np.asarray(mp)
    H, W = m.shape[-3], m.shape[-2]
    x, y = m[..., 0], m[..., 1]
    okx = (x >= 0) & (x <= W - 1)
    oky = (y >= 0) & (y <= H - 1)
    xi = np.clip(np.floor(x), 0, W - 2)
    yi = np.clip(np.floor(y), 0, H - 2)
    dy = np.where(oky, yi - np.arange(H)[:, None], 0)
    dx = np.where(okx, xi - np.arange(W)[None, :], 0)
    return int(dy.min()), int(dy.max()), int(dx.min()), int(dx.max())


@partial(jax.jit, static_argnames=("dy_min", "dy_max", "dx_min", "dx_max"))
def remap_bilinear_shifts(img: jnp.ndarray, mp: jnp.ndarray,
                          dy_min: int, dy_max: int,
                          dx_min: int, dx_max: int) -> jnp.ndarray:
    """Bilinear remap as two bounded shift-and-accumulate passes (vertical
    then horizontal) instead of 2-D gathers.

    The generic `img[yi, xi]` gather of remap_bilinear was slow on the
    backend this path was written for; whether it is as fast as this path
    on the GPU is not measured yet (ROADMAP queue 3). Rectification maps
    have BOUNDED smooth displacements, so each axis resample is expressible
    as sum_k w_k(y,x) * shift(img, k) over the static range from
    `remap_bounds` — pure vectorized multiply-adds.

    Two-pass resampling evaluates the y-map at the output column rather
    than the source column (separable approximation); for rectification
    maps (y-displacement varies by O(px) across the image) the difference
    vs exact bilinear is sub-grey-level — asserted against the exact
    oracle in tests/test_rectify.py."""
    H, W = img.shape[-2], img.shape[-1]
    mp = jnp.broadcast_to(mp, img.shape[:-2] + (H, W, 2))
    x = mp[..., 0]
    y = mp[..., 1]
    # per-pass validity BEFORE the index clip: clipped out-of-range (or
    # OOB-sentinel) coordinates would otherwise produce in-range integer
    # displacements and sample real pixels
    vy = ((y >= 0) & (y <= H - 1)).astype(img.dtype)
    vx = ((x >= 0) & (x <= W - 1)).astype(img.dtype)
    y0 = jnp.floor(y)
    fy = (y - y0).astype(img.dtype)
    yi = jnp.clip(y0.astype(jnp.int32), 0, H - 2)
    d_y = yi - jax.lax.broadcasted_iota(jnp.int32, yi.shape, yi.ndim - 2)
    acc = jnp.zeros_like(img)
    for k in range(dy_min, dy_max + 2):
        w = jnp.where(d_y == k, 1.0 - fy, 0.0) + \
            jnp.where(d_y == k - 1, fy, 0.0)
        acc = acc + (w * vy) * jnp.roll(img, -k, axis=-2)
    x0 = jnp.floor(x)
    fx = (x - x0).astype(img.dtype)
    xi = jnp.clip(x0.astype(jnp.int32), 0, W - 2)
    d_x = xi - jax.lax.broadcasted_iota(jnp.int32, xi.shape, xi.ndim - 1)
    out = jnp.zeros_like(img)
    for k in range(dx_min, dx_max + 2):
        w = jnp.where(d_x == k, 1.0 - fx, 0.0) + \
            jnp.where(d_x == k - 1, fx, 0.0)
        out = out + (w * vx) * jnp.roll(acc, -k, axis=-1)
    return out


@jax.jit
def remap_bilinear(img: jnp.ndarray, mp: jnp.ndarray) -> jnp.ndarray:
    """Bilinear remap: out[y, x] = img(mp[y, x, 1], mp[y, x, 0]).

    img (..., H, W) float; mp (..., H, W, 2) source (x, y) coords. Leading
    dims broadcast (e.g. (2, H, W) stereo pair with (2, H, W, 2) maps).
    Out-of-bounds samples are 0 (the reference's BORDER_CONSTANT)."""
    H, W = img.shape[-2], img.shape[-1]
    mp = jnp.broadcast_to(mp, img.shape[:-2] + (H, W, 2))
    x = mp[..., 0]
    y = mp[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    xi = jnp.clip(x0.astype(jnp.int32), 0, W - 2)
    yi = jnp.clip(y0.astype(jnp.int32), 0, H - 2)
    inb = ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
           ).astype(img.dtype)

    def sample(im, yy, xx):
        return im[yy, xx]

    for _ in range(img.ndim - 2):
        sample = jax.vmap(sample)
    p00 = sample(img, yi, xi)
    p01 = sample(img, yi, xi + 1)
    p10 = sample(img, yi + 1, xi)
    p11 = sample(img, yi + 1, xi + 1)
    top = p00 * (1.0 - fx) + p01 * fx
    bot = p10 * (1.0 - fx) + p11 * fx
    return (top * (1.0 - fy) + bot * fy) * inb

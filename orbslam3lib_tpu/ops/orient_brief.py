"""Keypoint orientation (intensity centroid) and rotated-BRIEF descriptors.

Re-design of the reference DSP kernels
(/root/reference dsp/src/orbslam_dsp_rb.cpp: ic_angle_simd:32 accumulates
m01/m10 moments over the 31x31 circular patch from the VTCM cache;
calculate_orb_descriptors_optimized16:547 rotates the 256-pair pattern by the
8-bit encoded cos/sin and gathers/compares). Mapping:

  * ONE per-keypoint patch gather (45x45 raw pixels) feeds everything;
    the patch gather is the only gather in the whole pipeline — all
    downstream sampling is dense matmul work;
  * orientation moments m10/m01 are a (N, 2025) @ (2025, 2) matmul against
    constant circular-mask weights (the reference's umax accumulation);
  * the 7x7 Gaussian pre-blur (ORBextractor_old.cc computeDescriptors)
    becomes two banded (39, 45) matmuls applied per patch — the full-image
    blur disappears entirely;
  * pattern rotation is quantized to N_ANGLE_BINS=64 discrete angles (the
    reference itself quantizes: its cos/sin pass through a 4-bit
    log-magnitude encoding + 10-bit LUT, orbslam_dsp_rb.cpp:89-213 — 64 bins
    give <= 0.65 px position error, the same order as the reference's
    integer rounding). For every bin a constant +-1 "compare matrix"
    D[a] (256, 39*39) holds +1 at each pattern point p1 and -1 at p2, so
    bit = (I(p1) < I(p2)) = (D[a] @ patch < 0): descriptor extraction for
    ALL bins is one dense (A*256, 1521) x (1521, N) matmul with exact f32
    accumulation, followed by one row-gather to select each keypoint's bin;
  * descriptors are a (N, 256) 0/1 int8 bit matrix — the layout that lets
    the Hamming matcher run as one matmul (ops/matcher.py).

Scalar NumPy oracles mirror the reference's *_scalar test pattern
(orbslam_dsp_rb.cpp:356; SURVEY.md §4).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from .pattern import BIT_PATTERN_31

HALF_PATCH = 15          # orientation patch radius (31x31)
BRIEF_RADIUS = 19        # rotated pattern radius <= 18.39 (max |p| in table)
BRIEF_PATCH = 2 * BRIEF_RADIUS + 1  # 39
BLUR_HALF = 3            # 7-tap Gaussian
RAW_RADIUS = BRIEF_RADIUS + BLUR_HALF   # 22 -> 45x45 raw patch
RAW_PATCH = 2 * RAW_RADIUS + 1
N_ANGLE_BINS = 64


@lru_cache(maxsize=None)
def _circular_mask_and_coords():
    """(mask, u, v) each (31, 31): the u_max-style circular patch of radius 15
    (reference umax table semantics, ORBextractor_old.cc IC_Angle)."""
    v = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    u = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    vv, uu = np.meshgrid(v, u, indexing="ij")
    umax = np.round(np.sqrt(HALF_PATCH * HALF_PATCH - v * v + 0.0)).astype(np.int32)
    mask = np.abs(uu) <= umax[:, None]
    return mask.astype(np.float32), uu.astype(np.float32), vv.astype(np.float32)


RAW_FLAT = RAW_PATCH * RAW_PATCH          # 2025
RAW_FLAT_PAD = (RAW_FLAT + 127) // 128 * 128  # 2048 — aligned contraction


@lru_cache(maxsize=None)
def _moment_weights_raw() -> np.ndarray:
    """(RAW_FLAT_PAD, 8) constant weights: one matmul computes (m10, m01)
    over the centered 31x31 circular sub-patch of the raw patch. Padded to
    aligned dims (2048 x 8) instead of the stray (2025, 2) shape."""
    mask, uu, vv = _circular_mask_and_coords()
    W = np.zeros((RAW_PATCH, RAW_PATCH, 2), np.float32)
    lo, hi = RAW_RADIUS - HALF_PATCH, RAW_RADIUS + HALF_PATCH + 1
    W[lo:hi, lo:hi, 0] = uu * mask
    W[lo:hi, lo:hi, 1] = vv * mask
    Wp = np.zeros((RAW_FLAT_PAD, 8), np.float32)
    Wp[:RAW_FLAT, :2] = W.reshape(-1, 2)
    return Wp


@lru_cache(maxsize=None)
def _blur_matrix() -> np.ndarray:
    """(BRIEF_PATCH, RAW_PATCH) banded 7-tap Gaussian (sigma=2), valid conv."""
    xs = np.arange(-BLUR_HALF, BLUR_HALF + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / 2.0) ** 2)
    k /= k.sum()
    B = np.zeros((BRIEF_PATCH, RAW_PATCH), np.float32)
    for i in range(BRIEF_PATCH):
        B[i, i:i + 7] = k
    return B


def bin_angles(angle: jnp.ndarray) -> jnp.ndarray:
    """Quantize angles (radians) to N_ANGLE_BINS discrete bins."""
    a = angle / (2.0 * np.pi / N_ANGLE_BINS)
    return jnp.mod(jnp.round(a).astype(jnp.int32), N_ANGLE_BINS)


@lru_cache(maxsize=None)
def _compare_matrices() -> np.ndarray:
    """(A, 256, BRIEF_PATCH**2) +-1 compare matrices: for bin a, row p has +1
    at the rotated nearest-integer position of pattern point 1 and -1 at
    point 2 (cancels exactly when they collide, like I(p)<I(p) = 0)."""
    pat = BIT_PATTERN_31.astype(np.float64)     # (256, 4) x1 y1 x2 y2
    A = N_ANGLE_BINS
    D = np.zeros((A, 256, BRIEF_PATCH * BRIEF_PATCH), np.float32)
    for a in range(A):
        th = 2.0 * np.pi * a / A
        ca, sa = np.cos(th), np.sin(th)
        for sgn, (cx, cy) in ((1.0, (0, 1)), (-1.0, (2, 3))):
            rx = np.round(pat[:, cx] * ca - pat[:, cy] * sa).astype(np.int64)
            ry = np.round(pat[:, cx] * sa + pat[:, cy] * ca).astype(np.int64)
            idx = (ry + BRIEF_RADIUS) * BRIEF_PATCH + (rx + BRIEF_RADIUS)
            D[a, np.arange(256), idx] += sgn
    return D


BRIEF_FLAT = BRIEF_PATCH * BRIEF_PATCH            # 1521
BRIEF_FLAT_PAD = (BRIEF_FLAT + 127) // 128 * 128  # 1536 — aligned


@lru_cache(maxsize=None)
def _compare_matrices_dev():
    """Concrete bf16 copy of the (unblurred) compare tensor, padded to an
    aligned contraction dim (see _moment_weights_raw); for the compat
    pre-blurred-canvas brief_descriptors path."""
    D = _compare_matrices().reshape(N_ANGLE_BINS * 256, -1)
    Dp = np.zeros((N_ANGLE_BINS * 256, BRIEF_FLAT_PAD), np.float32)
    Dp[:, :BRIEF_FLAT] = D
    with jax.ensure_compile_time_eval():
        return jnp.asarray(Dp, jnp.bfloat16)


@lru_cache(maxsize=None)
def _compare_blur_matrices() -> np.ndarray:
    """(A*256, RAW_FLAT_PAD) fused blur+compare matrices.

    The 7-tap Gaussian pre-blur is linear, so it folds into the compare
    tensor: with blurred = B P B^T (B the banded (39,45) blur),
    v[b] = <D[b], blurred> = <B^T D[b] B, P>. One matmul then does
    blur + BRIEF sampling + compare for all 64 angle bins at once, and the
    standalone (39,45)/(2025,2)-shaped matmuls disappear entirely."""
    D = _compare_matrices().astype(np.float64)          # (A, 256, 39*39)
    B = _blur_matrix().astype(np.float64)               # (39, 45)
    A = N_ANGLE_BINS
    Dm = D.reshape(A * 256, BRIEF_PATCH, BRIEF_PATCH)   # [b, i(y), l(x)]
    # D'[b, j, k] = sum_{il} D[b,i,l] B[i,j] B[l,k]
    Dp = np.einsum("bil,ij,lk->bjk", Dm, B, B)
    out = np.zeros((A * 256, RAW_FLAT_PAD), np.float32)
    out[:, :RAW_FLAT] = Dp.reshape(A * 256, -1)
    return out


@lru_cache(maxsize=None)
def _compare_blur_matrices_dev():
    """Concrete bf16 copy of the fused compare tensor, built eagerly even
    when first touched inside a trace (a traced device_put here would cache
    a tracer and poison later traces)."""
    with jax.ensure_compile_time_eval():
        return jnp.asarray(_compare_blur_matrices(), jnp.bfloat16)


def _gather_patches(canvas: jnp.ndarray, level: jnp.ndarray, y: jnp.ndarray,
                    x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """canvas (L, H, W) f32; level/y/x (N,) int32 (level-local integer
    coords). Returns (N, 2r+1, 2r+1) patches via the row-gather + one-hot
    column matmul of ops/patches.py (slice-style formulations serialize on
    this backend). Callers must enforce a detection margin >= radius+1."""
    from .patches import gather_patches
    size = 2 * radius + 1
    return gather_patches(canvas, level, y, x, size, size,
                          y_off=-radius, x_off=-radius)


def ic_angles(canvas: jnp.ndarray, level: jnp.ndarray, y: jnp.ndarray,
              x: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation per keypoint -> angle in radians.

    Reference: ic_angle_simd (orbslam_dsp_rb.cpp:32) / IC_Angle
    (ORBextractor_old.cc:78): m10 = sum u*I, m01 = sum v*I over the circular
    31x31 patch; angle = atan2(m01, m10).
    """
    mask, uu, vv = _circular_mask_and_coords()
    patches = _gather_patches(canvas, level, y, x, HALF_PATCH)  # (N,31,31)
    W = jnp.asarray(np.stack([(uu * mask).reshape(-1),
                              (vv * mask).reshape(-1)], axis=-1))
    m = patches.reshape(patches.shape[0], -1) @ W               # (N, 2)
    return jnp.arctan2(m[:, 1], m[:, 0])


def _bits_from_compare(D: jnp.ndarray, flat_padded: jnp.ndarray,
                       angle: jnp.ndarray) -> jnp.ndarray:
    """Shared compare-matmul + bin-select: D (A*256, Fpad) bf16 compare
    tensor, flat_padded (N, Fpad) patches -> (N, 256) int8 bits."""
    A = N_ANGLE_BINS
    p = flat_padded.astype(jnp.bfloat16)
    v = jax.lax.dot_general(
        D, p, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT)          # (A*256, N)
    v = v.reshape(A, 256, -1)
    bins = bin_angles(angle)                          # (N,)
    # bin selection as a one-hot weighted reduce (elementwise, where a
    # take_along_axis would be 256*N scalar gathers). Arithmetic one-hot +
    # sign-based bit, in the pred-free style of ops/masks.py
    diff = jnp.abs(jnp.arange(A, dtype=jnp.int32)[:, None]
                   - bins[None, :]).astype(v.dtype)              # (A, N)
    oh = jnp.clip(1.0 - diff, 0.0, 1.0)
    vn = jnp.sum(v * oh[:, None, :], axis=0)                     # (256, N)
    # bit = (v < 0): -sign(v) clipped to {0,1}; v == 0 -> 0 like I(p)<I(p)
    return jnp.clip(-jnp.sign(vn.T), 0.0, 1.0).astype(jnp.int8)


def _brief_from_raw(raw_flat_padded: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """raw_flat_padded (N, RAW_FLAT_PAD) unblurred patches -> (N, 256) int8
    bits via the fused blur+compare matmul (one aligned dot for all 64
    angle bins; accumulation f32)."""
    return _bits_from_compare(_compare_blur_matrices_dev(), raw_flat_padded,
                              angle)


def orient_and_brief(canvas: jnp.ndarray, level: jnp.ndarray, y: jnp.ndarray,
                     x: jnp.ndarray):
    """Fused orientation + descriptor path: ONE 45x45 raw-patch gather, then
    moments / 7x7 blur / binned BRIEF as dense matmuls.

    Returns (angle (N,) f32, desc (N, 256) int8). Callers must guarantee a
    detection margin >= RAW_RADIUS + 1 within each level's extent.
    """
    patches = _gather_patches(canvas, level, y, x, RAW_RADIUS)  # (N,45,45)
    N = patches.shape[0]
    flat = jnp.pad(patches.reshape(N, -1),
                   ((0, 0), (0, RAW_FLAT_PAD - RAW_FLAT)))      # (N, 2048)
    m = flat @ jnp.asarray(_moment_weights_raw())               # (N, 8)
    angle = jnp.arctan2(m[:, 1], m[:, 0])
    desc = _brief_from_raw(flat, angle)
    return angle, desc


def brief_descriptors(blur_canvas: jnp.ndarray, level: jnp.ndarray,
                      y: jnp.ndarray, x: jnp.ndarray,
                      angle: jnp.ndarray) -> jnp.ndarray:
    """Rotated-BRIEF 256-bit descriptors -> (N, 256) int8 in {0, 1} from a
    pre-blurred canvas (compat API; the extractor uses orient_and_brief).

    Reference semantics (calculate_orb_descriptors*, orbslam_dsp_rb.cpp:283+
    and ORBextractor_old.cc computeOrbDescriptor): sample position for pattern
    point (px, py) at angle t is (round(px cos - py sin), round(px sin +
    py cos)); bit = I(p1) < I(p2); angle quantized to N_ANGLE_BINS (the
    reference quantizes via its cos/sin LUT encoding).
    """
    patches = _gather_patches(blur_canvas, level, y, x, BRIEF_RADIUS)
    N = patches.shape[0]
    flat = jnp.pad(patches.reshape(N, -1),
                   ((0, 0), (0, BRIEF_FLAT_PAD - BRIEF_FLAT)))
    return _bits_from_compare(_compare_matrices_dev(), flat, angle)


def pack_bits_u32(bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) 0/1 -> (N, 8) uint32 packed (bit i of word w = pair 32w+i)."""
    b = bits.astype(jnp.uint32).reshape(bits.shape[0], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1)


# ---------------------------------------------------------------------------
# NumPy oracles
# ---------------------------------------------------------------------------

def ic_angle_oracle(img: np.ndarray, y: int, x: int) -> float:
    mask, uu, vv = _circular_mask_and_coords()
    patch = img[y - HALF_PATCH: y + HALF_PATCH + 1,
                x - HALF_PATCH: x + HALF_PATCH + 1].astype(np.float32)
    m10 = float(np.sum(patch * uu * mask))
    m01 = float(np.sum(patch * vv * mask))
    return float(np.arctan2(m01, m10))


def brief_oracle(blur_img: np.ndarray, y: int, x: int, angle: float) -> np.ndarray:
    """Scalar oracle with the same quantized-angle nearest sampling."""
    a = int(np.round(angle / (2.0 * np.pi / N_ANGLE_BINS))) % N_ANGLE_BINS
    th = 2.0 * np.pi * a / N_ANGLE_BINS
    ca, sa = np.cos(th), np.sin(th)
    out = np.zeros(256, dtype=np.int8)
    for i, (px, py, qx, qy) in enumerate(BIT_PATTERN_31.astype(np.float64)):
        r1x, r1y = int(round(px * ca - py * sa)), int(round(px * sa + py * ca))
        r2x, r2y = int(round(qx * ca - qy * sa)), int(round(qx * sa + qy * ca))
        out[i] = np.int8(blur_img[y + r1y, x + r1x] < blur_img[y + r2y, x + r2x])
    return out

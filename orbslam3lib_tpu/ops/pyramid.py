"""Image pyramid: bilinear multi-level resize, batched over the eye dimension.

Re-design of the reference's HVX pyramid
(/root/reference dsp/src/orbslam_dsp_pyramid.{h,cpp}: 8 levels, 640x400 ->
128x80, per-level bilinear reduction with precomputed gather indices and
coefficient vectors, orbslam_dsp_pyramid.cpp:448). Geometry contract
(orbslam_dsp_pyramid.h:37-66): level widths {640,512,384,314,256,203,161,128},
i.e. scale chain 5/4, 4/3, ... ending at 128x80.

Design notes:
  * Each level has a static shape -> XLA compiles one fused resize per level;
    the whole pyramid is a single jitted call.
  * The separable bilinear resize is expressed as two small dense matmuls
    (H_out x H_in) @ img @ (W_in x W_out) with precomputed sparse-as-dense
    interpolation matrices (tiny, <= 640x512 f32, constant-folded) instead
    of a gather.
  * Batched over leading dims (eye=2) via einsum.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

# Reference pyramid geometry (orbslam_dsp_pyramid.h:37-66). Heights follow the
# same ratios as widths (aspect 8:5 input 640x400).
REF_WIDTHS = (640, 512, 384, 314, 256, 203, 161, 128)
REF_HEIGHTS = (400, 320, 240, 196, 160, 127, 101, 80)
N_LEVELS = 8


def level_shapes(h0: int = 400, w0: int = 640, n_levels: int = N_LEVELS) -> List[Tuple[int, int]]:
    """Per-level (H, W). For the production 640x400 input this reproduces the
    reference table exactly; otherwise scales by the same ratio chain."""
    if (h0, w0) == (400, 640) and n_levels == N_LEVELS:
        return list(zip(REF_HEIGHTS, REF_WIDTHS))
    shapes = [(h0, w0)]
    for lvl in range(1, n_levels):
        r = REF_WIDTHS[min(lvl, N_LEVELS - 1)] / REF_WIDTHS[0]
        shapes.append((max(8, int(round(h0 * r))), max(8, int(round(w0 * r)))))
    return shapes


def scale_factors(n_levels: int = N_LEVELS) -> np.ndarray:
    """Per-level absolute scale (level-0 pixels per level-L pixel)."""
    return np.asarray([REF_WIDTHS[0] / REF_WIDTHS[min(l, N_LEVELS - 1)] for l in range(n_levels)],
                      dtype=np.float32)


@lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bilinear interpolation matrix, align-corners=False
    (pixel-center convention, matching the reference's precomputed
    index/coefficient scheme in precompute_horizontal_bilinear_indices_and_coefs)."""
    M = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        frac = src - i0
        i0c = min(max(i0, 0), n_in - 1)
        i1c = min(max(i0 + 1, 0), n_in - 1)
        M[o, i0c] += 1.0 - frac
        M[o, i1c] += frac
    return M


def _resize_bilinear(img: jnp.ndarray, h_out: int, w_out: int) -> jnp.ndarray:
    """Separable bilinear resize of (..., H, W) float32 via two matmuls."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    Mh = jnp.asarray(_resize_matrix(h_in, h_out))   # (h_out, h_in)
    Mw = jnp.asarray(_resize_matrix(w_in, w_out)).T  # (w_in, w_out)
    # HIGHEST (full f32): HIGH is TF32 on the GPU (10 mantissa bits), a
    # tenth of a grey level on 0..255 pixels, which moves FAST scores across
    # the detection threshold; the matrices are tiny, so full f32 is cheap
    tmp = jnp.einsum("oh,...hw->...ow", Mh, img,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("...ow,wp->...op", tmp, Mw,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def build_pyramid(img: jnp.ndarray, n_levels: int = N_LEVELS) -> List[jnp.ndarray]:
    """img: (..., H, W) uint8 or float32. Returns list of float32 levels.

    Like the reference, each level L>0 is computed from level L-1 (chained
    reduction, orbslam_dsp.cpp:654-675), not from level 0 — this matches the
    slight low-pass accumulation of the chained bilinear path.
    """
    shapes = level_shapes(img.shape[-2], img.shape[-1], n_levels)
    cur = img.astype(jnp.float32)
    levels = [cur]
    for lvl in range(1, n_levels):
        h, w = shapes[lvl]
        cur = _resize_bilinear(cur, h, w)
        levels.append(cur)
    return levels


def gaussian_blur_7x7(img: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """Separable 7x7 Gaussian blur, (..., H, W) float32 -> same.

    The reference blurs each level before BRIEF sampling
    (ORBextractor_old.cc computeDescriptors: GaussianBlur(7,7,sigma=2)).
    Implemented as two 1-D convolutions with replicate padding.
    """
    xs = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    k = jnp.asarray(k)

    lead = img.shape[:-2]
    h, w = img.shape[-2], img.shape[-1]
    x = img.reshape((-1, 1, h, w))
    # replicate-pad then conv via lax.conv_general_dilated with 1D kernels
    xp = jnp.pad(x, ((0, 0), (0, 0), (3, 3), (0, 0)), mode="edge")
    kh = k.reshape(1, 1, 7, 1)
    x = jax.lax.conv_general_dilated(xp, kh, (1, 1), "VALID",
                                     dimension_numbers=("NCHW", "OIHW", "NCHW"))
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (3, 3)), mode="edge")
    kw = k.reshape(1, 1, 1, 7)
    x = jax.lax.conv_general_dilated(xp, kw, (1, 1), "VALID",
                                     dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return x.reshape(lead + (h, w))


# ---------------------------------------------------------------------------
# NumPy oracle (SURVEY.md §4: every kernel keeps a scalar reference impl)
# ---------------------------------------------------------------------------

def resize_bilinear_oracle(img: np.ndarray, h_out: int, w_out: int) -> np.ndarray:
    """Scalar bilinear resize oracle (same pixel-center convention)."""
    h_in, w_in = img.shape[-2:]
    Mh = _resize_matrix(h_in, h_out)
    Mw = _resize_matrix(w_in, w_out)
    return Mh @ img.astype(np.float32) @ Mw.T

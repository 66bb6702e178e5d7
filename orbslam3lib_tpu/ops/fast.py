"""FAST-16 corner detection: branchless, fully vectorized over the image.

Re-design of the reference's HVX FAST
(/root/reference dsp/src/orbslam_dsp_fast.cpp: ring abs-diff tests with
approximate contiguity masks, exact min/max scores at
calculate_fast_scores:452, NMS :649-749, per-block top-N :750) and of the
proprietary HWA detector it normally replaces. Following SURVEY.md §7 we treat
the published FAST semantics as the spec and implement *exact* FAST-9/16
contiguity (the HVX path only approximates it for vector efficiency — here
the exact test is just as cheap).

Everything here is elementwise work over (H, W) maps:
  * ring samples via 16 static rolls (XLA turns these into fused slices),
  * contiguous-arc test + exact corner score via log-doubling windowed min,
  * 3x3 NMS via reduce_window max,
  * per-tile top-K via reshape + lax.top_k (replacing the HVX bitonic sort,
    orbslam_dsp_sort.cpp — SURVEY.md §2.2 notes top_k as its equivalent).

A scalar NumPy oracle (`fast_scores_oracle`) mirrors the reference's
calculate_fast_features_dumb testing pattern (SURVEY.md §4); a vectorized one
(`fast_nms_oracle`) checks score + NMS on full-size images.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

# FAST-16 Bresenham ring of radius 3, (dy, dx), standard order.
RING: Tuple[Tuple[int, int], ...] = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9/16


def _ring_stack(img: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (16, ..., H, W) ring samples. Border pixels wrap via
    roll; callers must mask a >=3 px margin."""
    return jnp.stack([jnp.roll(img, (-dy, -dx), axis=(-2, -1)) for dy, dx in RING], axis=0)


def fast_scores(img: jnp.ndarray, margin: int = 3) -> jnp.ndarray:
    """Exact FAST-9/16 corner score map.

    score(p) = max over the 16 arcs of length 9 of
                 min over the arc of (ring - center)   [bright]
               or (center - ring)                       [dark],
    i.e. the largest threshold t for which p is still a corner. A pixel is a
    corner at threshold t iff score > t. Margin rows/cols are zeroed.

    img: (..., H, W) float32. Returns (..., H, W) float32 scores (>=0).
    """
    c = img
    ring = _ring_stack(img)  # (16, ..., H, W)

    def windowed_min(d):
        # circular windowed min of length 9 along axis 0 via log-doubling
        m = jnp.minimum(d, jnp.roll(d, -1, axis=0))      # window 2
        m = jnp.minimum(m, jnp.roll(m, -2, axis=0))      # window 4
        m = jnp.minimum(m, jnp.roll(m, -4, axis=0))      # window 8
        return jnp.minimum(m, jnp.roll(d, -8, axis=0))   # window 9

    bright = jnp.max(windowed_min(ring - c), axis=0)
    dark = jnp.max(windowed_min(c - ring), axis=0)
    score = jnp.maximum(jnp.maximum(bright, dark), 0.0)

    h, w = img.shape[-2], img.shape[-1]
    ys = jnp.arange(h)
    xs = jnp.arange(w)
    valid = ((ys >= margin) & (ys < h - margin))[:, None] & (
        (xs >= margin) & (xs < w - margin))[None, :]
    return jnp.where(valid, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Suppress non-maxima: keep score only where it equals the 3x3 max.
    (Reference approximates this with sorted horizontal+vertical passes,
    orbslam_dsp_fast.cpp:649-749; exact is cheap here.)"""
    lead = score.shape[:-2]
    x = score.reshape((-1,) + score.shape[-2:])
    mx = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME")
    out = jnp.where(x >= mx, x, 0.0)
    return out.reshape(lead + score.shape[-2:])


def tile_topk(score: jnp.ndarray, tile_h: int, tile_w: int, k: int):
    """Per-tile top-K candidate selection over a score map.

    score: (H, W). The map is zero-padded up to tile multiples (reference
    blocks are 128x80 with per-block budget 16, orbslam_dsp.cpp:57-60).

    Returns (scores (T*k,), ys (T*k,), xs (T*k,)) with T = n_tiles; invalid
    slots carry score 0.
    """
    h, w = score.shape
    ph = (-h) % tile_h
    pw = (-w) % tile_w
    sp = jnp.pad(score, ((0, ph), (0, pw)))
    H, W = h + ph, w + pw
    nty, ntx = H // tile_h, W // tile_w
    tiles = sp.reshape(nty, tile_h, ntx, tile_w).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(nty * ntx, tile_h * tile_w)
    top_s, top_i = jax.lax.top_k(tiles, k)  # (T, k)
    ty = jax.lax.broadcasted_iota(jnp.int32, (nty * ntx, k), 0) // ntx
    tx = jax.lax.broadcasted_iota(jnp.int32, (nty * ntx, k), 0) % ntx
    ys = ty * tile_h + top_i // tile_w
    xs = tx * tile_w + top_i % tile_w
    return top_s.reshape(-1), ys.reshape(-1), xs.reshape(-1)


# ---------------------------------------------------------------------------
# NumPy oracle
# ---------------------------------------------------------------------------

def fast_scores_oracle(img: np.ndarray, margin: int = 3) -> np.ndarray:
    """Scalar FAST-9/16 exact-score oracle."""
    h, w = img.shape
    out = np.zeros((h, w), dtype=np.float32)
    img = img.astype(np.float32)
    for y in range(margin, h - margin):
        for x in range(margin, w - margin):
            c = img[y, x]
            ring = np.array([img[y + dy, x + dx] for dy, dx in RING])
            best = 0.0
            for start in range(16):
                idx = [(start + i) % 16 for i in range(ARC_LEN)]
                best = max(best, np.min(ring[idx] - c), np.min(c - ring[idx]))
            out[y, x] = max(best, 0.0)
    return out


def fast_nms_oracle(img: np.ndarray, margin: int = 3) -> np.ndarray:
    """NumPy oracle of nms3x3(fast_scores(img, margin)) for full images:
    each of the 16 arcs of 9 ring samples enumerated explicitly (no
    log-doubling), then an explicit 3x3 neighbourhood max. Vectorized over
    pixels, so a 640x400 level takes well under a second."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    p = np.pad(img, 3)
    ring = np.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dy, dx in RING])                       # (16, H, W)
    score = np.zeros((h, w), np.float32)
    for start in range(16):
        arc = ring[[(start + i) % 16 for i in range(ARC_LEN)]]
        score = np.maximum(score, np.min(arc - img, axis=0))
        score = np.maximum(score, np.min(img - arc, axis=0))
    inside = np.zeros((h, w), bool)
    inside[margin:h - margin, margin:w - margin] = True
    score = np.where(inside, score, np.float32(0.0))
    sp = np.pad(score, 1, constant_values=-np.inf)
    nbr = np.max(np.stack([sp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)]), axis=0)
    return np.where(score >= nbr, score, np.float32(0.0))

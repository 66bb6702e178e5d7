"""Batched patch extraction from a pyramid canvas as a gather + matmul.

Extracting a (h, w) window per keypoint as a vmapped dynamic_slice lowers to
a loop of per-keypoint slices. The vectorizing decomposition used here:

  1. ROW gather: (N*h,) row indices into the (L*H, W) flattened canvas —
     an embedding-lookup-shaped gather;
  2. COLUMN window: a batched one-hot matmul
     patch[n,i,j] = sum_c strip[n,i,c] * (c == x0[n]+j)
     that never materializes per-element indices.

This mirrors the reference DSP's two-phase VTCM block caching (rows DMA'd,
columns vector-selected; orbslam_dsp_pyramid.h:110-130) in spirit: bulk
contiguous moves + dense lane-parallel selection. Whether a plain 2-D gather
is as fast on the GPU is not measured yet (ROADMAP queue 3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_patches(canvas: jnp.ndarray, level: jnp.ndarray, y: jnp.ndarray,
                   x: jnp.ndarray, h: int, w: int,
                   y_off: int = 0, x_off: int = 0) -> jnp.ndarray:
    """canvas (L, H, W) f32; level/y/x (N,) int32. Returns (N, h, w) patches
    whose top-left corner is (y + y_off, x + x_off) in the keypoint's level.

    Out-of-range rows are clamped; out-of-range columns produce zeros —
    callers enforce detection margins, so neither occurs for valid
    keypoints. Column selection runs at HIGHEST matmul precision, where a
    one-hot x value product is exact (HIGH is TF32 on the GPU and would
    round the value to 10 mantissa bits).
    """
    L, H, W = canvas.shape
    flat = canvas.reshape(L * H, W)
    rows = (level[:, None] * H + y[:, None] + y_off
            + jnp.arange(h, dtype=jnp.int32)[None, :])          # (N, h)
    rows = jnp.clip(rows, 0, L * H - 1)
    strips = jnp.take(flat, rows.reshape(-1), axis=0)           # (N*h, W)
    strips = strips.reshape(-1, h, W)

    cols = (x[:, None] + x_off
            + jnp.arange(w, dtype=jnp.int32)[None, :])          # (N, w)
    iota_w = jax.lax.broadcasted_iota(jnp.int32, (1, W, 1), 1)
    # arithmetic one-hot (the pred-free gating style of ops/masks.py)
    diff = jnp.abs(iota_w - cols[:, None, :]).astype(strips.dtype)
    onehot = jnp.clip(1.0 - diff, 0.0, 1.0)                     # (N, W, w)
    return jax.lax.dot_general(
        strips, onehot, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)                    # (N, h, w)

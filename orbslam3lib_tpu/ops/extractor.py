"""Fused ORB extraction pipeline: pyramid -> FAST -> per-tile top-K ->
orientation -> BRIEF, one jitted graph per image geometry.

This is the replacement for the whole DSP side of the reference
(/root/reference dsp/src/orbslam_dsp.cpp extractORB:630-802: de-interleave,
per-level bilinear reduce + HWA detect [HOT LOOP 1], per-level ic_angle +
descriptors [HOT LOOP 2]). Design mapping (SURVEY.md §2.4):

  * the two persistent left/right DSP threads (P3) become a batch dimension
    of 2 handled by vmap over the eye axis;
  * the HWA-while-DSP pipeline overlap (P4) disappears: XLA schedules the
    whole per-level chain as one fused program;
  * the 128x80 VTCM sub-image blocks (P5) become the per-tile top-K grid —
    same tile geometry (reference blocks 128w x 80h, budget 16/block,
    orbslam_dsp.cpp:57-60);
  * the dynamic feature-budget threshold controller
    (orbslam_dsp_hwa_pipeline.h:18-19: 170 +- 30 features) stays on the host
    (see `ThresholdController`) and feeds the traced `threshold` scalar, so
    retuning never recompiles.

Output is a fixed-capacity masked Features pytree — the reference's own
fixed-budget design (MAX_POINTS, top-16/block) carried to its XLA-native
conclusion.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import fast, pyramid
from .orient_brief import RAW_RADIUS, orient_and_brief

# Reference tile geometry: 128 wide x 80 high, top-16 per tile
TILE_H, TILE_W, TILE_K = 80, 128, 16
DETECT_MARGIN = RAW_RADIUS + 2  # all 45x45 raw-patch gathers stay in bounds
MAX_KP_DEFAULT = 1024


@jax.tree_util.register_pytree_node_class
@dataclass
class Features:
    """Fixed-capacity keypoint set for one image (or a batch of images when
    arrays carry a leading batch dim)."""
    xy: jnp.ndarray       # (N, 2) float32, level-0 pixel coords (x, y)
    level: jnp.ndarray    # (N,) int32 pyramid level
    score: jnp.ndarray    # (N,) float32 FAST score
    angle: jnp.ndarray    # (N,) float32 radians
    desc: jnp.ndarray     # (N, 256) int8 0/1 bits
    valid: jnp.ndarray    # (N,) bool

    def tree_flatten(self):
        return (self.xy, self.level, self.score, self.angle, self.desc, self.valid), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_valid(self):
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)


def _detect_level(img_l: jnp.ndarray):
    """One pyramid level -> per-tile top-K candidates (score, y, x)."""
    score = fast.nms3x3(fast.fast_scores(img_l, margin=DETECT_MARGIN))
    return fast.tile_topk(score, TILE_H, TILE_W, TILE_K)


def _canvas(levels: List[jnp.ndarray], h0: int, w0: int) -> jnp.ndarray:
    """Stack all pyramid levels into one (L, H0, W0) zero-padded array —
    the analog of the reference's VTCM block cache; lets orientation /
    descriptor gathers index a single tensor by (level, y, x)."""
    return jnp.stack([
        jnp.pad(l, ((0, h0 - l.shape[0]), (0, w0 - l.shape[1]))) for l in levels
    ])


def extract_orb(img: jnp.ndarray, threshold: jnp.ndarray,
                max_kp: int = MAX_KP_DEFAULT,
                n_levels: int = pyramid.N_LEVELS,
                return_canvas: bool = False):
    """Extract ORB features from one grayscale image.

    img: (H, W) uint8/float32. threshold: traced scalar (host-controlled).
    Returns a Features pytree of static capacity `max_kp`; with
    `return_canvas` also the (L, H, W) zero-padded pyramid canvas (the
    reference's mvImagePyramid, needed by the SAD stereo refinement).
    """
    h0, w0 = img.shape
    levels = pyramid.build_pyramid(img, n_levels)
    scales = jnp.asarray(pyramid.scale_factors(n_levels))

    cand_s, cand_y, cand_x, cand_l = [], [], [], []
    for lvl, img_l in enumerate(levels):
        s, y, x = _detect_level(img_l)
        cand_s.append(s)
        cand_y.append(y)
        cand_x.append(x)
        cand_l.append(jnp.full_like(y, lvl))
    s = jnp.concatenate(cand_s)
    y = jnp.concatenate(cand_y)
    x = jnp.concatenate(cand_x)
    l = jnp.concatenate(cand_l)

    valid = s > threshold
    s_masked = jnp.where(valid, s, 0.0)
    k = min(max_kp, s.shape[0])
    top_s, top_i = jax.lax.top_k(s_masked, k)
    if k < max_kp:  # pad up to capacity
        pad = max_kp - k
        top_s = jnp.pad(top_s, (0, pad))
        top_i = jnp.pad(top_i, (0, pad))
    kp_y = y[top_i]
    kp_x = x[top_i]
    kp_l = l[top_i]
    kp_valid = top_s > threshold

    canvas = _canvas(levels, h0, w0)
    # fused orientation + BRIEF: one 45x45 raw-patch gather, per-patch 7x7
    # blur as matmuls (no full-image blur canvas), binned compare matmul
    angle, desc = orient_and_brief(canvas, kp_l, kp_y, kp_x)

    # level coords -> level-0 coords, pixel-center convention (matches the
    # bilinear resize convention in ops/pyramid.py)
    sc = scales[kp_l]
    x0 = (kp_x.astype(jnp.float32) + 0.5) * sc - 0.5
    y0 = (kp_y.astype(jnp.float32) + 0.5) * sc - 0.5
    xy = jnp.stack([x0, y0], axis=-1)

    zero_f = jnp.float32(0.0)
    feats = Features(
        xy=jnp.where(kp_valid[:, None], xy, zero_f),
        level=jnp.where(kp_valid, kp_l, -1),
        score=top_s,
        angle=jnp.where(kp_valid, angle, zero_f),
        desc=desc * kp_valid[:, None].astype(jnp.int8),
        valid=kp_valid,
    )
    if return_canvas:
        return feats, canvas
    return feats


@partial(jax.jit, static_argnames=("max_kp", "n_levels", "return_canvas"))
def extract_orb_stereo(img_pair: jnp.ndarray, threshold: jnp.ndarray,
                       max_kp: int = MAX_KP_DEFAULT,
                       n_levels: int = pyramid.N_LEVELS,
                       return_canvas: bool = False):
    """Batched stereo extraction: (2, H, W) -> Features with leading dim 2.

    The eye axis is the reference's left/right DSP worker-thread pair
    (SURVEY.md §2.4 P3) expressed as a vmap batch dimension. With
    `return_canvas`, also returns the (2, L, H, W) pyramid canvases.
    """
    return jax.vmap(
        lambda im: extract_orb(im, threshold, max_kp, n_levels, return_canvas)
    )(img_pair)


@partial(jax.jit, static_argnames=("max_kp", "n_levels"))
def extract_orb_mono(img: jnp.ndarray, threshold: jnp.ndarray,
                     max_kp: int = MAX_KP_DEFAULT,
                     n_levels: int = pyramid.N_LEVELS):
    """Single-image extraction with a leading eye axis of 1 (Features layout
    compatible with the stereo tracker entry points, which consume eye [0]).
    The RGB-D path uses this to run the front end ONCE per frame — the
    reference's Frame(imGray, imDepth, ...) ctor also extracts once
    (Tracking.cc GrabImageRGBD)."""
    return jax.vmap(
        lambda im: extract_orb(im, threshold, max_kp, n_levels)
    )(img[None])


class ThresholdController:
    """Host-side dynamic FAST-threshold feedback loop.

    Reference: the HWA pipeline regulates toward 170 +- 30 features/image at
    90 FPS (orbslam_dsp_hwa_pipeline.h:15-19). Proportional update on the log
    threshold keeps the valid-feature count inside the deadband.
    """

    def __init__(self, target: int = 170, band: int = 30,
                 t0: float = 17.0, t_min: float = 5.0, t_max: float = 80.0,
                 gain: float = 0.15, gain_down: float = 0.6):
        self.target, self.band = target, band
        self.t, self.t_min, self.t_max, self.gain = t0, t_min, t_max, gain
        self.gain_down = gain_down

    def update(self, n_features: int) -> float:
        """Log-proportional step t *= (n/target)^g with ASYMMETRIC gains:
        a too-high threshold starves the tracker (feature counts crash with
        the scene's texture, inliers die within frames), while a too-low
        one merely over-fills the fixed budget — so down-regulation is ~4x
        stronger and can halve the threshold in one step, where the upward
        path creeps at a few percent per update. (The symmetric version
        measurably ratcheted to ~48 on texture-rich sections, then lost
        tracking when the corridor content thinned: count 512 -> 18 in a
        few frames while the threshold decayed at only 14%/update.)"""
        err = n_features - self.target
        if abs(err) > self.band:
            ratio = max(n_features, 1) / max(self.target, 1)
            g = self.gain if err > 0 else self.gain_down
            self.t *= float(np.clip(ratio ** g, 0.5, 1.2))
            self.t = float(np.clip(self.t, self.t_min, self.t_max))
        return self.t

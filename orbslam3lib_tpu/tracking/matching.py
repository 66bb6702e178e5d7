"""Association searches: projection matching and stereo matching.

Re-design of the reference's ORBmatcher
(/root/reference app/src/main/cpp/src/ORBmatcher.cc) and of the stereo
matchers in Frame.cc. The reference probes a 64x48 per-frame feature grid
cell by cell (GetFeaturesInArea, Frame.cc:673; SearchByProjection hot loop,
ORBmatcher.cc:1736-1792). Here the grid disappears: the spatial gate, the
level-compatibility gate and the descriptor distances are all computed as
dense (P, N) gating matrices — the descriptor term is one 256-deep
matmul (ops/matcher.py) and the whole search is a handful of fused
elementwise passes. This is the `vmap over map points` equivalent of the
reference's SearchByProjectionThread sharding scaffold (SURVEY.md §2.4 P7).

All 2-D gates are float arithmetic (ops/masks.py), not booleans — see the
backend pathology note there.

Constants follow the reference: TH_HIGH=100, TH_LOW=50 (ORBmatcher.cc:36-38),
stereo descriptor gate (TH_HIGH+TH_LOW)/2=75 (Frame.cc:827 path) and the
fisheye kNN gate dist<70 (Frame.cc:1169-1177).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.masks import BIG, is_finite_match, leq_int, leq_soft, penalize, step01
from ..ops.matcher import hamming_matrix
from ..ops.pyramid import scale_factors
from ..utils import cameras, lie

TH_HIGH = 100.0
TH_LOW = 50.0
TH_STEREO_DESC = 75.0
TH_FISHEYE = 70.0
NN_RATIO_DEFAULT = 0.9


class ProjMatches(NamedTuple):
    """Result of a projection search over P landmarks vs N frame features.

    mp_feat (P,) int32 : matched feature slot per landmark (-1 = none)
    visible (P,) f32   : frustum-gate value in [0,1] (for mp_visible stats)
    """
    mp_feat: jnp.ndarray
    visible: jnp.ndarray


def _one_to_one(dm: jnp.ndarray):
    """Resolve a penalized (P, N) distance matrix to one-to-one matches.

    Per landmark pick its best feature; per feature keep only the landmark
    with the smallest distance among those that picked it (the reference
    resolves collisions by replacing worse matches in SearchByProjection).
    Returns mp_feat (P,) int32 (-1 = none).
    """
    P, N = dm.shape
    best_feat = jnp.argmin(dm, axis=1)                      # (P,)
    best_d = jnp.min(dm, axis=1)
    has = is_finite_match(best_d)                           # f32 {0,1}
    # per-feature min over landmarks that chose it (scatter-min)
    tgt = jnp.where(has > 0.5, best_feat, N)                # 1-D int select: ok
    feat_min = jnp.full(N + 1, BIG).at[tgt].min(best_d, mode="drop")
    win = has * step01((feat_min[best_feat] + 1e-3) - best_d + 0.5)
    # tie-break exact duplicates: first landmark index wins
    order = jnp.where(win > 0.5, jnp.arange(P), P)
    first = jnp.full(N + 1, P).at[tgt].min(order, mode="drop")
    winner = (win > 0.5) & (first[best_feat] == jnp.arange(P))
    return jnp.where(winner, best_feat, -1)


def predicted_level(dist: jnp.ndarray, max_dist: jnp.ndarray,
                    n_levels: int = 8) -> jnp.ndarray:
    """MapPoint::PredictScale — level whose scale matches the viewing
    distance (log ratio against the per-level scale chain)."""
    sf = jnp.asarray(scale_factors(n_levels))
    ratio = jnp.clip(max_dist / jnp.maximum(dist, 1e-6), 1.0, None)
    lvl = jnp.argmin(jnp.abs(jnp.log(ratio[..., None]) - jnp.log(sf)[None, :]), axis=-1)
    return lvl.astype(jnp.int32)


@partial(jax.jit, static_argnames=("radius", "cam_model", "img_w", "img_h",
                                   "n_levels", "th_desc", "check_view_angle"))
def search_by_projection(mp_pos, mp_desc, mp_valid, mp_normal, mp_min_dist,
                         mp_max_dist, R, t, cam_params, feat_xy, feat_level,
                         feat_desc, feat_valid, radius: float,
                         cam_model: int = cameras.PINHOLE,
                         img_w: int = 640, img_h: int = 400,
                         th_desc: float = TH_HIGH, n_levels: int = 8,
                         check_view_angle: bool = True) -> ProjMatches:
    """Project landmarks into the frame and match to features.

    Semantics of ORBmatcher::SearchByProjection(Frame, vector<MapPoint*>)
    (ORBmatcher.cc:44) + Frame::isInFrustum (Frame.cc:528): depth>0, image
    bounds, scale-invariance distance window, viewing angle < 60 deg, search
    window radius * scale(predicted level), level gate within +-1, Hamming
    gate th_desc.
    """
    p_c = lie.se3_apply(R, t, mp_pos)            # (P,3)
    z = p_c[..., 2]
    uv = cameras.project(cam_model, cam_params, p_c)
    dist = jnp.linalg.norm(p_c, axis=-1)

    vis = mp_valid.astype(jnp.float32)
    vis = vis * step01(uv[..., 0] + 1.0) * step01(img_w - uv[..., 0])
    vis = vis * step01(uv[..., 1] + 1.0) * step01(img_h - uv[..., 1])
    vis = vis * step01((z - 0.1) * 10.0)
    # landmarks without scale-band info (max_dist <= 0 or the 1e9 unset
    # sentinel of empty_map: deserialized or externally-built maps) skip the
    # band gate and predict level 0
    band = (mp_max_dist > 0) & (mp_max_dist < 1e8)
    has_band = band.astype(jnp.float32)
    vis = vis * (1.0 - has_band
                 + has_band * step01((dist - 0.8 * mp_min_dist) * 8.0)
                 * step01((1.2 * mp_max_dist - dist) * 8.0))
    if check_view_angle:
        Rw, cw = lie.se3_inverse(R, t)
        view = mp_pos - cw
        view = view / jnp.maximum(jnp.linalg.norm(view, axis=-1, keepdims=True), 1e-9)
        cosang = jnp.sum(view * mp_normal, axis=-1)
        vis = vis * step01((cosang - 0.5) * 8.0)

    lvl = jnp.where(band, predicted_level(dist, mp_max_dist, n_levels), 0)
    sf = jnp.asarray(scale_factors(n_levels))
    r_scaled = radius * sf[lvl]                   # (P,)

    # (P, N) gates — all arithmetic
    d2 = jnp.sum((uv[:, None, :] - feat_xy[None, :, :]) ** 2, axis=-1)
    g = step01(r_scaled[:, None] ** 2 - d2 + 1.0)
    dlvl = jnp.abs(feat_level[None, :] - lvl[:, None]).astype(jnp.float32)
    g = g * step01(2.0 - dlvl)
    g = g * vis[:, None] * feat_valid.astype(jnp.float32)[None, :]

    desc_d = hamming_matrix(mp_desc, feat_desc)
    g = g * leq_int(desc_d, th_desc)
    mp_feat = _one_to_one(penalize(desc_d, g))
    return ProjMatches(mp_feat=mp_feat, visible=vis)


@partial(jax.jit, static_argnames=("bf", "min_z", "n_levels"))
def match_rectified_stereo(xy_l, level_l, desc_l, valid_l,
                           xy_r, level_r, desc_r, valid_r,
                           bf: float, min_z: float,
                           n_levels: int = 8):
    """Rectified stereo matching: row-banded candidates + disparity window.

    Semantics of Frame::ComputeStereoMatches (Frame.cc:827-997): candidate
    right features within +-2*scale rows, disparity in (0, bf/min_z],
    descriptor gate (TH_HIGH+TH_LOW)/2. (The reference's 11x11 SAD sub-pixel
    refinement over the image pyramid is a follow-up refinement stage —
    descriptor-level matching dominates accuracy at SLAM scale.)

    Returns (u_right (N,), depth (N,)) with -1 / 0 for unmatched.
    """
    sf = jnp.asarray(scale_factors(n_levels))
    row_tol = 2.0 * sf[jnp.clip(level_l, 0, n_levels - 1)]
    dv = jnp.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    max_disp = bf / min_z

    g = step01(row_tol[:, None] - dv + 1.0)
    g = g * step01((disp - 0.1) * 4.0)
    g = g * step01((max_disp - disp) + 1.0)
    g = g * valid_l.astype(jnp.float32)[:, None] * valid_r.astype(jnp.float32)[None, :]
    dlvl = jnp.abs(level_l[:, None] - level_r[None, :]).astype(jnp.float32)
    g = g * step01(2.0 - dlvl)

    d = hamming_matrix(desc_l, desc_r)
    g = g * leq_int(d, TH_STEREO_DESC)
    dm = penalize(d, g)

    best = jnp.argmin(dm, axis=1)
    best_d = jnp.min(dm, axis=1)
    has = is_finite_match(best_d)                 # f32 {0,1}
    u_r = has * xy_r[best, 0] + (1.0 - has) * (-1.0)
    disparity = (xy_l[:, 0] - u_r) * has
    depth = has * step01((disparity - 0.1) * 100.0) * bf / jnp.maximum(disparity, 0.1)
    return u_r, depth


@partial(jax.jit, static_argnames=("bf",))
def match_fisheye_stereo(xy_l, desc_l, valid_l, xy_r, desc_r, valid_r,
                         cam_params_l, cam_params_r, R_lr, t_lr, bf: float):
    """Two-camera (non-rectified, fisheye) stereo matching + triangulation.

    Semantics of the reference's PRODUCTION stereo path
    (Frame::ComputeStereoFishEyeMatches, Frame.cc:1142-1251: DSP kNN matches
    accepted at Hamming dist < 70 — fixed gate replacing the ratio test —
    then KannalaBrandt8::TriangulateMatches per match: parallax, chirality
    and 5.991-chi2 reprojection checks in both views).

    R_lr/t_lr: pose of the right camera in the left frame (x_l = R_lr x_r +
    t_lr). Returns (u_r, depth) in the rectified-path contract: depth is the
    left-camera z of the triangulated point and u_r the VIRTUAL disparity
    coordinate u - bf/z (the RGB-D trick), so every downstream consumer
    (spawning, pose opt, BA) works unchanged.
    """
    d = hamming_matrix(desc_l, desc_r, valid_l, valid_r)
    best = jnp.argmin(d, axis=1)
    d1 = jnp.min(d, axis=1)
    ok = valid_l & (d1 <= TH_FISHEYE)            # dist<70, Frame.cc:1169

    ray_l = cameras.kb8_unproject(cam_params_l, xy_l)        # z=1 rays
    ray_r = cameras.kb8_unproject(cam_params_r, xy_r[best])
    p3d, cosp, z1, z2 = cameras.triangulate_two_view(ray_l, ray_r, R_lr, t_lr)
    ok = ok & (cosp < 0.9998) & (z1 > 0.05) & (z2 > 0.05)

    # reprojection gates in both views (KannalaBrandt8::TriangulateMatches)
    uv_l_hat = cameras.kb8_project(cam_params_l, p3d)
    e_l = jnp.sum((uv_l_hat - xy_l) ** 2, axis=-1)
    p_r = jnp.einsum("ij,nj->ni", R_lr.T, p3d - t_lr[None, :])
    uv_r_hat = cameras.kb8_project(cam_params_r, p_r)
    e_r = jnp.sum((uv_r_hat - xy_r[best]) ** 2, axis=-1)
    ok = ok & (e_l < 5.991) & (e_r < 5.991)

    depth = jnp.where(ok, p3d[:, 2], 0.0)
    u_r = jnp.where(ok, xy_l[:, 0] - bf / jnp.maximum(depth, 1e-3), -1.0)
    return u_r, depth


@partial(jax.jit, static_argnames=("bf", "min_z", "n_levels"))
def refine_stereo_sad(canvas_l, canvas_r, xy_l, level_l, valid_l, u_r, depth,
                      bf: float, min_z: float, n_levels: int = 8):
    """Sub-pixel SAD refinement of rectified-stereo matches.

    Semantics of the refinement stage of Frame::ComputeStereoMatches
    (Frame.cc:897-997): at the left keypoint's pyramid level, an 11x11
    center-normalized SAD sweep over +-5 px around the matched right column,
    parabolic sub-pixel fit on the best triplet (rejected if |delta| > 1),
    disparity window (0, bf/min_z], and the outlier cut at
    1.5 * 1.4 * median(best SAD).

    canvas_l/canvas_r: (L, H, W) zero-padded pyramid canvases (from
    extract_orb(..., return_canvas=True)). u_r/depth: the descriptor-level
    match output (-1 / 0 when unmatched). Returns refined (u_r, depth).
    """
    W_R = 5                      # half window (11x11)
    SRCH = 5                     # +-5 px sweep
    Lh, Hh, Wh = canvas_l.shape
    N = xy_l.shape[0]
    sf = jnp.asarray(scale_factors(n_levels))
    lvl = jnp.clip(level_l, 0, n_levels - 1)
    sc = sf[lvl]

    matched = (u_r >= 0.0) & valid_l
    # level coords (inverse of the extractor's pixel-center mapping)
    xl = (xy_l[:, 0] + 0.5) / sc - 0.5
    yl = (xy_l[:, 1] + 0.5) / sc - 0.5
    xr0 = (u_r + 0.5) / sc - 0.5
    xi = jnp.round(xl).astype(jnp.int32)
    yi = jnp.round(yl).astype(jnp.int32)
    ri = jnp.round(xr0).astype(jnp.int32)

    # in-bounds gate at the level's true extent (exact pyramid geometry)
    from ..ops.pyramid import level_shapes
    shp = np.asarray(level_shapes(Hh, Wh, n_levels))
    lh = jnp.asarray(shp[:, 0], jnp.int32)[lvl]
    lw = jnp.asarray(shp[:, 1], jnp.int32)[lvl]
    pad = W_R + SRCH + 1
    ok = matched & (xi >= pad) & (xi < lw - pad) & \
        (yi >= pad) & (yi < lh - pad) & (ri >= pad) & (ri < lw - pad)
    xi = jnp.clip(xi, pad, Wh - pad - 1)
    yi = jnp.clip(yi, pad, Hh - pad - 1)
    ri = jnp.clip(ri, pad, Wh - pad - 1)

    # patch extraction via row-gather + one-hot column matmul (slice-style
    # and element-gather formulations serialize on this backend — see
    # ops/patches.py)
    def slice_patch(canvas, ly, lx, h, w):
        from ..ops.patches import gather_patches
        return gather_patches(canvas, lvl, ly, lx, h, w)

    # left patch (N, 11, 11), center-normalized
    pl = slice_patch(canvas_l, yi - W_R, xi - W_R, 2 * W_R + 1, 2 * W_R + 1)
    pl = pl - pl[:, W_R, W_R][:, None, None]
    # right strip (N, 11, 11 + 2*SRCH)
    strip = slice_patch(canvas_r, yi - W_R, ri - (W_R + SRCH),
                        2 * W_R + 1, 2 * (W_R + SRCH) + 1)

    def sad_at(inc):
        w = jax.lax.dynamic_slice_in_dim(strip, inc + SRCH, 2 * W_R + 1, axis=2)
        w = w - w[:, W_R, W_R][:, None, None]
        return jnp.sum(jnp.abs(pl - w), axis=(1, 2))

    sads = jnp.stack([sad_at(i) for i in range(-SRCH, SRCH + 1)], axis=1)  # (N, 11)
    best = jnp.argmin(sads, axis=1)                                        # in [0,10]
    best_in = jnp.clip(best, 1, 2 * SRCH - 1)  # need both neighbors
    ok = ok & (best >= 1) & (best <= 2 * SRCH - 1)
    iN = jnp.arange(N)
    dC = sads[iN, best_in]
    dL = sads[iN, best_in - 1]
    dRr = sads[iN, best_in + 1]
    denom = dL + dRr - 2.0 * dC
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      (dL - dRr) / (2.0 * jnp.maximum(denom, 1e-6)), 0.0)
    ok = ok & (jnp.abs(delta) <= 1.0)

    xr_ref = ri.astype(jnp.float32) + (best_in - SRCH).astype(jnp.float32) + delta
    # the sweep measures the disparity AT the rounded left position; assume
    # locally-constant disparity and re-anchor at the unrounded keypoint
    disp_lvl = xi.astype(jnp.float32) - xr_ref
    u_r_ref = xy_l[:, 0] - disp_lvl * sc
    disparity = xy_l[:, 0] - u_r_ref
    max_disp = bf / min_z
    ok = ok & (disparity > 0.01) & (disparity <= max_disp)

    # outlier cut: 1.5 * 1.4 * median best SAD over accepted matches
    okf = ok.astype(jnp.float32)
    n_ok = jnp.sum(okf).astype(jnp.int32)
    s_sorted = jnp.sort(jnp.where(ok, dC, jnp.inf))
    med = s_sorted[jnp.clip((n_ok - 1) // 2, 0, N - 1)]
    ok = ok & (dC <= 1.5 * 1.4 * med)

    u_out = jnp.where(ok, u_r_ref, u_r)
    # drop matches the SAD cut rejected entirely (reference erases them)
    cut = matched & ~ok
    u_out = jnp.where(cut, -1.0, u_out)
    d_out = jnp.where(ok, bf / jnp.maximum(disparity, 1e-3),
                      jnp.where(cut, 0.0, depth))
    return u_out, d_out


HISTO_LENGTH = 30   # rotation-consistency bins (ORBmatcher.cc:38)


@jax.jit
def rotation_consistency(angle_a, angle_b_matched, ok):
    """ORBmatcher's rotation-consistency histogram (ComputeThreeMaxima,
    used by every CheckOrientation search, ORBmatcher.cc:36-38): bin the
    per-match orientation difference into HISTO_LENGTH bins and keep only
    matches in the three strongest bins (ties to the global motion's
    rotation). angle_a (N,), angle_b_matched (N,) = the matched partner's
    angle per row; ok (N,) bool. Returns the filtered ok mask."""
    two_pi = 2.0 * np.pi
    rot = jnp.mod(angle_a - angle_b_matched, two_pi)
    b = jnp.clip((rot * (HISTO_LENGTH / two_pi)).astype(jnp.int32),
                 0, HISTO_LENGTH - 1)
    hist = jnp.zeros(HISTO_LENGTH, jnp.float32).at[
        jnp.where(ok, b, HISTO_LENGTH)].add(1.0, mode="drop")
    top_v, top_i = jax.lax.top_k(hist, 3)
    # reference drops bins below 0.1x the best bin
    keep_bin = jnp.zeros(HISTO_LENGTH, bool).at[top_i].set(
        top_v >= 0.1 * top_v[0])
    return ok & keep_bin[b]


@partial(jax.jit, static_argnames=("window", "th", "ratio"))
def match_for_initialization(xy_a, desc_a, valid_a, angle_a,
                             xy_b, desc_b, valid_b, angle_b,
                             window: float = 100.0, th: float = 50.0,
                             ratio: float = 0.9):
    """SearchForInitialization (ORBmatcher.cc:649): descriptor kNN-2 with
    Lowe ratio, a spatial search window (the reference probes a 100 px
    grid window, Tracking.cc:2548-2556) and the rotation-consistency
    histogram. Returns (idx (Na,), ok (Na,) bool)."""
    d = hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    d2_spatial = jnp.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, axis=-1)
    g = step01(window * window - d2_spatial + 1.0)
    dm = penalize(d, g)
    from ..ops.matcher import knn2
    i1, d1, d2 = knn2(dm)
    ok = valid_a & (d1 <= th) & (d1 <= ratio * d2)
    ok = rotation_consistency(angle_a, angle_b[jnp.clip(i1, 0, len(angle_b) - 1)], ok)
    return jnp.where(ok, i1, -1), ok


@jax.jit
def match_descriptors_ratio(desc_a, valid_a, desc_b, valid_b,
                            th: float = TH_LOW, ratio: float = NN_RATIO_DEFAULT):
    """Plain descriptor kNN-2 with Lowe ratio + threshold (the
    SearchForInitialization / fisheye-stereo style gate). Returns
    (idx (Na,), ok (Na,) bool)."""
    from ..ops.matcher import knn2
    i1, d1, d2 = knn2(hamming_matrix(desc_a, desc_b, valid_a, valid_b))
    ok = valid_a & (d1 <= th) & (d1 <= ratio * d2)   # 1-D preds: fine
    return jnp.where(ok, i1, -1), ok

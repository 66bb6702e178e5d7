"""The tracking front end + synchronous local mapping, orchestrated on the
host with all math in a few jitted graphs.

Re-design of the reference's Tracking state machine
(/root/reference app/src/main/cpp/src/Tracking.cc:1847-2388 Track();
TrackWithMotionModel:2912; TrackLocalMap:3007; NeedNewKeyFrame:3125;
CreateNewKeyFrame:3277; StereoInitialization:2391;
MonocularInitialization:2505; Relocalization:3670; CreateMapInAtlas:2720;
PreintegrateIMU:1677; PredictStateIMU:1791) and of LocalMapping's synchronous
core (LocalMapping.cc:64-288, InitializeIMU:1196). Concept mapping:

  reference                      ->  here
  ------------------------------------------------------------------
  motion-model projection search ->  stage-1 search_by_projection (r=7)
  TrackLocalMap                  ->  stage-2 search (r=3) + pose LM
  g2o PoseOptimization           ->  tracking/pose_opt.py (one jit)
  PoseInertialOptimization*      ->  tracking/inertial_opt.py
  TwoViewReconstruction          ->  mapping/twoview.py (mono init)
  Relocalization (MLPnP RANSAC)  ->  tracking/reloc.py (batched P6P)
  Atlas::CreateNewMap on loss    ->  models/atlas.py
  LocalMapping + LoopClosing     ->  mapping/{local_mapping,loop_closing}.py
  REGISTER_TIMES                 ->  utils/timing.StageTimer

Sensors: "stereo", "mono", optionally + IMU (cfg.use_imu). The per-frame
device work is a handful of jitted calls; scalar state-machine logic stays on
the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from time import perf_counter as _perf
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..mapping import local_mapping as lm_ops
from ..mapping.local_ba import BAProblem, bundle_adjust
from ..mapping.map_ba import inv_sigma2 as _inv_sigma2
from ..mapping.map_ba import map_window_ba as _local_ba
from ..models import map_state as ms
from ..models.atlas import Atlas, transform_map
from ..ops.extractor import Features, ThresholdController, extract_orb_stereo
from ..ops.pyramid import scale_factors
from ..tracking import imu as imu_mod
from ..tracking import matching
from ..tracking.inertial_opt import InertialFrameState, inertial_init_optimization, \
    pose_inertial_optimization
from ..tracking.pose_opt import PoseObs, pose_optimization
from ..utils import cameras, lie
from ..utils.timing import StageTimer, Verbose

# Tracking states (Tracking.h eTrackingState)
NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3


def _local_map_mask(m: ms.MapState, prev_mp, ref_kf=None):
    """Local-map landmark mask (TrackLocalMap's UpdateLocalKeyFrames +
    UpdateLocalPoints, Tracking.cc:3478-3560): keyframes sharing
    observations with the previous frame's tracked landmarks, plus their
    covisible neighbors, contribute their landmarks. Restricting the
    stage-2 search to this set is what the reference does — and it is what
    makes a drifted revisit REQUIRE loop closure instead of silently
    re-binding against the whole map. Falls back to the full map when the
    previous frame carries no bindings (fresh chain / after reloc).
    All matmuls; O(K*P)."""
    P, K = m.max_mp, m.max_kf
    prev_ok = prev_mp >= 0
    ind = jnp.zeros(P + 1, jnp.float32).at[
        jnp.where(prev_ok, prev_mp, P)].add(1.0, mode="drop")[:P]
    O = ms.observation_matrix(m)                     # (K, P)
    counts = O @ ind                                 # shared-point counts
    k1 = (counts > 0) & m.kf_valid                   # local keyframes
    if ref_kf is not None:
        # no bindings (fresh chain after a drain/correction): seed from the
        # reference keyframe's neighborhood (the reference re-enters
        # TrackReferenceKeyFrame then rebuilds the local map from it) —
        # NOT from the whole map, which would let a drifted revisit
        # re-bind old regions without a loop closure
        ref_vec = (jnp.zeros(K, bool)
                   .at[jnp.clip(ref_kf, 0, K - 1)].set(ref_kf >= 0))
        k1 = k1 | (ref_vec & ~jnp.any(prev_ok) & m.kf_valid)
    # + covisible neighbors of the local set (GetBestCovisibilityKeyFrames)
    covis = O @ (O.T @ k1.astype(jnp.float32))       # (K,)
    k2 = (covis > 0) & m.kf_valid
    mask = (O.T @ (k1 | k2).astype(jnp.float32)) > 0  # (P,) local points
    has_any = jnp.any(mask)
    return mask | ~has_any                           # empty -> full map


def _two_stage_core(m: ms.MapState, R0, t0, feat_xy, feat_level, feat_desc,
                    feat_valid, u_right, depth, cam_params, bf: float,
                    r_coarse: float, r_fine: float,
                    cam_model: int, img_w: int, img_h: int,
                    n_levels: int, pose_rounds: int, pose_iters: int,
                    prev_mp=None, prev_angle=None, feat_angle=None,
                    local_only: bool = False, lm_mask=None):
    """Two-stage projection search + pose optimization against the map.

    Stage 1 is TrackWithMotionModel (ORBmatcher::SearchByProjection frame ->
    last frame, ORBmatcher.cc:1683): when `prev_mp` (F,) carries the
    landmark ids tracked in the previous frame, only THOSE are searched at
    the coarse radius — a (F, F) problem instead of (P, F); with
    `prev_angle`/`feat_angle` (the previous/current frames' keypoint
    orientations) the rotation-consistency histogram (CheckOrientation,
    ORBmatcher.cc:1792) prunes matches outside the three dominant
    orientation-delta bins. Stage 2 is the TrackLocalMap refinement against
    the map at the fine radius (no orientation check, as in the reference).

    Returns (R, t, mp_feat (P,), inlier_per_mp (P,), n_inliers, visible (P,),
    obs (feature-side PoseObs), feat_tracked (F,), feat_mp_out (F,))."""

    F = feat_xy.shape[0]
    P = m.max_mp
    if lm_mask is None and local_only and prev_mp is not None:
        lm_mask = _local_map_mask(m, prev_mp)

    def one_stage(R, t, radius, rounds, iters, sub_ids=None):
        if sub_ids is None:
            pos, desc, val = m.mp_pos, m.mp_desc, m.mp_valid
            if lm_mask is not None:
                val = val & lm_mask
            normal, mind, maxd = m.mp_normal, m.mp_min_dist, m.mp_max_dist
            ids = None
            n_rows = P
        else:
            idc = jnp.clip(sub_ids, 0, P - 1)
            val = (sub_ids >= 0) & m.mp_valid[idc]
            pos, desc = m.mp_pos[idc], m.mp_desc[idc]
            normal = m.mp_normal[idc]
            mind, maxd = m.mp_min_dist[idc], m.mp_max_dist[idc]
            ids = idc
            n_rows = sub_ids.shape[0]
        pm = matching.search_by_projection(
            pos, desc, val, normal, mind, maxd,
            R, t, cam_params, feat_xy, feat_level, feat_desc,
            feat_valid, radius, cam_model=cam_model, img_w=img_w, img_h=img_h,
            n_levels=n_levels)
        if sub_ids is not None and prev_angle is not None \
                and feat_angle is not None:
            okm = pm.mp_feat >= 0
            keep = matching.rotation_consistency(
                prev_angle, feat_angle[jnp.clip(pm.mp_feat, 0, F - 1)], okm)
            pm = pm._replace(mp_feat=jnp.where(keep, pm.mp_feat, -1))
        # invert the row-side match to the feature side so the LM solve runs
        # over F (~512) observations, not the landmark capacity (~16384)
        matched_mp = pm.mp_feat >= 0
        tgt = jnp.where(matched_mp, pm.mp_feat, F)
        feat_row = jnp.full(F, -1, jnp.int32).at[tgt].set(
            jnp.arange(n_rows, dtype=jnp.int32), mode="drop")
        row_c = jnp.clip(feat_row, 0, n_rows - 1)
        feat_mp = jnp.where(feat_row >= 0,
                            ids[row_c] if ids is not None else row_c, -1)
        has = feat_mp >= 0
        pw = m.mp_pos[jnp.clip(feat_mp, 0, P - 1)]
        obs = PoseObs(
            p_world=pw,
            uv=feat_xy,
            inv_sigma2=_inv_sigma2(feat_level, n_levels),
            u_right=jnp.where(depth > 0, u_right, 0.0),
            is_stereo=has & (depth > 0),
            valid=has,
        )
        R2, t2, inl_f, n_inl = pose_optimization(
            R, t, obs, cam_params, cam_model=cam_model, bf=bf,
            n_rounds=rounds, iters_per_round=iters)
        return R2, t2, pm, feat_mp, inl_f, n_inl, obs

    R1, t1, _, _, _, _, _ = one_stage(R0, t0, r_coarse, pose_rounds,
                                      pose_iters, sub_ids=prev_mp)
    R2, t2, pm, feat_mp, inl_f, n_inl, obs = one_stage(
        R1, t1, r_fine, pose_rounds, pose_iters)
    # landmark-side views of the feature-side result
    f_of_mp = jnp.clip(pm.mp_feat, 0, F - 1)
    inl_mp = (pm.mp_feat >= 0) & inl_f[f_of_mp]
    mp_feat = jnp.where(inl_mp, pm.mp_feat, -1)
    feat_tracked = (feat_mp >= 0) & inl_f
    feat_mp_out = jnp.where(feat_tracked, feat_mp, -1)
    return (R2, t2, mp_feat, inl_mp,
            jnp.sum((mp_feat >= 0).astype(jnp.int32)), pm.visible, obs,
            feat_tracked, feat_mp_out)


@partial(jax.jit, static_argnames=("bf", "r_coarse", "r_fine", "cam_model",
                                   "img_w", "img_h", "n_levels",
                                   "pose_rounds", "pose_iters", "local_only"))
def _track_two_stage(m: ms.MapState, R0, t0, feat_xy, feat_level, feat_desc,
                     feat_valid, u_right, depth, cam_params, bf: float,
                     r_coarse: float, r_fine: float,
                     cam_model: int, img_w: int, img_h: int,
                     n_levels: int, pose_rounds: int, pose_iters: int,
                     prev_mp=None, prev_angle=None, feat_angle=None,
                     local_only: bool = False):
    out = _two_stage_core(m, R0, t0, feat_xy, feat_level, feat_desc,
                          feat_valid, u_right, depth, cam_params, bf,
                          r_coarse, r_fine, cam_model, img_w, img_h,
                          n_levels, pose_rounds, pose_iters,
                          prev_mp=prev_mp, prev_angle=prev_angle,
                          feat_angle=feat_angle, local_only=local_only)
    return out[:7] + (out[8],)   # ... + feat_mp_out (next frame's bindings)


# scalar-pack layout for the fused per-frame step (see _frame_step_stereo):
# [n_valid, n_inliers, n_close_tracked, n_close_untracked, R(9), t(3)] = 16
PACK_LEN = 16


def _frame_body(m: ms.MapState, carry, img_pair, threshold, cam_params,
                cam2_params, R_lr, t_lr, bf, min_z, close_depth, r_coarse,
                r_fine, cam_model, img_w, img_h, n_levels, pose_rounds,
                pose_iters, max_kp, fisheye, sad_refine, local_only=False,
                lm_mask=None):
    """One frame of the stereo tracking hot path: extraction -> stereo match
    (+SAD refine) -> constant-velocity predict -> two-stage track + pose LM
    -> velocity/stat updates. carry = (R, t, R_vel, t_vel, prev_mp,
    prev_angle, mp_visible, mp_found); per-frame outputs (pack, feats, u_r,
    depth, mp_feat) are what the host needs for KF creation and control."""
    (R_prev, t_prev, R_vel, t_vel, prev_mp, prev_angle,
     mp_visible, mp_found) = carry
    want_canvas = sad_refine and not fisheye
    ex = extract_orb_stereo(img_pair, threshold, max_kp=max_kp,
                            n_levels=n_levels, return_canvas=want_canvas)
    feats, canvas = ex if want_canvas else (ex, None)
    if fisheye:
        u_r, depth = matching.match_fisheye_stereo(
            feats.xy[0], feats.desc[0], feats.valid[0],
            feats.xy[1], feats.desc[1], feats.valid[1],
            cam_params, cam2_params, R_lr, t_lr, bf)
    else:
        u_r, depth = matching.match_rectified_stereo(
            feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
            feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
            bf, min_z, n_levels=n_levels)
        if want_canvas:
            u_r, depth = matching.refine_stereo_sad(
                canvas[0], canvas[1], feats.xy[0], feats.level[0],
                feats.valid[0], u_r, depth, bf=bf, min_z=min_z,
                n_levels=n_levels)
    R0, t0 = lie.se3_compose(R_vel, t_vel, R_prev, t_prev)
    (R, t, mp_feat, inl_mp, n_inl, visible, obs,
     feat_tracked, feat_mp_out) = _two_stage_core(
        m, R0, t0, feats.xy[0], feats.level[0], feats.desc[0],
        feats.valid[0], u_r, depth, cam_params, bf, r_coarse, r_fine,
        cam_model, img_w, img_h, n_levels, pose_rounds, pose_iters,
        prev_mp=prev_mp, prev_angle=prev_angle, feat_angle=feats.angle[0],
        local_only=local_only, lm_mask=lm_mask)
    Ri, ti = lie.se3_inverse(R_prev, t_prev)
    R_vel2, t_vel2 = lie.se3_compose(R, t, Ri, ti)
    close = feats.valid[0] & (depth > 0.05) & (depth < close_depth)
    n_close_t = jnp.sum((close & feat_tracked).astype(jnp.float32))
    n_close_u = jnp.sum((close & ~feat_tracked).astype(jnp.float32))
    mp_visible2 = mp_visible + visible.astype(jnp.float32)
    mp_found2 = mp_found + (mp_feat >= 0).astype(jnp.float32)
    pack = jnp.concatenate([
        feats.n_valid[:1].astype(jnp.float32),
        jnp.stack([n_inl.astype(jnp.float32), n_close_t, n_close_u]),
        R.reshape(-1), t])
    carry2 = (R, t, R_vel2, t_vel2, feat_mp_out, feats.angle[0],
              mp_visible2, mp_found2)
    # per-frame outputs: only what keyframe creation needs (left-eye feature
    # set + stereo depth + landmark association)
    ys = (pack, feats.xy[0], feats.level[0], feats.angle[0], feats.desc[0],
          feats.valid[0], u_r, depth, mp_feat)
    return carry2, ys


@partial(jax.jit, static_argnames=(
    "bf", "min_z", "close_depth", "r_coarse", "r_fine", "cam_model",
    "img_w", "img_h", "n_levels", "pose_rounds", "pose_iters", "max_kp",
    "fisheye", "sad_refine", "local_only"))
def _frame_step_chunk(m: ms.MapState, R_prev, t_prev, R_vel, t_vel, prev_mp,
                      prev_angle, imgs, threshold, cam_params, cam2_params,
                      R_lr, t_lr, bf: float, min_z: float,
                      close_depth: float, r_coarse: float, r_fine: float,
                      cam_model: int, img_w: int, img_h: int,
                      n_levels: int, pose_rounds: int, pose_iters: int,
                      max_kp: int, fisheye: bool, sad_refine: bool,
                      local_only: bool = False, ref_kf=None):
    """A CHUNK of frames (C, 2, H, W) as one executable via lax.scan.

    The reference pays one FastRPC crossing per frame
    (orbslam3_extractFeatures, orbslam_dsp.cpp:1017); batching C frames per
    launch amortizes the per-launch and per-sync cost C-fold. The
    pose/velocity/last-frame-landmark chain threads through the scan carry;
    the map is read-only for the chunk (keyframe insertion happens between
    chunks, a <=C-frame lag matching the mapper-thread semantics).
    """
    carry0 = (R_prev, t_prev, R_vel, t_vel, prev_mp, prev_angle,
              m.mp_visible, m.mp_found)
    # the local-map mask is computed ONCE per chunk from the entry bindings
    # (a <=C-frame lag, consistent with the chunk's read-only-map design)
    # instead of per frame inside the scan
    lm_mask = _local_map_mask(m, prev_mp, ref_kf=ref_kf) if local_only \
        else None

    def body(carry, img_pair):
        return _frame_body(m, carry, img_pair, threshold, cam_params,
                           cam2_params, R_lr, t_lr, bf, min_z, close_depth,
                           r_coarse, r_fine, cam_model, img_w, img_h,
                           n_levels, pose_rounds, pose_iters, max_kp,
                           fisheye, sad_refine, local_only=local_only,
                           lm_mask=lm_mask)

    carry, ys = jax.lax.scan(body, carry0, imgs)
    return carry, ys


@jax.jit
def _update_mp_stats(m: ms.MapState, visible, found):
    """found/visible ratio bookkeeping (MapPoint::IncreaseVisible/Found)."""
    return m._replace(
        mp_visible=m.mp_visible + visible.astype(jnp.float32),
        mp_found=m.mp_found + found.astype(jnp.float32),
    )


@partial(jax.jit, static_argnames=("close_depth", "cam_model", "n_levels",
                                   "img_w", "img_h"))
def _insert_kf_and_spawn(m: ms.MapState, R, t, ts, feat_xy, feat_level,
                         feat_desc, feat_valid, u_right, depth, mp_feat,
                         cam_params, close_depth: float, cam_model: int,
                         n_levels: int, v=None, bg=None, ba=None, angle=None,
                         img_w: int = 640, img_h: int = 400, th_far=None):
    """Insert a keyframe; bind tracked landmarks; spawn new close-stereo
    landmarks for unmatched features (CreateNewKeyFrame, Tracking.cc:3277)."""
    F = feat_xy.shape[0]
    # invert mp_feat (P,) -> per-feature landmark assoc (F,); unmatched
    # landmarks scatter to the out-of-bounds slot F and are dropped
    pidx = jnp.arange(m.max_mp, dtype=jnp.int32)
    # mask against the CURRENT map: in pipelined mode mp_feat was computed
    # at dispatch time, so landmarks culled since then must not be re-bound
    tgt = jnp.where((mp_feat >= 0) & m.mp_valid, mp_feat, F)
    assoc = jnp.full(F, -1, jnp.int32).at[tgt].set(pidx, mode="drop")

    # dedupe at insert: re-associate still-unmatched features against the
    # RECENTLY-SPAWNED landmarks before any spawning. Pipelined bindings are
    # up to pipeline+chunk frames stale — landmarks born in flight are
    # invisible to the chunk executable, and spawning "new" points for them
    # floods the map with duplicates, zeroing covisibility between
    # overlapping keyframes. Restricted to landmarks born within the last 8
    # keyframes (the in-flight window): re-binding OLD map regions here
    # would short-circuit the loop-closing path the reference routes
    # drifted revisits through (the reference's CreateNewKeyFrame does no
    # re-association at all).
    recent = m.mp_first_kf >= m.n_kf - 8
    unassoc = feat_valid & (assoc < 0)
    bound = jnp.zeros(m.max_mp + 1, bool).at[
        jnp.where(assoc >= 0, assoc, m.max_mp)].set(True, mode="drop")
    pm = matching.search_by_projection(
        m.mp_pos, m.mp_desc, m.mp_valid & ~bound[:m.max_mp] & recent,
        m.mp_normal,
        m.mp_min_dist, m.mp_max_dist, R, t, cam_params, feat_xy, feat_level,
        feat_desc, unassoc, radius=4.0, cam_model=cam_model, img_w=img_w,
        img_h=img_h, th_desc=matching.TH_LOW, n_levels=n_levels)
    re_ok = pm.mp_feat >= 0
    tgt2 = jnp.where(re_ok, pm.mp_feat, F)
    assoc2 = jnp.full(F, -1, jnp.int32).at[tgt2].set(pidx, mode="drop")
    assoc = jnp.where(assoc >= 0, assoc, assoc2)

    m2, kf_id = ms.insert_keyframe(m, R, t, ts, feat_xy, feat_level, feat_desc,
                                   feat_valid, assoc, depth, v=v, bg=bg, ba=ba,
                                   angle=angle)

    # spawn stereo points for unmatched features: all closer than the
    # close-depth threshold, topped up with the nearest 100 beyond it
    # (CreateNewKeyFrame sorts by depth and keeps >=100, Tracking.cc:3277+)
    cand = feat_valid & (assoc < 0) & (depth > 0.05)
    d_sort = jnp.where(cand, depth, jnp.inf)
    nearest = jax.lax.top_k(-d_sort, min(100, F))[0]
    d100 = -nearest[-1]  # depth of the 100th-nearest candidate
    want = cand & ((depth < close_depth) | (depth <= d100))
    if th_far is not None:
        # thFarPoints: never spawn landmarks beyond the configured depth
        # (System.cc:174-184 "Discard points further than X m")
        want = want & ((th_far <= 0) | (depth < th_far))
    ray = cameras.unproject(cam_model, cam_params, feat_xy)      # z=1 rays
    p_cam = ray * depth[:, None]
    Rwc, c_w = lie.se3_inverse(R, t)
    p_w = lie.se3_apply(Rwc, c_w, p_cam)
    dist = jnp.linalg.norm(p_cam, axis=-1)
    normal = (p_w - c_w) / jnp.maximum(dist[:, None], 1e-9)
    sf = jnp.asarray(scale_factors(n_levels))
    lvl_s = sf[jnp.clip(feat_level, 0, n_levels - 1)]
    max_dist = dist * lvl_s
    min_dist = max_dist / sf[n_levels - 1]
    m3 = ms.spawn_mappoints(m2, kf_id, p_w, feat_desc, normal, min_dist,
                            max_dist, want, jnp.arange(F))
    return m3, kf_id


@partial(jax.jit, static_argnames=("cam_model", "n_levels"))
def _mono_init_map(m: ms.MapState, ts0, ts1, xy0, lvl0, desc0, fv0, ang0,
                   xy1, lvl1, desc1, fv1, ang1, match_idx, tri_ok, R21, t21,
                   p3d, cam_params, cam_model: int, n_levels: int):
    """Create the initial monocular map from a successful two-view
    reconstruction (CreateInitialMapMonocular, Tracking.cc:2604): two
    keyframes, landmarks at the triangulated points, median-depth
    normalization of scale."""
    F = xy0.shape[0]
    med_depth = jnp.median(jnp.where(tri_ok, p3d[:, 2], jnp.nan))
    med_depth = jnp.nan_to_num(med_depth, nan=1.0)
    inv_md = 1.0 / jnp.maximum(med_depth, 1e-6)
    p3d_n = p3d * inv_md
    t21_n = t21 * inv_md

    R0 = jnp.eye(3, dtype=jnp.float32)
    t0 = jnp.zeros(3, jnp.float32)
    m, kf0 = ms.insert_keyframe(m, R0, t0, ts0, xy0, lvl0, desc0, fv0,
                                jnp.full(F, -1, jnp.int32),
                                jnp.zeros(F, jnp.float32), angle=ang0)
    m, kf1 = ms.insert_keyframe(m, R21, t21_n, ts1, xy1, lvl1, desc1, fv1,
                                jnp.full(F, -1, jnp.int32),
                                jnp.zeros(F, jnp.float32), angle=ang1)
    # spawn landmarks bound to kf0 slots
    dist = jnp.linalg.norm(p3d_n, axis=-1)
    normal = p3d_n / jnp.maximum(dist[:, None], 1e-9)
    sf = jnp.asarray(scale_factors(n_levels))
    lvl_s = sf[jnp.clip(lvl0, 0, n_levels - 1)]
    max_dist = dist * lvl_s
    min_dist = max_dist / sf[n_levels - 1]
    m = ms.spawn_mappoints(m, kf0, p3d_n, desc0, normal, min_dist, max_dist,
                           tri_ok, jnp.arange(F))
    # bind second-view observations
    new_ids = m.kf_mp[kf0]
    row1 = m.kf_mp[kf1]
    f1 = jnp.clip(match_idx, 0, F - 1)
    bind = tri_ok & (match_idx >= 0)
    tgt = jnp.where(bind, f1, F)
    row1 = row1.at[tgt].set(jnp.where(bind, new_ids, -1), mode="drop")
    row1 = jnp.where(row1 >= 0, row1, m.kf_mp[kf1])
    m = m._replace(kf_mp=m.kf_mp.at[kf1].set(row1))
    return m, kf1, R21, t21_n


class Tracker:
    """Host-side orchestration of the full SLAM loop (multi-sensor)."""

    PROBE_SLOTS = 8   # fixed probe capacity of the per-burst batched fetch

    def __init__(self, cfg: SlamConfig, sensor: str = "stereo",
                 vocabulary=None, enable_loop_closing: bool = True,
                 enable_timing: bool = False, async_mapping: bool = False,
                 pipeline: int = 0, chunk: int = 1):
        assert sensor in ("stereo", "mono")
        self.cfg = cfg
        self.sensor = sensor
        # pipelined fast path (P1): dispatch `pipeline` fused frame steps
        # ahead of the host control loop, fetching the 16-float scalar packs
        # in one device round trip per burst. 0/1 = fully synchronous.
        self.pipeline = int(pipeline)
        self.chunk = max(1, int(chunk))
        self._img_buf: List = []      # frames awaiting a chunk dispatch
        self._pending: List = []      # in-flight chunk records
        self._chain = None            # device-side (R, t, R_vel, t_vel, ids)
        self._n_kf_host = None        # host mirror of map.n_kf
        self._dev_static = None       # cached device copies of rig constants
        self._dev_tbc = None          # cached (R_bc, t_bc) device arrays
        self._dev_threshold = None    # (host value, device scalar)
        # loop-probe packs awaiting a ride on the next burst's batched
        # fetch: (kf_id, device handle of 16 floats). One device-to-host
        # fetch per burst carries the scalar packs AND every pending probe,
        # so the host syncs once per burst instead of once per result.
        self._probe_unfetched: List = []
        self._burst_no = 0            # dispatch counter (probe aging)
        self._kf_wall: dict = {}      # kf id -> creation wall time (loop
                                      # detection-to-correction latency)
        self._zeros16 = None          # cached device pad for probe slots
        # sync-path previous-frame bindings (feature slot -> landmark id)
        self._prev_feat_mp = None
        self._prev_feat_angle = None
        # stereo rectification (Settings.cc:485 precomputeRectificationMaps):
        # raw distorted stereo input is remapped on device each frame; the
        # EFFECTIVE camera becomes the shared rectified pinhole, the IMU
        # extrinsic rotates with the left eye
        self._rect_maps = None
        self._rect_bounds = None
        if sensor == "stereo" and cfg.stereo.rectify and not cfg.stereo.fisheye:
            from ..config import CameraConfig
            from ..utils.rectify import (remap_bounds, stereo_rectify,
                                         twopass_maps)
            cam2 = cfg.camera2 or cfg.camera
            R_lr, t_lr = cfg.stereo_extrinsics
            rr = stereo_rectify(cfg.camera.params, cam2.params,
                                cfg.camera.model_id, cam2.model_id,
                                R_lr, t_lr, cfg.camera.width,
                                cfg.camera.height)
            # two-pass (Catmull-Smith) maps + static shift bounds: the
            # per-frame remap runs as bounded shift-accumulate passes (pure
            # elementwise arithmetic) instead of a 2-D gather
            mp2 = twopass_maps(rr.maps)
            self._rect_maps = jnp.asarray(mp2)
            self._rect_bounds = remap_bounds(mp2)
            fxn, fyn, cxn, cyn = [float(x) for x in rr.new_params]
            cfg.camera = CameraConfig(model="pinhole", fx=fxn, fy=fyn,
                                      cx=cxn, cy=cyn,
                                      width=cfg.camera.width,
                                      height=cfg.camera.height)
            cfg.camera2 = None
            cfg.stereo.baseline = rr.baseline
            cfg.stereo.R_lr = None
            cfg.stereo.t_lr = None
            R_bc = np.asarray(cfg.imu.R_bc, np.float64).reshape(3, 3)
            cfg.imu.R_bc = tuple(
                (R_bc @ rr.R_rect[0].T).reshape(-1).tolist())
            Verbose.log(f"[tracker] rectification maps ready (f={fxn:.1f}, "
                        f"b={rr.baseline:.4f})")
        mc = cfg.map
        # thFarPoints depth cut (System.cc:174-184): cached device scalar,
        # None = disabled
        self._th_far = (jnp.float32(cfg.tracker.th_far_points)
                        if cfg.tracker.th_far_points > 0 else None)
        self.atlas = Atlas(mc.max_kf, mc.max_mp, cfg.orb.max_kp)
        self.threshold = ThresholdController(
            target=cfg.orb.target_features, band=cfg.orb.threshold_band,
            t0=cfg.orb.fast_threshold)
        self.timer = StageTimer(enabled=enable_timing)
        self.state = NOT_INITIALIZED
        self.pose: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None  # Tcw
        self.vel: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None
        self.frame_id = 0
        self.last_kf_frame = -999
        self.last_kf_id = -1
        self.ref_kf_matches = 0
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.n_inliers_last = 0
        self.cam_params = jnp.asarray(cfg.camera.params)
        self.stats = {"n_kf": 0, "n_frames": 0, "track_fail": 0,
                      "n_reloc": 0, "n_new_maps": 0, "n_loops": 0,
                      "n_map_merges": 0, "n_resets": 0, "n_gba": 0,
                      "n_gba_merged": 0}
        self.lost_since: Optional[float] = None
        # map-relative timestamp origin (float64, host): keyframe timestamps
        # stored in the float32 map tensors are OFFSETS from the first
        # keyframe. Absolute epoch stamps (EuRoC ~1.4e9 s) have ~128 s
        # float32 resolution, which silently defeats the 2 s temporal
        # exclusion gate in loop detection (loop_probe's dts test).
        self._ts_origin: Optional[float] = None
        # mono init state
        self._init_frame = None
        self._init_prev_xy = None    # mvbPrevMatched window anchors
        self._mp_pressure = False    # landmark capacity nearly exhausted
        self._mp_pressure_probe = None  # in-flight async n_mp fetch
        self._compact_backoff = 0    # earliest frame id for the next attempt
        # place recognition + loop closing (lazy: vocabulary may come later)
        self.place_rec = None
        self.loop_closer = None
        self.map_merger = None
        self.enable_loop_closing = enable_loop_closing
        if vocabulary is not None:
            self._setup_place_rec(vocabulary)
        # IMU state
        self.imu_ready = False
        self.imu_bias = (jnp.zeros(3), jnp.zeros(3))
        self.frame_state_v = jnp.zeros(3)
        self._pre_frame = None       # preintegration since last frame
        self._pre_kf = None          # preintegration since last KF
        self._kf_preints: List = []  # per-KF-gap preintegrations for init
        self._kf_times: List[float] = []
        # gap registry for the VI window BA: dst kf id -> (src kf id, pre)
        self._gap_by_dst: dict = {}
        self._prev_note_kf_id: int = -1
        # staged visual-inertial BA schedule (InitializeIMU -> VIBA1 at
        # mTinit>5s -> VIBA2 at >15s, mono scale refinement every 10s from
        # 25s on; LocalMapping.cc:187-248)
        self._imu_init_ts: Optional[float] = None
        self._viba_stage = 0            # 0 = none, 1 = VIBA1 done, 2 = VIBA2
        self._next_scale_ref_ts: Optional[float] = None
        self._last_frame_ts: Optional[float] = None
        # background mapping thread (SURVEY.md §2.4 P2: LocalMapping +
        # LoopClosing run off the tracking thread; the reference serializes
        # tracker-vs-mapper with Map::mMutexMapUpdate — here _map_lock).
        # Device work still overlaps either way via JAX async dispatch; the
        # lock only serializes host-side map-reference read-modify-writes.
        import queue as _queue
        import threading as _threading
        from concurrent.futures import ThreadPoolExecutor
        # dedicated device-to-host fetchers: a result fetch at consume time
        # waits behind every queued computation. Submitting the fetch from a
        # background thread right after dispatch overlaps that wait with the
        # host's dispatching; finalize then checks a LOCAL Future.done()
        # instead of blocking. 4 workers, so back-to-back bursts never
        # serialize behind one in-flight fetch (the count is not tuned for
        # the GPU yet: ROADMAP queue 1).
        self._fetch_pool = ThreadPoolExecutor(max_workers=4)
        self._map_lock = _threading.RLock()
        self._map_queue = None
        self._mapper_thread = None
        self._mapper_stop = False
        self._in_mapper_thread = False
        # dedicated global-BA thread (mpThreadGBA, LoopClosing.cc:1198);
        # spawned by _maybe_start_gba when a loop correction lands and
        # cfg.mapping.async_gba is set
        self._gba_thread = None
        # a finished GBA's result, merged by the tracking thread
        self._gba_result = None
        if async_mapping:
            self._map_queue = _queue.Queue()
            self._mapper_thread = _threading.Thread(
                target=self._mapper_loop, daemon=True)
            self._mapper_thread.start()
        self.anchor_state: Optional[InertialFrameState] = None
        # ConstraintPoseImu marginalization prior: (state, 15x15 H) from the
        # previous frame's inertial solve; None right after a keyframe
        self._inertial_prior = None
        # bad-IMU guard (LocalMapping.cc:140-147 mbBadImu): set by
        # _check_bad_imu when the inertial init phase sees too little
        # motion; consumed at the next frame by an active-map reset
        # (Tracking.cc:1858-1863)
        self._bad_imu = False
        self._kf_centers: List[np.ndarray] = []  # last 3 KF camera centers

    # -- plumbing -----------------------------------------------------------
    def _rel_ts(self, ts: float) -> float:
        """Map-relative timestamp for the float32 map tensors (origin = the
        map's first keyframe, kept float64 on the host)."""
        if self._ts_origin is None:
            self._ts_origin = float(ts)
        return float(ts) - self._ts_origin

    @property
    def map(self) -> ms.MapState:
        return self.atlas.current_map

    @map.setter
    def map(self, m: ms.MapState):
        self.atlas.current_map = m

    @property
    def _tbc(self):
        """Cached device copies of the IMU-from-camera extrinsic."""
        if self._dev_tbc is None:
            self._dev_tbc = (
                jnp.asarray(np.asarray(self.cfg.imu.R_bc,
                                       np.float32).reshape(3, 3)),
                jnp.asarray(np.asarray(self.cfg.imu.t_bc, np.float32)))
        return self._dev_tbc

    def _setup_place_rec(self, voc):
        from ..mapping.loop_closing import LoopCloser, MapMerger
        from .reloc import make_place_recognition
        # the LIVE database is the dense JAX one: add/query stay on device
        # and the loop closer's per-KF probe fuses into one fetch (the
        # native inverted file remains for archived-map queries / parity)
        self.place_rec = make_place_recognition(voc, self.cfg.map.max_kf,
                                                prefer_native=False)
        if self.enable_loop_closing:
            self.loop_closer = LoopCloser(self.cfg, self.place_rec,
                                              fix_scale=self.sensor == "stereo")
            if self.map_merger is None:
                self.map_merger = MapMerger(self.cfg)

    def _compact_map(self) -> bool:
        """Recycle culled keyframe/landmark slots by compaction.

        The reference's heap map grows unbounded (SetBadFlag frees KeyFrame/
        MapPoint objects, KeyFrame.cc); a fixed-capacity tensor map must
        reclaim dead slots or keyframe insertion stops at max_kf. Drains the
        background mapper (queued kf ids would go stale), compacts the map
        tensors, and remaps every host-side keyframe id. Returns True if
        slots were reclaimed."""
        self.wait_mapping_idle()
        # a GBA snapshot carries pre-compaction ids: abort it
        self._abort_gba_and_join()
        with self._map_lock:
            m = self.map
            n_kf_b, n_mp_b = int(m.n_kf), int(m.n_mp)
            m2, kf_new, mp_new = ms.compact_map(m)
            n_kf_a, n_mp_a = int(m2.n_kf), int(m2.n_mp)
            if n_kf_a >= n_kf_b and n_mp_a >= n_mp_b:
                return False
            kf_new_np = np.asarray(kf_new)
            self.map = m2
            self._n_kf_host = n_kf_a
            if 0 <= self.last_kf_id < len(kf_new_np):
                self.last_kf_id = int(kf_new_np[self.last_kf_id])
            # in-flight chunk records / probes carry pre-compaction ids
            self._chain = None
            self._probe_unfetched = []
            if self.loop_closer is not None:
                lc = self.loop_closer
                if 0 <= lc.last_loop_kf < len(kf_new_np):
                    lc.last_loop_kf = int(kf_new_np[lc.last_loop_kf])
                lc.consistent_candidate = -1
                lc.consistency_count = 0
                lc.remap_keyframes(kf_new_np)
            if self.place_rec is not None:
                self._rebuild_place_rec()
            Verbose.log(f"[tracker] compacted map {n_kf_b}->{n_kf_a} KFs, "
                        f"{n_mp_b}->{n_mp_a} MPs")
            return True

    def _rebuild_place_rec(self):
        """Recompute the live BoW database from the current map (after an
        Atlas merge rewrote keyframe slots)."""
        from .reloc import make_place_recognition
        voc = self.place_rec.voc
        db = make_place_recognition(voc, self.cfg.map.max_kf,
                                    prefer_native=False)
        for k in np.flatnonzero(np.asarray(self.map.kf_valid)):
            db.add(int(k), self.map.kf_desc[int(k)], self.map.kf_feat_valid[int(k)])
        self.place_rec = db
        if self.loop_closer is not None:
            self.loop_closer.pr = db

    def _ensure_place_rec(self, desc_bits):
        """Load the pre-trained vocabulary (cfg.map.vocabulary_path, else
        the shipped data/orb_vocab.npz — the reference loads a pre-trained
        binary vocab at startup, CustomVocabulary.h:60 / System.cc:126-130).
        Falls back to a small vocabulary auto-trained from the first
        frame's descriptors only if no file is available."""
        if self.place_rec is not None:
            return
        import os
        from ..models.vocabulary import (DEFAULT_VOCAB_PATH, load_vocabulary,
                                         train_vocabulary)
        path = self.cfg.map.vocabulary_path or DEFAULT_VOCAB_PATH
        if os.path.exists(path):
            voc = load_vocabulary(path)
            Verbose.log(f"[tracker] loaded vocabulary {path} "
                        f"(k={voc.k}, L={voc.depth}, {voc.n_words} words)")
        else:
            d = np.asarray(desc_bits)
            rng = np.random.default_rng(0)
            extra = rng.integers(0, 2, size=(2048, 256)).astype(np.int8)
            voc = train_vocabulary(np.concatenate([d, extra]), k=8, depth=3)
            Verbose.log("[tracker] no vocabulary file: auto-trained "
                        f"{voc.n_words} words from the first frame")
        self._setup_place_rec(voc)

    # -- IMU ----------------------------------------------------------------
    def feed_imu(self, gyro: np.ndarray, acc: np.ndarray, dts: np.ndarray):
        """Queue IMU samples since the previous frame (GrabImuData +
        PreintegrateIMU). Called before process_frame."""
        if not self.cfg.use_imu:
            return
        cfgi = self.cfg.imu
        sg = jnp.float32(cfgi.noise_gyro * np.sqrt(cfgi.freq))
        sa = jnp.float32(cfgi.noise_acc * np.sqrt(cfgi.freq))
        bg, ba = self.imu_bias
        if self._pre_frame is None:
            self._pre_frame = imu_mod.empty_preintegrated(bg, ba)
        if self._pre_kf is None:
            self._pre_kf = imu_mod.empty_preintegrated(bg, ba)
        g = jnp.asarray(gyro, dtype=jnp.float32)
        a = jnp.asarray(acc, dtype=jnp.float32)
        d = jnp.asarray(dts, dtype=jnp.float32)
        v = jnp.ones(len(dts), bool)
        wg = jnp.float32(cfgi.walk_gyro)
        wa = jnp.float32(cfgi.walk_acc)
        self._pre_frame = imu_mod.integrate(self._pre_frame, g, a, d, v,
                                            sg, sa, wg, wa)
        self._pre_kf = imu_mod.integrate(self._pre_kf, g, a, d, v,
                                         sg, sa, wg, wa)

    # -- per-frame entry ----------------------------------------------------
    def process_frame(self, img, ts: float) -> dict:
        """img: (2,H,W) stereo pair or (H,W) mono image."""
        cfg = self.cfg
        # bad-IMU reset (Tracking.cc:1858-1863: "Reset map because local
        # mapper set the bad imu flag")
        if self._bad_imu:
            Verbose.log("[tracker] reset active map: bad IMU flag")
            self._bad_imu = False
            self._drain_pipeline()
            self._reset_active_map()
        # timestamp sanity guards (Tracking.cc:1871-1909): a backwards jump
        # resets the active map; a forward gap > 1 s spawns a new map in the
        # Atlas (inertial chains can't bridge it) or resets a small map.
        if self._last_frame_ts is not None and self.state != NOT_INITIALIZED:
            dt_frame = ts - self._last_frame_ts
            if dt_frame < 0.0:
                Verbose.log("[tracker] timestamp went backwards - map reset")
                self._reset_active_map()
            elif dt_frame > 1.0:
                Verbose.log(f"[tracker] timestamp jump {dt_frame:.2f}s")
                if int(self.map.n_kf) > 10:
                    self._spawn_new_map()
                else:
                    self._reset_active_map()
        self._last_frame_ts = ts
        if img.ndim == 2:
            img = img[None]
        self._merge_gba_result()

        # slot recycling: when keyframe capacity is (nearly) exhausted or
        # landmark spawning hit the cap, compact culled slots away (with a
        # backoff so a genuinely-full map doesn't drain the pipeline every
        # frame retrying a compaction that cannot free anything)
        if self.state == OK and self.frame_id >= self._compact_backoff and \
                (self._mp_pressure or (self._n_kf_host is not None
                                       and self._nkf >= self.map.max_kf - 1)):
            self._mp_pressure = False
            self._drain_pipeline()
            if not self._compact_map():
                self._compact_backoff = self.frame_id + 64

        # pipelined fast path: steady-state stereo tracking only; any other
        # state (init, loss, IMU transitions) drains and runs synchronously
        if (self.pipeline > 1 and self.state == OK and not cfg.use_imu
                and self.sensor == "stereo"):
            return self._process_frame_pipelined(img, ts)
        self._drain_pipeline()

        want_canvas = (self.sensor == "stereo" and cfg.stereo.sad_refine
                       and not cfg.stereo.fisheye)
        with self.timer.stage("extract"):
            img_dev = jnp.asarray(img)
            if self._rect_maps is not None:
                from ..utils.rectify import remap_bilinear_shifts
                img_dev = remap_bilinear_shifts(img_dev.astype(jnp.float32),
                                                self._rect_maps,
                                                *self._rect_bounds)
            ex = extract_orb_stereo(
                img_dev, jnp.float32(self.threshold.t),
                max_kp=cfg.orb.max_kp, n_levels=cfg.orb.n_levels,
                return_canvas=want_canvas)
            feats, canvas = ex if want_canvas else (ex, None)
            jax.block_until_ready(feats.xy)
        if self.sensor == "stereo" and cfg.stereo.fisheye:
            with self.timer.stage("stereo_match"):
                cam2 = cfg.camera2 or cfg.camera
                R_lr, t_lr = cfg.stereo_extrinsics
                u_r, depth = matching.match_fisheye_stereo(
                    feats.xy[0], feats.desc[0], feats.valid[0],
                    feats.xy[1], feats.desc[1], feats.valid[1],
                    self.cam_params, jnp.asarray(cam2.params),
                    jnp.asarray(R_lr), jnp.asarray(t_lr), float(cfg.bf))
        elif self.sensor == "stereo":
            with self.timer.stage("stereo_match"):
                u_r, depth = matching.match_rectified_stereo(
                    feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
                    feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
                    float(cfg.bf), float(cfg.stereo.min_z),
                    n_levels=cfg.orb.n_levels)
                if want_canvas:
                    # sub-pixel SAD refinement (Frame.cc:897-997)
                    u_r, depth = matching.refine_stereo_sad(
                        canvas[0], canvas[1], feats.xy[0], feats.level[0],
                        feats.valid[0], u_r, depth, bf=float(cfg.bf),
                        min_z=float(cfg.stereo.min_z),
                        n_levels=cfg.orb.n_levels)
        else:
            F = cfg.orb.max_kp
            u_r = jnp.full(F, -1.0)
            depth = jnp.zeros(F)
        n_feat = int(feats.n_valid[0])
        self.threshold.update(n_feat)

        # the map-touching section serializes against the mapper thread
        # (the reference's per-frame Map::mMutexMapUpdate, Tracking.cc:1939)
        with self._map_lock:
            if self.state == NOT_INITIALIZED:
                out = self._initialize(feats, u_r, depth, ts, n_feat)
            elif self.state in (OK, RECENTLY_LOST):
                with self.timer.stage("track"):
                    out = self._track(feats, u_r, depth, ts, n_feat)
            else:
                out = {"state": self.state, "n_inliers": 0}

            self.frame_id += 1
            self.stats["n_frames"] += 1
            self._pre_frame = None  # consumed (re-created at next feed_imu)
            if self.pose is not None:
                R, t = self.pose
                self.trajectory.append((ts, np.array(R), np.array(t)))
        return out

    # -- pipelined fast path (SURVEY.md §2.4 P1) -----------------------------
    @property
    def _nkf(self) -> int:
        """Host-side mirror of map.n_kf (avoids a device sync per frame)."""
        if self._n_kf_host is None:
            self._n_kf_host = int(self.map.n_kf)
        return self._n_kf_host

    def _process_frame_pipelined(self, img, ts: float) -> dict:
        """Buffer frames into chunks of `self.chunk`, dispatch each chunk as
        ONE fused lax.scan executable, and consume scalar packs `pipeline`
        frames behind — one small device->host fetch per burst. Control
        decisions (threshold, KF policy, loss) lag by at most
        pipeline+chunk frames, matching the reference's producer/consumer
        frame pipeline + mapper thread semantics (System.cc:356-438)."""
        # start the H2D upload NOW (device_put is async): by dispatch time
        # the 512 KB frame is already on the device, overlapped with the
        # previous chunks' compute, instead of a synchronous
        # jnp.asarray(stack) at dispatch. Already-device
        # frames (zero-copy ingest, the reference's rpcmem/AHB analog) pass
        # through untouched.
        img_dev = img if isinstance(img, jax.Array) \
            else jax.device_put(np.asarray(img))
        self._img_buf.append((img_dev, ts, self.frame_id))
        self.frame_id += 1
        self.stats["n_frames"] += 1
        if len(self._img_buf) >= self.chunk:
            self._dispatch_chunk()
        # consume whatever has RETIRED (pack transfers started at dispatch
        # via copy_to_host_async): zero host blocking in steady state — the
        # host control loop trails the device by however long compute takes,
        # bounded at 2*pipeline frames
        self._finalize_ready()
        return {"state": self.state, "n_inliers": self.n_inliers_last,
                "pipelined": True}

    def _dispatch_chunk(self, pad_to_full: bool = False):
        """Dispatch the buffered frames as one chunk executable. With
        `pad_to_full` (drain), the chunk is padded by repeating the last
        frame; padded outputs are ignored at finalize."""
        cfg = self.cfg
        buf, self._img_buf = self._img_buf, []
        if not buf:
            return
        self._burst_no += 1
        n_real = len(buf)
        imgs = [b[0] for b in buf]
        while len(imgs) < self.chunk:
            imgs.append(imgs[-1])
        with self._map_lock, self.timer.stage("pipeline_dispatch"):
            if self._chain is None:
                R, t = self.pose
                Rv, tv = self.vel
                self._chain = (jnp.asarray(R), jnp.asarray(t),
                               jnp.asarray(Rv), jnp.asarray(tv),
                               jnp.full(cfg.orb.max_kp, -1, jnp.int32),
                               jnp.zeros(cfg.orb.max_kp, jnp.float32))
            if self._dev_static is None:
                cam2 = cfg.camera2 or cfg.camera
                R_lr, t_lr = cfg.stereo_extrinsics
                self._dev_static = (jnp.asarray(cam2.params),
                                    jnp.asarray(R_lr), jnp.asarray(t_lr))
            if self._dev_threshold is None or \
                    self._dev_threshold[0] != self.threshold.t:
                self._dev_threshold = (self.threshold.t,
                                       jnp.float32(self.threshold.t))
            Rp, tp, Rv, tv, prev_mp, prev_ang = self._chain
            cam2_params, R_lr, t_lr = self._dev_static
            # frames were device_put at arrival: stacking is a device op
            self.timer.start("pl_stack")
            imgs_dev = jnp.stack(imgs)
            if self._rect_maps is not None:
                from ..utils.rectify import remap_bilinear_shifts
                imgs_dev = remap_bilinear_shifts(imgs_dev.astype(jnp.float32),
                                                 self._rect_maps,
                                                 *self._rect_bounds)
            self.timer.stop("pl_stack")
            self.timer.start("pl_chunkcall")
            carry, ys = _frame_step_chunk(
                self.map, Rp, tp, Rv, tv, prev_mp, prev_ang,
                imgs_dev,
                self._dev_threshold[1], self.cam_params,
                cam2_params, R_lr, t_lr, bf=float(cfg.bf),
                min_z=float(cfg.stereo.min_z),
                close_depth=float(cfg.stereo.depth_factor * cfg.stereo.baseline),
                r_coarse=float(cfg.tracker.match_radius_coarse),
                r_fine=float(cfg.tracker.match_radius_fine),
                cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
                img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
                pose_rounds=cfg.tracker.pose_rounds,
                pose_iters=cfg.tracker.pose_iters, max_kp=cfg.orb.max_kp,
                fisheye=bool(cfg.stereo.fisheye),
                sad_refine=bool(cfg.stereo.sad_refine),
                local_only=bool(cfg.tracker.local_map_tracking),
                ref_kf=jnp.int32(self.last_kf_id))
            (R, t, Rv2, tv2, feat_mp_out, ang_out, mp_vis2, mp_fnd2) = carry
            self.timer.stop("pl_chunkcall")
            self._chain = (R, t, Rv2, tv2, feat_mp_out, ang_out)
            self.map = self.map._replace(mp_visible=mp_vis2, mp_found=mp_fnd2)
            # ONE batched D2H per burst: the (C,16) scalar packs PLUS every
            # loop-probe pack waiting since the last burst ride a single
            # device-side concatenation, so the host syncs once per burst.
            # The concat is padded to a
            # FIXED slot count so only one concat program ever compiles
            # (variable shapes would each pay a first-use compile inside a
            # measured window).
            self.timer.start("pl_cat")
            probes = self._probe_unfetched[:self.PROBE_SLOTS]
            self._probe_unfetched = self._probe_unfetched[self.PROBE_SLOTS:]
            if self._zeros16 is None:
                self._zeros16 = jnp.zeros(16, jnp.float32)
            pads = [self._zeros16] * (self.PROBE_SLOTS - len(probes))
            fetch_vec = jnp.concatenate(
                [ys[0].reshape(-1)] + [h for (_k, h) in probes] + pads)
            self.timer.stop("pl_cat")
            # record: (ts/fid lists, n_real, pack (C,16), feats, u_r, depth,
            # mp_feat — each with leading chunk dim, probe kid list,
            # fetch future)
            self._pending.append(
                ([b[1] for b in buf], [b[2] for b in buf], n_real) + ys
                + ([k for (k, _h) in probes],
                   self._fetch_pool.submit(np.asarray, fetch_vec)))

    @staticmethod
    def _xfer_done(h) -> bool:
        try:
            return h.is_ready()
        except AttributeError:
            return True

    def _finalize_ready(self):
        """Consume only the chunks/probes whose pack transfer has already
        retired — zero host blocking in steady state. If the in-flight
        backlog exceeds 2*pipeline frames (device slower than the frame
        source), block on the oldest chunks until back within bound."""
        self._finalize_impl(drain=False)

    def _finalize_pending(self):
        """Blocking drain of ALL in-flight chunks and probes."""
        self._finalize_impl(drain=True)

    def _consume_probes(self, probe_list) -> list:
        """Consume fetched loop-probe packs (kid, 16-float vec). Returns the
        list of rigid deltas from any loop corrections (to compose onto
        in-flight frame poses)."""
        deltas = []
        for kid, pv in probe_list:
            # capacity pressure piggybacks on the probe pack (slots 11/12 =
            # n_mp/n_kf, mapper_step_fused) — no dedicated fetch needed
            if len(pv) >= 13 and pv[11] > 0:
                self._mp_pressure = pv[11] >= 0.9 * self.map.max_mp
            n_before = self.loop_closer.n_loops
            self.map = self.loop_closer.on_probe_result(
                self.map, kid, pv, self.cam_params)
            if self.loop_closer.n_loops > n_before:
                self.stats["n_loops"] += 1
                # detection-to-correction latency (KF creation -> corrected)
                if kid in self._kf_wall:
                    self.stats["loop_latency_ms"] = round(
                        (_perf() - self._kf_wall[kid]) * 1e3, 1)
                self._chain = None  # poses moved: restart from map pose
                # the marginalization prior anchors to a PRE-correction
                # absolute pose with full 15x15 information — it must
                # not pull the corrected pose back (ConstraintPoseImu
                # is dropped on map changes in the reference too)
                self._inertial_prior = None
                if not self._in_mapper_thread:
                    self.pose = (self.map.kf_R[kid], self.map.kf_t[kid])
                self._maybe_start_gba()
                # one fetch per ACTUAL loop (correct() recorded the delta
                # device-side) instead of two per probe
                dR, dt = self.loop_closer.last_delta
                deltas.append((np.asarray(dR, np.float64),
                               np.asarray(dt, np.float64)))
        return deltas

    def _split_record(self, rec):
        """Fetch+split one record's batched transfer into (pack (C,16),
        [(kid, probe vec)])."""
        vec = np.asarray(rec[-1].result()).reshape(-1)
        C = rec[3].shape[0]
        # .copy(): fresh writable array (the loop-correction path composes
        # the Sim3 delta in place)
        pack = vec[:C * PACK_LEN].reshape(C, PACK_LEN).copy()
        off = C * PACK_LEN
        pr = [(kid, vec[off + 16 * i: off + 16 * (i + 1)])
              for i, kid in enumerate(rec[-2])]
        return pack, pr

    def _finalize_impl(self, drain: bool):
        if not self._pending and not (drain and self._probe_unfetched):
            return
        with self._map_lock:
            self.timer.start("pipeline_finalize")
            # pop the retired prefix of chunk records (results arrive via
            # the background fetchers — Future.done() is a LOCAL check, no
            # device round trip), plus enough of the oldest ones to keep at
            # most `pipeline` frames in flight — blocking on the oldest
            # chunk is exactly the backpressure we want
            self.timer.start("pl_poll")
            if drain:
                recs, self._pending = self._pending, []
            else:
                recs = []
                while self._pending and self._pending[0][-1].done():
                    recs.append(self._pending.pop(0))
                limit = max(self.pipeline, 1)
                while self._pending and \
                        sum(r[2] for r in self._pending) > limit:
                    recs.append(self._pending.pop(0))
            self.timer.stop("pl_poll")
            if not recs and not (drain and self._probe_unfetched):
                self.timer.stop("pipeline_finalize")
                return

            self.timer.start("pipeline_asarray")
            splits = [self._split_record(r) for r in recs]
            self.timer.stop("pipeline_asarray")

            # lagged loop-closing probes first (each predates its record's
            # frames); a correction moves keyframe poses, so collect each
            # rigid delta to compose onto the in-flight frame poses below
            probe_list = [p for (_pk, ps) in splits for p in ps]
            if drain and self._probe_unfetched:
                # probes with no burst left to ride: fetch directly
                left, self._probe_unfetched = self._probe_unfetched, []
                probe_list += [(k, np.asarray(h).reshape(-1))
                               for (k, h) in left]
            deltas = self._consume_probes(probe_list)
            if deltas and self._pending:
                # frames still in flight were tracked against the
                # pre-correction world: take everything and compose the
                # delta (CorrectLoop's mlRelativeFramePoses treatment,
                # LoopClosing.cc:969+)
                more, self._pending = self._pending, []
                more_splits = [self._split_record(r) for r in more]
                deltas += self._consume_probes(
                    [p for (_pk, ps) in more_splits for p in ps])
                recs += more
                splits += more_splits
            if not recs:
                self.timer.stop("pipeline_finalize")
                return
            pack_vals = np.concatenate([pk for (pk, _ps) in splits])
            real = np.concatenate([
                (np.arange(r[3].shape[0]) < r[2]) for r in recs])
            # ONE controller step per batch: the batch's frames all saw the
            # same threshold; per-frame updates would step the feedback loop
            # K times on stale data and oscillate it into collapse
            if real.any():
                self.threshold.update(int(np.median(pack_vals[real, 0])))
                Verbose.log(f"[thctl] median_feat="
                            f"{int(np.median(pack_vals[real, 0]))} -> "
                            f"th={self.threshold.t:.1f}", lvl=2)
            for dR, dt in deltas:
                for row_v in pack_vals:
                    Rf = row_v[4:13].reshape(3, 3).astype(np.float64)
                    tf = row_v[13:16].astype(np.float64)
                    row_v[4:13] = (Rf @ dR).reshape(-1)
                    row_v[13:16] = Rf @ dt + tf
            self.timer.start("pl_consume")
            prev_pose = None
            row = 0
            lost = False
            for rec in recs:
                C = rec[3].shape[0]
                for c in range(rec[2]):          # real frames only
                    ok = self._consume_record(rec, c, pack_vals[row + c],
                                              prev_pose)
                    if not ok:
                        lost = True
                        break
                    v = pack_vals[row + c]
                    prev_pose = (v[4:13].reshape(3, 3), v[13:16])
                row += C
                if lost:
                    break
            if lost:
                # drop EVERYTHING still in flight (reference frame drops on
                # backpressure); the loss path re-seeds from the map pose
                self._pending = []
            self.timer.stop("pl_consume")
            self.timer.stop("pipeline_finalize")

    def _consume_record(self, rec, c, v, prev_pose) -> bool:
        """Host policy for one lagged frame (frame `c` of chunk record
        `rec`). Returns False on tracking loss (remaining burst frames are
        dropped, like the reference's frame drops on backpressure)."""
        ts, fid = rec[0][c], rec[1][c]
        cfg = self.cfg
        n_valid, n_inl = int(v[0]), int(v[1])
        n_close_t, n_close_u = int(v[2]), int(v[3])
        Verbose.log(f"[frame {fid}] feat={n_valid} inl={n_inl} "
                    f"closeT={n_close_t} closeU={n_close_u} "
                    f"th={self.threshold.t:.1f}", lvl=2)
        R = v[4:13].reshape(3, 3).astype(np.float32)
        t = v[13:16].astype(np.float32)
        if n_inl < cfg.tracker.min_inliers:
            self.stats["track_fail"] += 1
            self.state = RECENTLY_LOST
            self.lost_since = ts
            self.vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
            self._chain = None
            self._img_buf = []
            Verbose.log(f"[tracker] lost in pipelined burst ({n_inl} inliers)")
            return False
        # keep pose/vel host-side here: this runs once per consumed frame
        # and the values are only re-uploaded at a chain re-seed, so
        # per-frame device_puts would buy nothing
        self.pose = (R, t)
        if prev_pose is not None:
            Rp, tp = prev_pose
            Rv = R @ Rp.T
            self.vel = (Rv.astype(np.float32),
                        (t - Rv @ tp).astype(np.float32))
        self.trajectory.append((ts, R, t))
        self.n_inliers_last = n_inl
        if self._need_new_keyframe_scalars(n_inl, n_close_t, n_close_u, fid):
            with self.timer.stage("keyframe"):
                self._create_keyframe_from_record(rec, c, R, t, n_inl)
        return True

    def _probe_mp_pressure(self):
        """Landmark-capacity pressure probe WITHOUT a device sync: resolve
        the probe issued ~8 KFs ago (its D2H transfer finished long ago) and
        start a fresh async fetch of n_mp. The 90%-capacity threshold
        absorbs the 8-KF lag."""
        prev = self._mp_pressure_probe
        if prev is not None:
            self._mp_pressure = int(prev.result()) >= 0.9 * self.map.max_mp
        self._mp_pressure_probe = self._fetch_pool.submit(
            np.asarray, self.map.n_mp)

    def _need_new_keyframe_scalars(self, n_inliers, n_close_tracked,
                                   n_close_untracked, frame_id) -> bool:
        """NeedNewKeyFrame (Tracking.cc:3125) from pre-reduced scalars."""
        cfg = self.cfg
        if self._nkf >= self.map.max_kf - 1:
            return False
        # mapper-idle condition (Tracking.cc:3125: c1b requires
        # bLocalMappingIdle; a busy mapper only accepts a stereo keyframe
        # when its queue is short) — prevents KF spam under mapper backlog
        queue = self._map_queue
        mapper_idle = queue is None or queue.unfinished_tasks == 0
        frames_since = frame_id - self.last_kf_frame
        c1a = frames_since >= cfg.tracker.max_frames_between_kf
        c1b = frames_since >= max(cfg.tracker.min_frames_between_kf, 1) \
            and mapper_idle
        c1c = self.sensor == "stereo" and \
            (n_close_tracked < cfg.tracker.close_tracked_th
             and n_close_untracked > cfg.tracker.close_untracked_th)
        ratio = cfg.tracker.kf_ref_ratio if self.sensor == "stereo" else 0.9
        c2 = (n_inliers < ratio * max(self.ref_kf_matches, 1)
              and n_inliers > 15)
        want = bool(((c1a or c1b or c1c) and c2) or (c1c and c1b))
        if want and not mapper_idle and self.sensor == "stereo":
            # stereo path under load: accept only with a short queue
            # (Tracking.cc: KeyframesInQueue() < 3)
            want = queue.unfinished_tasks < 3
        return want

    def _create_keyframe_from_record(self, rec, c, R, t, n_inl):
        ts, fid = rec[0][c], rec[1][c]
        xy0, lvl0, ang0, desc0, val0, u_r, depth, mp_feat = rec[4:12]
        cfg = self.cfg
        kid = self._nkf
        self.map, _ = _insert_kf_and_spawn(
            self.map, jnp.asarray(R), jnp.asarray(t),
            jnp.float32(self._rel_ts(ts)),
            xy0[c], lvl0[c], desc0[c], val0[c], u_r[c], depth[c],
            mp_feat[c], self.cam_params,
            float(cfg.stereo.depth_factor * cfg.stereo.baseline),
            cam_model=cfg.camera.model_id, n_levels=cfg.orb.n_levels,
            angle=ang0[c], img_w=cfg.camera.width, img_h=cfg.camera.height,
            th_far=self._th_far)
        self._n_kf_host = kid + 1
        self.last_kf_frame = fid
        self.last_kf_id = kid
        self.ref_kf_matches = max(n_inl, 1)
        self.stats["n_kf"] += 1
        self._kf_wall[kid] = _perf()
        if kid % 8 == 0:
            self._probe_mp_pressure()
        if self._map_queue is not None:
            if self.loop_closer is not None:
                self.loop_closer.abort_gba = True
            self._map_queue.put(kid)
        else:
            self._mapping_pipeline(kid, lagged_loops=True)

    def _drain_pipeline(self):
        """Flush in-flight pipelined frames before any synchronous logic."""
        if self._img_buf:
            self._dispatch_chunk(pad_to_full=True)
        if self._pending or self._probe_unfetched:
            self._finalize_pending()
        self._chain = None

    def finish(self):
        """Flush the pipeline and wait for background mapping (call at end
        of a sequence before reading trajectories)."""
        self._drain_pipeline()
        self.wait_mapping_idle()
        self.wait_gba()

    # -- initialization -----------------------------------------------------
    def _initialize(self, feats: Features, u_r, depth, ts, n_feat) -> dict:
        if self.sensor == "stereo":
            return self._initialize_stereo(feats, u_r, depth, ts, n_feat)
        return self._initialize_mono(feats, ts, n_feat)

    def _initialize_stereo(self, feats, u_r, depth, ts, n_feat) -> dict:
        cfg = self.cfg
        # init gate scaled to the regulated feature budget: the reference's
        # 500 (Tracking.cc:2393) assumes a ~1000-feature budget; with the
        # threshold controller holding the count at target_features +- band,
        # an absolute 500 would be unreachable after a mid-sequence map
        # respawn and recovery would deadlock in NOT_INITIALIZED forever
        gate = min(cfg.tracker.min_init_features,
                   max(50, round(0.5 * cfg.orb.target_features)))
        if n_feat < gate:
            return {"state": self.state, "n_inliers": 0}
        R = jnp.eye(3, dtype=jnp.float32)
        t = jnp.zeros(3, dtype=jnp.float32)
        mp_feat0 = jnp.full(self.map.max_mp, -1, jnp.int32)
        # at initialization every positive-depth feature becomes a landmark
        # (StereoInitialization, Tracking.cc:2391: all z>0 points)
        self.map, kf_id = _insert_kf_and_spawn(
            self.map, R, t, jnp.float32(self._rel_ts(ts)), feats.xy[0],
            feats.level[0],
            feats.desc[0], feats.valid[0], u_r, depth, mp_feat0,
            self.cam_params, 1e9,
            cam_model=cfg.camera.model_id, n_levels=cfg.orb.n_levels,
            angle=feats.angle[0], img_w=cfg.camera.width,
            img_h=cfg.camera.height, th_far=self._th_far)
        self._post_init(kf_id, int(self.map.n_mp), ts, feats)
        return {"state": OK, "n_inliers": int(self.map.n_mp), "init": True}

    def _initialize_mono(self, feats, ts, n_feat) -> dict:
        cfg = self.cfg
        if n_feat < 100:
            self._init_frame = None
            return {"state": self.state, "n_inliers": 0}
        cur = (jnp.float32(self._rel_ts(ts)), feats.xy[0], feats.level[0],
               feats.desc[0], feats.valid[0], feats.angle[0])
        if self._init_frame is None:
            self._init_frame = cur
            # mvbPrevMatched (Tracking.cc:2519): the window-search anchor
            # positions, updated to the latest matched location each attempt
            # so the search window tracks feature motion while the reference
            # frame (and thus the stereo baseline) keeps GROWING until the
            # reconstruction passes the parallax gate
            self._init_prev_xy = feats.xy[0]
            return {"state": self.state, "n_inliers": 0}

        ts0, xy0, lvl0, desc0, fv0, ang0 = self._init_frame
        # SearchForInitialization: 100 px window around the last matched
        # positions + ratio 0.9 + rotation histogram (ORBmatcher.cc:649,
        # Tracking.cc:2548-2556)
        idx, ok = matching.match_for_initialization(
            self._init_prev_xy, desc0, fv0, ang0, feats.xy[0], feats.desc[0],
            feats.valid[0], feats.angle[0], window=100.0, th=50.0, ratio=0.9)
        if int(jnp.sum(ok)) < 100:   # Tracking.cc:2548: >=100 matches
            # reference deletes the initializer and restarts from the
            # current frame (Tracking.cc:2560)
            self._init_frame = cur
            self._init_prev_xy = feats.xy[0]
            return {"state": self.state, "n_inliers": 0}
        # track the matched positions for the next attempt's window
        F0 = self._init_prev_xy.shape[0]
        matched_xy = feats.xy[0][jnp.clip(idx, 0, F0 - 1)]
        self._init_prev_xy = jnp.where(ok[:, None], matched_xy,
                                       self._init_prev_xy)
        F = xy0.shape[0]
        uv1 = xy0
        uv2 = feats.xy[0][jnp.clip(idx, 0, F - 1)]
        from ..mapping.twoview import reconstruct_two_views
        out = reconstruct_two_views(uv1, uv2, ok, self.cam_params)
        if not bool(out["success"]):
            return {"state": self.state, "n_inliers": 0}

        self.map, kf1, R, t = _mono_init_map(
            self.map, ts0, jnp.float32(self._rel_ts(ts)), xy0, lvl0, desc0,
            fv0, ang0,
            feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
            feats.angle[0], idx, out["tri_ok"] & ok, out["R"], out["t"],
            out["p3d"], self.cam_params, cam_model=cfg.camera.model_id,
            n_levels=cfg.orb.n_levels)
        self.pose = (R, t)
        n_mp = int(self.map.n_mp)
        self._post_init(kf1, n_mp, ts, feats)
        # full BA over the initial two keyframes (GlobalBundleAdjustemnt(20))
        ids = np.full(cfg.ba.window_size + cfg.ba.n_fixed, -1, np.int32)
        ids[0], ids[1] = 0, 1
        fixed = np.zeros(len(ids), bool)
        fixed[0] = True
        self.map = _local_ba(self.map, jnp.asarray(ids), jnp.asarray(fixed),
                             self.cam_params, float(cfg.bf),
                             cam_model=cfg.camera.model_id,
                             n_ba_points=cfg.ba.max_points, n_iters=20)
        self.pose = (self.map.kf_R[int(kf1)], self.map.kf_t[int(kf1)])
        self._init_frame = None
        return {"state": OK, "n_inliers": n_mp, "init": True}

    def _post_init(self, kf_id, n_mp, ts, feats):
        self._n_kf_host = int(self.map.n_kf)
        if self.pose is None:
            self.pose = (jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
        self.vel = (jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
        self.state = OK
        self.last_kf_frame = self.frame_id
        self.last_kf_id = int(kf_id)
        self.ref_kf_matches = n_mp
        self.stats["n_kf"] += 1
        self.lost_since = None
        self._ensure_place_rec(feats.desc[0])
        self.place_rec.add(int(kf_id), self.map.kf_desc[int(kf_id)],
                           self.map.kf_feat_valid[int(kf_id)])
        self._note_kf_imu(ts)

    # -- per-frame tracking -------------------------------------------------
    def _predict_pose(self):
        R_last, t_last = self.pose
        if self.cfg.use_imu and self.imu_ready and self._pre_frame is not None \
                and float(self._pre_frame.dt) > 0:
            bg, ba = self.imu_bias
            R_bc, t_bc = self._tbc
            Rwb, p_b = imu_mod.body_from_cam(R_last, t_last, R_bc, t_bc)
            R2, v2, p2 = imu_mod.predict_state(Rwb, self.frame_state_v, p_b,
                                               self._pre_frame, bg, ba)
            Rcw, tcw = imu_mod.cam_from_body(R2, p2, R_bc, t_bc)
            return Rcw, tcw, v2
        Rv, tv = self.vel
        R0, t0 = lie.se3_compose(Rv, tv, R_last, t_last)
        return R0, t0, self.frame_state_v

    def _track(self, feats: Features, u_r, depth, ts, n_feat) -> dict:
        cfg = self.cfg
        R_last, t_last = self.pose
        R0, t0, v_pred = self._predict_pose()

        # previous frame's bindings drive TrackWithMotionModel's stage-1
        # restriction and the local-map mask (None right after init/reloc:
        # both stages then search the whole map once to seed the chain)
        prev = self._prev_feat_mp if cfg.tracker.local_map_tracking else None
        prev_ang = self._prev_feat_angle if prev is not None else None
        R, t, mp_feat, inl, n_inl, visible, obs, feat_mp_out = \
            _track_two_stage(
                self.map, R0, t0, feats.xy[0], feats.level[0], feats.desc[0],
                feats.valid[0], u_r, depth, self.cam_params, float(cfg.bf),
                float(cfg.tracker.match_radius_coarse),
                float(cfg.tracker.match_radius_fine),
                cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
                img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
                pose_rounds=cfg.tracker.pose_rounds,
                pose_iters=cfg.tracker.pose_iters,
                prev_mp=prev, prev_angle=prev_ang,
                feat_angle=feats.angle[0] if prev is not None else None,
                local_only=bool(cfg.tracker.local_map_tracking))
        n_inliers = int(n_inl)
        self.map = _update_mp_stats(self.map, visible, mp_feat >= 0)

        # visual-inertial refinement (PoseInertialOptimizationLastFrame)
        if self.cfg.use_imu and self.imu_ready and self.anchor_state is not None \
                and self._pre_frame is not None and float(self._pre_frame.dt) > 0 \
                and n_inliers >= cfg.tracker.min_inliers:
            bg, ba = self.imu_bias
            cur = InertialFrameState(R=R, t=t, v=v_pred, bg=bg, ba=ba)
            R_bc, t_bc = self._tbc
            # ConstraintPoseImu chain (Optimizer.cc:4918): frames after the
            # last keyframe carry the previous frame's marginalized
            # information as a prior; the chain resets at each keyframe
            prior = self._inertial_prior
            if prior is not None:
                from .inertial_opt import pose_inertial_optimization_last_frame
                st, inl_m, n2, H_marg = pose_inertial_optimization_last_frame(
                    cur, prior[0], prior[1], self._pre_frame, obs,
                    self.cam_params, cam_model=cfg.camera.model_id,
                    bf=float(cfg.bf), R_bc=R_bc, t_bc=t_bc)
            else:
                st, inl_m, n2, H_marg = pose_inertial_optimization(
                    cur, self.anchor_state, self._pre_frame, obs,
                    self.cam_params, cam_model=cfg.camera.model_id,
                    bf=float(cfg.bf), R_bc=R_bc, t_bc=t_bc)
            R, t = st.R, st.t
            self.frame_state_v = st.v
            self.imu_bias = (st.bg, st.ba)
            self._inertial_prior = (st, H_marg)
            n_inliers = max(n_inliers, int(n2))
        else:
            # finite-difference velocity estimate for the IMU state
            Rwb, p_w = lie.se3_inverse(R, t)
            Rwb_l, p_l = lie.se3_inverse(R_last, t_last)
            dt_f = max(ts - (self.trajectory[-1][0] if self.trajectory else ts - 0.05), 1e-3)
            self.frame_state_v = (p_w - p_l) / dt_f

        min_inl = cfg.tracker.min_inliers
        if n_inliers < min_inl and self.last_kf_id >= 0:
            # TrackReferenceKeyFrame fallback (Tracking.cc:2778): re-seed
            # from the reference KF's landmarks, then re-run the two-stage
            # local-map track from the recovered pose
            from .reloc import track_reference_kf
            R_ref, t_ref, n_ref = track_reference_kf(
                self.map, jnp.int32(self.last_kf_id), R_last, t_last,
                feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
                feats.angle[0], u_r, depth, self.cam_params,
                cam_model=cfg.camera.model_id, bf=float(cfg.bf),
                n_levels=cfg.orb.n_levels)
            if int(n_ref) >= min_inl:
                Verbose.log(f"[tracker] ref-KF fallback ({int(n_ref)} inliers)")
                (R, t, mp_feat, inl, n_inl, visible, obs,
                 feat_mp_out) = _track_two_stage(
                    self.map, R_ref, t_ref, feats.xy[0], feats.level[0],
                    feats.desc[0], feats.valid[0], u_r, depth,
                    self.cam_params, float(cfg.bf),
                    float(cfg.tracker.match_radius_coarse),
                    float(cfg.tracker.match_radius_fine),
                    cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
                    img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
                    pose_rounds=cfg.tracker.pose_rounds,
                    pose_iters=cfg.tracker.pose_iters)
                n_inliers = int(n_inl)
        if n_inliers < min_inl:
            return self._handle_loss(feats, ts, u_r=u_r, depth=depth,
                                     pred_pose=(R0, t0))

        if self.state == RECENTLY_LOST:
            Verbose.log(f"[tracker] recovered with {n_inliers} inliers")
        self.state = OK
        self.lost_since = None
        # velocity model update (Tcw_cur * Twc_last)
        Ri, ti = lie.se3_inverse(R_last, t_last)
        self.vel = lie.se3_compose(R, t, Ri, ti)
        self.pose = (R, t)
        self.n_inliers_last = n_inliers
        # bindings feed the next frame's motion-model stage + local map
        self._prev_feat_mp = feat_mp_out
        self._prev_feat_angle = feats.angle[0]
        # update inertial anchor every frame when IMU is live
        if self.cfg.use_imu and self.imu_ready:
            bg, ba = self.imu_bias
            self.anchor_state = InertialFrameState(
                R=R, t=t, v=self.frame_state_v, bg=bg, ba=ba)
            self._pre_frame = None

        made_kf = False
        if self._need_new_keyframe(n_inliers, feats, mp_feat, depth, ts):
            with self.timer.stage("keyframe"):
                self._create_keyframe(feats, u_r, depth, mp_feat, ts, n_inliers)
            made_kf = True
        return {"state": OK, "n_inliers": n_inliers, "kf": made_kf}

    # -- loss handling (Tracking.cc:2034-2076) ------------------------------
    def _handle_loss(self, feats: Features, ts: float, u_r=None, depth=None,
                     pred_pose=None) -> dict:
        cfg = self.cfg
        self.stats["track_fail"] += 1
        # the failed frame's bindings are garbage: the next attempt searches
        # the whole map (local-map fallback) like the reference's reloc
        self._prev_feat_mp = None
        if self.state == OK:
            self.state = RECENTLY_LOST
            self.lost_since = ts
            Verbose.log("[tracker] tracking lost, RECENTLY_LOST")
        # try relocalization against the keyframe database, with the
        # reference's candidate gating (DetectRelocalizationCandidates:
        # common-words ratio + covisibility-accumulated scores) when the
        # dense database exposes its arrays; plain top-3 otherwise
        n_rel = 0
        if self.place_rec is not None:
            from .reloc import (PlaceRecognition, detect_reloc_candidates,
                                relocalize_against_kf)
            if isinstance(self.place_rec, PlaceRecognition):
                from ..models.vocabulary import bow_from_descriptors
                q = bow_from_descriptors(self.place_rec.voc, feats.desc[0],
                                         feats.valid[0])
                ids, scores = detect_reloc_candidates(
                    self.map, self.place_rec.bow_db, self.place_rec.active, q)
            else:
                ids, scores = self.place_rec.query(
                    feats.desc[0], feats.valid[0], n_best=3)
            kf_valid_np = np.asarray(self.map.kf_valid)
            for k in np.asarray(ids):
                k = int(k)
                # culled keyframes carry stale poses: never relocalize
                # against them (KeyFrameDatabase::erase semantics)
                if k < 0 or not kf_valid_np[k]:
                    continue
                R, t, n_inl = relocalize_against_kf(
                    self.map, jnp.int32(k),
                    feats.xy[0], feats.level[0], feats.desc[0],
                    feats.valid[0], feats.angle[0],
                    self.cam_params, cam_model=cfg.camera.model_id,
                    img_w=cfg.camera.width, img_h=cfg.camera.height,
                    n_levels=cfg.orb.n_levels)
                n_rel = int(n_inl)
                if n_rel >= 50:   # reference: nGood >= 50 post-refine
                    self.pose = (R, t)
                    self.vel = (jnp.eye(3, dtype=jnp.float32),
                                jnp.zeros(3, jnp.float32))
                    # prior predates the pose discontinuity: drop it
                    self._inertial_prior = None
                    self.state = OK
                    self.lost_since = None
                    self.stats["n_reloc"] += 1
                    Verbose.log(f"[tracker] relocalized ({n_rel} inliers)")
                    return {"state": OK, "n_inliers": n_rel, "reloc": True}
        # inertial dead-reckoning while RECENTLY_LOST (Tracking.cc:2042:
        # PredictStateIMU keeps the published pose alive): the IMU-predicted
        # pose stands in for the visual one, and — when insertKFsWhenLost is
        # set (Tracking.cc:2304) — keyframes keep flowing every 0.25 s so the
        # preintegration chain bridges the visual gap until reloc/merge
        if (cfg.use_imu and self.imu_ready and self.state == RECENTLY_LOST
                and pred_pose is not None):
            self.pose = pred_pose
            if (cfg.tracker.insert_kfs_when_lost and u_r is not None
                    and self._kf_times
                    and ts - self._kf_times[-1] >= 0.25
                    and self._nkf < self.map.max_kf - 1):
                mp_none = jnp.full(self.map.max_mp, -1, jnp.int32)
                with self.timer.stage("keyframe"):
                    self._create_keyframe(feats, u_r, depth, mp_none, ts, 1)
                Verbose.log("[tracker] inserted KF while RECENTLY_LOST "
                            "(insertKFsWhenLost)")
        # timeout -> LOST -> new map (CreateMapInAtlas) if map is big enough
        if self.lost_since is not None and ts - self.lost_since > 5.0:
            if int(self.map.n_kf) > 10:
                self._spawn_new_map()
            else:
                self._reset_tracking_state()
        return {"state": self.state, "n_inliers": 0}

    def _reset_tracking_state(self):
        """Return the tracker to NOT_INITIALIZED (shared by loss timeout,
        timestamp guards and map resets)."""
        self.state = NOT_INITIALIZED
        self.pose = None
        self._init_frame = None
        self.lost_since = None
        self._n_kf_host = None
        self._chain = None
        self.last_kf_id = -1
        self.last_kf_frame = -999
        self.ref_kf_matches = 0
        self.imu_ready = False
        if self.loop_closer is not None:
            self.loop_closer.inertial = False
        if self.map_merger is not None:
            self.map_merger.inertial = False
        self._imu_init_ts = None
        self._viba_stage = 0
        self._next_scale_ref_ts = None
        self._kf_preints, self._kf_times = [], []
        self._gap_by_dst, self._prev_note_kf_id = {}, -1
        self._inertial_prior = None
        self._ts_origin = None
        self._bad_imu = False
        self._kf_centers = []
        self._prev_feat_mp = None
        self._prev_feat_angle = None

    def _spawn_new_map(self):
        """CreateMapInAtlas (Tracking.cc:2720): retire the current map +
        its BoW database (for later merge-back) and start a fresh one."""
        self._abort_gba_and_join()   # GBA snapshot belongs to the old map
        # retire the current map's BoW database into the merger so
        # the new map can later be merged back (MergeLocal detection)
        if self.map_merger is not None and self.place_rec is not None:
            self.map_merger.archive(self.atlas.current, self.place_rec,
                                    gaps=dict(self._gap_by_dst))
        self.atlas.create_new_map()
        self.stats["n_new_maps"] += 1
        if self.place_rec is not None:
            from .reloc import make_place_recognition
            self.place_rec = make_place_recognition(
                self.place_rec.voc, self.cfg.map.max_kf, prefer_native=False)
            if self.loop_closer is not None:
                from ..mapping.loop_closing import LoopCloser
                n_loops = self.loop_closer.n_loops
                self.loop_closer = LoopCloser(self.cfg, self.place_rec,
                                              fix_scale=self.sensor == "stereo")
                self.loop_closer.n_loops = n_loops
        Verbose.log("[tracker] spawning new map in atlas")
        self._reset_tracking_state()

    def _reset_active_map(self):
        """ResetActiveMap (Tracking.cc): clear the current map in place."""
        self._abort_gba_and_join()   # GBA snapshot belongs to the old map
        self.stats["n_resets"] += 1
        self.atlas.current_map = ms.empty_map(
            self.cfg.map.max_kf, self.cfg.map.max_mp, self.cfg.orb.max_kp)
        if self.place_rec is not None:
            from .reloc import make_place_recognition
            self.place_rec = make_place_recognition(
                self.place_rec.voc, self.cfg.map.max_kf, prefer_native=False)
            if self.loop_closer is not None:
                from ..mapping.loop_closing import LoopCloser
                n_loops = self.loop_closer.n_loops
                self.loop_closer = LoopCloser(self.cfg, self.place_rec,
                                              fix_scale=self.sensor == "stereo")
                self.loop_closer.n_loops = n_loops
        self._reset_tracking_state()

    # -- keyframe policy (NeedNewKeyFrame, Tracking.cc:3125) ----------------
    def _need_new_keyframe(self, n_inliers, feats: Features, mp_feat, depth,
                           ts: float) -> bool:
        cfg = self.cfg
        if self._nkf >= self.map.max_kf - 1:
            return False
        # c3: inertial maps need dense keyframes — every 0.25 s before IMU
        # init, 0.5 s after (Tracking.cc:3125 pre-init clause + c3)
        if self.cfg.use_imu and self._kf_times:
            gap = ts - self._kf_times[-1]
            if (not self.imu_ready and gap >= 0.25) or \
                    (self.imu_ready and gap >= 0.5):
                return True
        close_th = cfg.stereo.depth_factor * cfg.stereo.baseline
        f_of_mp = np.asarray(mp_feat)
        tracked_slots = np.unique(f_of_mp[f_of_mp >= 0])
        d = np.asarray(depth)
        valid = np.asarray(feats.valid[0])
        close = valid & (d > 0.05) & (d < close_th)
        tracked_mask = np.zeros_like(valid)
        tracked_mask[tracked_slots] = True
        n_close_tracked = int((close & tracked_mask).sum())
        n_close_untracked = int((close & ~tracked_mask).sum())
        return self._need_new_keyframe_scalars(
            n_inliers, n_close_tracked, n_close_untracked, self.frame_id)

    # -- keyframe creation + local mapping ----------------------------------
    def _create_keyframe(self, feats: Features, u_r, depth, mp_feat, ts,
                         n_inliers):
        cfg = self.cfg
        R, t = self.pose
        close_depth = float(cfg.stereo.depth_factor * cfg.stereo.baseline)
        if self.sensor == "mono":
            close_depth = -1.0  # no depth spawning
        bg_, ba_ = self.imu_bias
        self.map, kf_id = _insert_kf_and_spawn(
            self.map, R, t, jnp.float32(self._rel_ts(ts)), feats.xy[0],
            feats.level[0],
            feats.desc[0], feats.valid[0], u_r, depth, mp_feat,
            self.cam_params, close_depth, cam_model=cfg.camera.model_id,
            n_levels=cfg.orb.n_levels, v=jnp.asarray(self.frame_state_v),
            bg=jnp.asarray(bg_), ba=jnp.asarray(ba_), angle=feats.angle[0],
            img_w=cfg.camera.width, img_h=cfg.camera.height,
            th_far=self._th_far)
        self.last_kf_frame = self.frame_id
        self.last_kf_id = int(kf_id)
        self.ref_kf_matches = max(n_inliers, 1)
        self.stats["n_kf"] += 1
        kid = int(kf_id)
        self._kf_wall[kid] = _perf()
        if kid >= 0:
            self._n_kf_host = kid + 1
        if kid >= 0 and kid % 8 == 0:
            self._probe_mp_pressure()
        self._note_kf_imu(ts)

        if self._map_queue is not None:
            # background LocalMapping/LoopClosing thread (SURVEY.md §2.4 P2):
            # in inline-GBA mode a running GBA blocks the mapper queue, so a
            # new keyframe aborts it (mbAbortBA analog); a dedicated-thread
            # GBA (async_gba) keeps running — only a NEWER loop aborts it
            # (CorrectLoop mbStopGBA semantics)
            if self.loop_closer is not None and not self.loop_closer.async_gba:
                self.loop_closer.abort_gba = True
            self._map_queue.put(kid)
        else:
            self._mapping_pipeline(kid)

    def _mapper_loop(self):
        """Background LocalMapping/LoopClosing thread (LocalMapping::Run /
        LoopClosing::Run poll loops, LocalMapping.cc:64, LoopClosing.cc:90)."""
        import queue as _queue
        import time as _time
        while not self._mapper_stop:
            q = self._map_queue   # snapshot: callers may detach the queue
            if q is None:         # (bench populate) to force inline mapping
                _time.sleep(0.05)
                continue
            try:
                kid = q.get(timeout=0.05)
            except _queue.Empty:
                continue
            try:
                self._in_mapper_thread = True
                with self._map_lock:
                    # with the pipelined front end, loop probes are only
                    # DISPATCHED here and consumed by the tracker's finalize
                    # when their transfer retires — the mapper never fetches
                    # while holding the map lock
                    if self.pipeline > 1:
                        self._mapping_pipeline(kid, lagged_loops=True)
                    else:
                        self._mapping_pipeline(kid)
            except Exception as e:  # never kill the thread; surface the error
                Verbose.log(f"[mapper] error on KF {kid}: {e!r}")
            finally:
                self._in_mapper_thread = False
                q.task_done()

    def wait_mapping_idle(self, timeout: float = 60.0):
        """Block until the mapper queue drains (tests / shutdown)."""
        if self._map_queue is None:
            return
        import time
        t0 = time.time()
        while (self._map_queue.unfinished_tasks > 0
               and time.time() - t0 < timeout):
            time.sleep(0.005)

    # -- asynchronous global BA (mpThreadGBA, LoopClosing.cc:1198) ----------
    def _maybe_start_gba(self):
        """Spawn the post-loop global BA on its own thread. A still-running
        previous GBA is aborted first (the CorrectLoop mbStopGBA semantics:
        a newer loop correction supersedes the BA of the older map shape).

        The GBA's device work shares the one device with the tracker's frame
        work, so the LM schedule runs in 1-iteration
        jitted chunks — each enqueued piece is short, and a frame dispatched
        between chunks waits at most one chunk, not the whole GBA."""
        import threading
        lc = self.loop_closer
        if lc is None or not lc.async_gba or lc.gba_iters <= 0:
            return
        self._abort_gba_and_join()
        m0 = self.map
        n_kf0 = int(m0.n_kf)
        lc.abort_gba = False
        cfg = self.cfg

        def run():
            from ..mapping.map_ba import global_bundle_adjust_auto
            m_gba = global_bundle_adjust_auto(
                m0, self.cam_params, bf=float(cfg.bf),
                cam_model=cfg.camera.model_id, n_iters=lc.gba_iters,
                chunk=1, n_ba_points=min(int(m0.max_mp), 4096),
                should_abort=lambda: lc.abort_gba or self._mapper_stop)
            # the tracking thread merges it (_merge_gba_result): only it
            # knows which frames are in flight against the pre-GBA map
            if not (lc.abort_gba or self._mapper_stop):
                self._gba_result = (m_gba.kf_R, m_gba.kf_t, m_gba.mp_pos,
                                    jnp.int32(n_kf0), m0.mp_valid,
                                    m0.mp_first_kf)

        self._gba_thread = threading.Thread(target=run, daemon=True)
        self._gba_thread.start()
        self.stats["n_gba"] += 1

    def _abort_gba_and_join(self, timeout: float = 60.0):
        """Abort + reap any in-flight GBA (its result is discarded, also one
        that finished but is not merged yet)."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            if self.loop_closer is not None:
                self.loop_closer.abort_gba = True
            t.join(timeout)
        self._gba_thread = None
        self._gba_result = None

    def wait_gba(self, timeout: float = 300.0):
        """Wait for an in-flight GBA to finish AND merge (tests/shutdown)."""
        t = self._gba_thread
        if t is not None:
            t.join(timeout)
            self._gba_thread = None
        self._merge_gba_result()

    def _merge_gba_result(self):
        """Fold a finished async GBA into the live map, on the tracking
        thread (the tail of RunGlobalBundleAdjustment, LoopClosing.cc:1240+).

        Frames in flight were tracked against the pre-GBA map, so they are
        drained first. The last frame's pose then moves with the newest
        keyframe, as UpdateLastFrame re-derives it from its reference
        keyframe (Tracking.cc), and the pipelined chain re-seeds from it:
        seeding from an uncorrected or older pose would put the motion-model
        prediction off the corrected map."""
        if self._gba_result is None:
            return
        self._drain_pipeline()
        with self._map_lock:
            # a loop correction consumed in the drain supersedes the result
            res, self._gba_result = self._gba_result, None
            if res is None:
                return
            from ..mapping.map_ba import merge_gba_result
            m_old = self.map
            self.map = merge_gba_result(m_old, *res)
            kid = self.last_kf_id
            if self.pose is not None and kid >= 0:
                Ri, ti = lie.se3_inverse(m_old.kf_R[kid], m_old.kf_t[kid])
                dR, dt = lie.se3_compose(Ri, ti, self.map.kf_R[kid],
                                         self.map.kf_t[kid])
                R, t = lie.se3_compose(jnp.asarray(self.pose[0]),
                                       jnp.asarray(self.pose[1]), dR, dt)
                self.pose = (np.asarray(R), np.asarray(t))
            self._inertial_prior = None   # anchored to the pre-GBA pose
            self._chain = None
            self.stats["n_gba_merged"] += 1
            Verbose.log(f"[gba] merged async GBA (snapshot {int(res[3])} "
                        f"KFs)")

    def shutdown_mapping(self):
        self.wait_gba()
        if self._mapper_thread is not None:
            self.wait_mapping_idle()
            self._mapper_stop = True
            self._mapper_thread.join(timeout=5.0)
            self._mapper_thread = None

    def _mapping_pipeline(self, kid: int, lagged_loops: bool = False):
        """Per-keyframe mapping work (LocalMapping::Run order,
        LocalMapping.cc:64): cull young landmarks -> triangulate with
        neighbors -> local BA -> loop closing -> merge -> VI window BA.
        Runs inline (sync mode) or on the mapper thread (async mode).

        With `lagged_loops` (pipelined mode), the loop-closing candidate
        probe is only DISPATCHED here; its result is consumed one burst
        later in _finalize_pending — the LoopClosing-thread semantics of the
        reference without any device round trip on the keyframe path."""
        cfg = self.cfg
        from .reloc import PlaceRecognition
        fused = isinstance(self.place_rec, PlaceRecognition)
        if fused:
            # BoW add + the whole LocalMapping chain + the loop-candidate
            # probe as ONE executable (mapper_step_fused): the mapper-thread
            # turn pays a single GIL-contended dispatch instead of four.
            # BoW lives HERE, not at KF creation — the reference computes it
            # on the mapper thread too (ProcessNewKeyFrame -> ComputeBoW,
            # LocalMapping.cc:304)
            lc = self.loop_closer
            want_probe = lc is not None and lc.probe_gates_ok(kid, self._nkf)
            pr = self.place_rec
            voc = pr.voc
            with self.timer.stage("local_mapping"):
                from ..mapping.loop_closing import mapper_step_fused
                # with_probe stays True whenever a loop closer exists, even
                # when the host gates reject this keyframe (probe discarded
                # below): toggling the static arg would lazily compile a
                # second full mapper executable the first time a gate fails
                # mid-run — measured as a multi-second stall inside a bench
                # window. The probe adds ~4 ms device time; a second
                # program costs a ~15 s compile + HBM for its copy.
                m2, bow2, act2, probe = mapper_step_fused(
                    self.map, pr.bow_db, pr.active, voc.centroids, voc.idf,
                    jnp.int32(kid), self.cam_params, k=voc.k,
                    depth=voc.depth, cam_model=cfg.camera.model_id,
                    img_w=cfg.camera.width, img_h=cfg.camera.height,
                    n_levels=cfg.orb.n_levels,
                    n_tri=cfg.mapping.n_tri_neighbors,
                    n_fuse=cfg.mapping.n_fuse_neighbors,
                    do_cull_kf=bool(cfg.mapping.kf_culling),
                    with_probe=lc is not None, th_far=self._th_far,
                    prev_cand=jnp.int32(lc.consistent_candidate
                                        if lc is not None else -1))
                self.map = m2
                pr.bow_db, pr.active = bow2, act2
            # local BA only when no further keyframe is already queued
            # (LocalMapping.cc:151-158 runs LBA strictly under
            # !CheckNewKeyFrames(): under backlog the reference defers
            # optimization to the newest keyframe, which supersedes this
            # window anyway) — on the shared device stream this keeps a
            # burst of keyframes from queuing N*25 ms of BA behind the
            # tracker's frame chunks
            q = self._map_queue
            if q is None or q.unfinished_tasks <= 1:
                with self.timer.stage("local_ba"):
                    self._run_local_ba(kid)
            if want_probe:
                with self.timer.stage("loop_closing"):
                    if lagged_loops:
                        # the pack rides the next burst's batched fetch
                        self._probe_unfetched.append((kid, probe))
                    else:
                        deltas = self._consume_probes(
                            [(kid, np.asarray(probe).reshape(-1))])
                        if deltas and not self._in_mapper_thread:
                            self.pose = (self.map.kf_R[kid],
                                         self.map.kf_t[kid])
        else:
            if self.place_rec is not None:
                with self.timer.stage("bow_add"):
                    self.place_rec.add(kid, self.map.kf_desc[kid],
                                       self.map.kf_feat_valid[kid])
            with self.timer.stage("local_mapping"):
                self.map = lm_ops.mapping_step(
                    self.map, jnp.int32(kid), self.cam_params,
                    cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
                    img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
                    n_tri=cfg.mapping.n_tri_neighbors,
                    n_fuse=cfg.mapping.n_fuse_neighbors,
                    do_cull_kf=bool(cfg.mapping.kf_culling),
                    th_far=self._th_far)
            q = self._map_queue  # LBA only when idle (LocalMapping.cc:151)
            if q is None or q.unfinished_tasks <= 1:
                with self.timer.stage("local_ba"):
                    self._run_local_ba(kid)
            if self.place_rec is not None and self.loop_closer is not None:
                with self.timer.stage("loop_closing"):
                    n_before = self.loop_closer.n_loops
                    self.map = self.loop_closer.on_keyframe(
                        self.map, kid, self.cam_params, n_kf=self._nkf)
                    if self.loop_closer.n_loops > n_before:
                        self.stats["n_loops"] += 1
                        self._inertial_prior = None  # pre-correction anchor
                        if not self._in_mapper_thread:
                            self.pose = (self.map.kf_R[kid],
                                         self.map.kf_t[kid])
                        self._maybe_start_gba()

        if self.place_rec is not None:

            # cross-map merge detection (NewDetectCommonRegions merge branch
            # -> MergeLocal): query retired maps' BoW databases
            if self.map_merger is not None and self.map_merger.archives:
                with self.timer.stage("map_merge"):
                    if self.map_merger.on_keyframe(self.atlas, kid,
                                                   self.cam_params):
                        # merge rewrote keyframe slots: a GBA snapshot of the
                        # pre-merge map must not fold back in
                        self._abort_gba_and_join()
                        self.stats["n_map_merges"] += 1
                        self._inertial_prior = None  # poses moved in merge
                        self._n_kf_host = None
                        self._rebuild_place_rec()
                        # MergeInertialBA (Optimizer.cc:3985): weld the two
                        # inertial chains with velocity/bias-consistent VI-BA
                        # over the seam; the old map's preintegration
                        # registry (archived at spawn, remapped by the
                        # merger) re-enters the live gap registry
                        lmrg = self.map_merger.last_merge
                        if lmrg is not None and cfg.use_imu and self.imu_ready:
                            self._gap_by_dst.update(lmrg["gaps"])
                            self._merge_inertial_ba(lmrg["kf_cur"],
                                                    lmrg["kf_old"])
                        self.map_merger.last_merge = None
                        if not self._in_mapper_thread:
                            self.pose = (self.map.kf_R[kid],
                                         self.map.kf_t[kid])
                        Verbose.log("[tracker] merged maps in atlas")

        # windowed visual-inertial BA once IMU is live (LocalInertialBA,
        # Optimizer.cc:2405) — after _note_kf_imu registered the newest gap
        if cfg.use_imu and self.imu_ready:
            with self.timer.stage("vi_ba"):
                self._run_vi_window(kid)
            # staged full VI-BA refinement (LocalMapping.cc:206-248):
            # VIBA1 when >5s of inertial data, VIBA2 when >15s, then mono
            # scale refinement every 10s from 25s on
            t_init = (self._kf_times[-1] - self._imu_init_ts
                      if self._imu_init_ts is not None and self._kf_times
                      else 0.0)
            if self._viba_stage < 1 and t_init > 5.0:
                with self.timer.stage("viba1"):
                    self._run_full_inertial_ba(kid)
                self._viba_stage = 1
                Verbose.log("[tracker] VIBA1 done")
            elif self._viba_stage < 2 and t_init > 15.0:
                with self.timer.stage("viba2"):
                    self._run_full_inertial_ba(kid)
                self._viba_stage = 2
                self._next_scale_ref_ts = self._imu_init_ts + 25.0
                Verbose.log("[tracker] VIBA2 done")
            elif (self.sensor == "mono" and self._viba_stage >= 2
                  and self._next_scale_ref_ts is not None and self._kf_times
                  and self._kf_times[-1] >= self._next_scale_ref_ts):
                with self.timer.stage("scale_refinement"):
                    self._refine_scale()
                self._next_scale_ref_ts += 10.0

    def _run_vi_window(self, kf_id: int, window_cap: Optional[int] = None,
                       n_iters: Optional[int] = None):
        from ..mapping.vi_ba import apply_vi_window, local_inertial_ba
        cfg = self.cfg
        C = window_cap if window_cap is not None else cfg.ba.window_size + 1
        # longest consecutive chain of KFs ending at kf_id whose gaps all
        # have registered preintegrations (merges/new maps break the chain)
        sel = self._chain_back(kf_id, C)
        if len(sel) < 3:
            return
        ids = np.full(C, -1, np.int32)
        ids[:len(sel)] = sel
        fixed = np.zeros(C, bool)
        fixed[0] = True  # oldest window KF anchors the gauge
        pres = [self._gap_by_dst[sel[i + 1]][1] for i in range(len(sel) - 1)]
        pre_valid = np.zeros(C - 1, bool)
        pre_valid[:len(pres)] = True
        while len(pres) < C - 1:
            pres.append(imu_mod.empty_preintegrated())
        pres_stack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pres)
        bg, ba = self.imu_bias
        R_bc, t_bc = self._tbc
        idsd = jnp.asarray(ids)
        idsc = jnp.clip(idsd, 0, self.map.max_kf - 1)
        v_init = self.map.kf_v[idsc]
        v_init_valid = jnp.linalg.norm(v_init, axis=-1) > 1e-9
        res = local_inertial_ba(
            self.map, idsd, jnp.asarray(fixed), pres_stack,
            jnp.asarray(pre_valid), bg, ba, self.cam_params, float(cfg.bf),
            cam_model=cfg.camera.model_id,
            n_iters=n_iters if n_iters is not None else cfg.ba.n_iters,
            n_levels=cfg.orb.n_levels, R_bc=R_bc, t_bc=t_bc,
            v_init=v_init, v_init_valid=v_init_valid,
            per_kf_bias=bool(cfg.ba.per_kf_bias))
        self.map = apply_vi_window(self.map, jnp.asarray(ids),
                                   jnp.asarray(fixed), res)
        # per-KF bias mode: take the NEWEST VALID window row (padded slots
        # beyond len(sel) never moved off bg0)
        self.imu_bias = (res.bg, res.ba) if res.bg.ndim == 1 else             (res.bg[len(sel) - 1], res.ba[len(sel) - 1])
        if not self._in_mapper_thread:
            # per-frame state refresh only when mapping runs inline — on the
            # mapper thread the tracker has already moved past this KF
            last = len(sel) - 1
            self.frame_state_v = res.v[last]
            self.pose = (self.map.kf_R[kf_id], self.map.kf_t[kf_id])
            bg_l, ba_l = self.imu_bias
            self.anchor_state = InertialFrameState(
                R=self.map.kf_R[kf_id], t=self.map.kf_t[kf_id], v=res.v[last],
                bg=bg_l, ba=ba_l)

    def _chain_back(self, k: int, cap: int):
        """Longest consecutive keyframe chain ending at k whose gaps all
        have registered preintegrations (shared by the VI window and the
        inertial merge weld)."""
        sel = [k]
        while len(sel) < cap:
            src = self._gap_by_dst.get(k, (None, None))[0]
            if src != k - 1 or k - 1 < 0:
                break
            k -= 1
            sel.append(k)
        sel.reverse()
        return sel

    MERGE_VI_HALF = 4   # KFs per side of the inertial weld window

    def _merge_inertial_ba(self, kf_cur: int, kf_old: int):
        """MergeInertialBA (Optimizer.cc:3985 / MergeLocal2 weld): jointly
        refine poses + velocities + bias over BOTH sides of the merge seam.
        Inertial edges exist within each map's own preintegration chain
        (pre_valid masks the seam pair, which has no shared IMU stream —
        same as the reference, where the two maps' IMU histories are
        disjoint); visual landmarks shared across the seam stitch the
        chains geometrically."""
        from ..mapping.vi_ba import apply_vi_window, local_inertial_ba
        cfg = self.cfg
        old_chain = self._chain_back(kf_old, self.MERGE_VI_HALF)
        cur_chain = self._chain_back(kf_cur, self.MERGE_VI_HALF)
        sel = old_chain + cur_chain
        if len(sel) < 3:
            return
        C = 2 * self.MERGE_VI_HALF
        ids = np.full(C, -1, np.int32)
        ids[:len(sel)] = sel[:C]
        fixed = np.zeros(C, bool)
        # the current KF carries the Sim3-verified alignment: it anchors
        fixed[:len(sel)] = [k == kf_cur for k in sel[:C]]
        if not fixed.any():
            fixed[0] = True
        pres, pre_valid = [], np.zeros(C - 1, bool)
        for i in range(len(sel) - 1):
            src, pre = self._gap_by_dst.get(sel[i + 1], (None, None))
            if src == sel[i] and pre is not None:
                pres.append(pre)
                pre_valid[i] = True
            else:
                pres.append(imu_mod.empty_preintegrated())
        while len(pres) < C - 1:
            pres.append(imu_mod.empty_preintegrated())
        pres_stack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pres)
        bg, ba = self.imu_bias
        R_bc, t_bc = self._tbc
        idsd = jnp.asarray(ids)
        idsc = jnp.clip(idsd, 0, self.map.max_kf - 1)
        v_init = self.map.kf_v[idsc]
        v_init_valid = jnp.linalg.norm(v_init, axis=-1) > 1e-9
        res = local_inertial_ba(
            self.map, idsd, jnp.asarray(fixed), pres_stack,
            jnp.asarray(pre_valid), bg, ba, self.cam_params,
            float(cfg.bf), cam_model=cfg.camera.model_id,
            n_iters=cfg.ba.n_iters, n_levels=cfg.orb.n_levels,
            R_bc=R_bc, t_bc=t_bc, v_init=v_init,
            v_init_valid=v_init_valid,
            per_kf_bias=bool(cfg.ba.per_kf_bias))
        self.map = apply_vi_window(self.map, idsd, jnp.asarray(fixed), res)
        self.imu_bias = (res.bg, res.ba) if res.bg.ndim == 1 else             (res.bg[len(sel) - 1], res.ba[len(sel) - 1])
        Verbose.log(f"[tracker] inertial merge weld over {len(sel)} KFs")

    # full window for VIBA1/VIBA2 (FullInertialBA covers every KF; the
    # fixed-shape equivalent caps the chain — 24 >= the map size at the
    # 5s/15s staging points for reference keyframe rates)
    FULL_VI_WINDOW = 24

    def _run_full_inertial_ba(self, kf_id: int, rounds: int = 2):
        """FullInertialBA (Optimizer.cc:390) equivalent: alternate a global
        visual BA (poses + landmarks) with a full-chain VI pass (poses +
        velocities + bias against the preintegration chain, landmarks fixed).
        Run at the VIBA1 (>5s) and VIBA2 (>15s) staging points
        (LocalMapping.cc:206-248)."""
        cfg = self.cfg
        C = min(self.FULL_VI_WINDOW, int(self.map.max_kf))
        n_kf = self._nkf
        ids = np.full(C, -1, np.int32)
        fixed = np.zeros(C, bool)
        lo = max(0, n_kf - C)
        sel = list(range(lo, n_kf))
        ids[:len(sel)] = sel
        fixed[0] = True  # gauge anchor
        for _ in range(rounds):
            if len(sel) >= 2:
                self.map = _local_ba(
                    self.map, jnp.asarray(ids), jnp.asarray(fixed),
                    self.cam_params, float(cfg.bf),
                    cam_model=cfg.camera.model_id,
                    n_ba_points=min(cfg.ba.max_points, int(self.map.max_mp)),
                    n_iters=cfg.ba.n_iters)
            self._run_vi_window(kf_id, window_cap=C)
        if not self._in_mapper_thread:
            self.pose = (self.map.kf_R[kf_id], self.map.kf_t[kf_id])

    def _refine_scale(self):
        """Mono scale refinement (LocalMapping::ScaleRefinement, 25/35/45s):
        re-solve the inertial init problem over the recent KF chain and apply
        the scale + gravity-direction correction to the whole map."""
        m = self.map
        n_kf = self._nkf
        k_ids = list(range(max(0, n_kf - len(self._kf_preints) - 1), n_kf))
        if len(k_ids) < 3 or len(self._kf_preints) < len(k_ids) - 1:
            return
        pres = self._kf_preints[-(len(k_ids) - 1):]
        pres_stack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pres)
        R_bc, t_bc = self._tbc
        R_wg, bg, ba, s, v = inertial_init_optimization(
            m.kf_R[jnp.asarray(k_ids)], m.kf_t[jnp.asarray(k_ids)],
            jnp.ones(len(k_ids), bool), pres_stack,
            jnp.ones(len(k_ids) - 1, bool), opt_scale=True,
            R_bc=R_bc, t_bc=t_bc)
        s_f = float(s)
        if not (0.5 < s_f < 2.0):   # sanity gate
            return
        Rgw = jnp.swapaxes(R_wg, -1, -2)
        self.map = transform_map(m, Rgw, jnp.zeros(3), jnp.float32(s_f))
        self.imu_bias = (bg, ba)
        if not self._in_mapper_thread and self.last_kf_id >= 0:
            self.pose = (self.map.kf_R[self.last_kf_id],
                         self.map.kf_t[self.last_kf_id])
        Verbose.log(f"[tracker] scale refinement applied (s={s_f:.4f})")

    def _run_local_ba(self, kf_id: int):
        cfg = self.cfg
        n_kf = self._nkf
        if n_kf < 3:
            return
        C = cfg.ba.window_size + cfg.ba.n_fixed
        if cfg.mapping.covis_ba_window:
            # covisibility-selected window, oldest members fixed
            # (LocalBundleAdjustment, Optimizer.cc:1124)
            ids, fixed = lm_ops.covis_ba_window(
                self.map, jnp.int32(kf_id), n_win=cfg.ba.window_size,
                n_fixed=cfg.ba.n_fixed)
        else:
            idsn = np.full(C, -1, np.int32)
            fixedn = np.zeros(C, bool)
            lo = max(0, n_kf - cfg.ba.window_size)
            win = list(range(lo, n_kf))
            anchors = list(range(max(0, lo - cfg.ba.n_fixed), lo)) or [0]
            sel = anchors + win
            idsn[:len(sel)] = sel
            fixedn[:len(anchors)] = True
            ids, fixed = jnp.asarray(idsn), jnp.asarray(fixedn)
        self.map = _local_ba(
            self.map, ids, fixed,
            self.cam_params, float(cfg.bf),
            cam_model=cfg.camera.model_id,
            n_ba_points=cfg.ba.max_points, n_iters=cfg.ba.n_iters)
        if not self._in_mapper_thread:
            self.pose = (self.map.kf_R[kf_id], self.map.kf_t[kf_id])

    # -- IMU initialization staging (LocalMapping::InitializeIMU) -----------
    def _note_kf_imu(self, ts: float):
        if not self.cfg.use_imu:
            return
        if self._pre_kf is not None and float(self._pre_kf.dt) > 0 and \
                len(self._kf_times) > 0:
            self._kf_preints.append(self._pre_kf)
            if self._prev_note_kf_id >= 0:
                self._gap_by_dst[self.last_kf_id] = (self._prev_note_kf_id,
                                                     self._pre_kf)
        self._prev_note_kf_id = self.last_kf_id
        self._kf_times.append(ts)
        # camera center history for the bad-IMU motion check
        if self.pose is not None:
            R_ = np.asarray(self.pose[0], np.float64)
            t_ = np.asarray(self.pose[1], np.float64)
            self._kf_centers.append(-R_.T @ t_)
            del self._kf_centers[:-3]
            self._check_bad_imu()
        # keyframe boundary: the next frame optimizes against the KF
        # (LastKeyFrame variant), not a frame-chain prior
        self._inertial_prior = None
        bg, ba = self.imu_bias
        self._pre_kf = imu_mod.empty_preintegrated(bg, ba)
        if (not self.imu_ready and len(self._kf_preints) >= 6
                and self._kf_times[-1] - self._kf_times[0] >= 1.0):
            self._initialize_imu()

    def _check_bad_imu(self):
        """Bad-IMU guard (LocalMapping.cc:140-147): during the inertial
        initialization phase (IMU initialized, VIBA2 not yet done), if less
        than 10 s passed since IMU init AND the last two keyframe gaps moved
        < 2 cm total, scale/gravity are unobservable — flag the map for an
        active-map reset ("Not enough motion for initializing. Reseting...").
        The reset itself happens at the next frame (Tracking.cc:1858)."""
        if (not self.cfg.use_imu or not self.imu_ready
                or self._viba_stage >= 2 or self._imu_init_ts is None
                or len(self._kf_centers) < 3 or not self._kf_times):
            return
        t_init = self._kf_times[-1] - self._imu_init_ts
        c = self._kf_centers
        dist = (np.linalg.norm(c[-1] - c[-2])
                + np.linalg.norm(c[-2] - c[-3]))
        if t_init < 10.0 and dist < 0.02:
            Verbose.log("[tracker] not enough motion for IMU init - "
                        "bad-IMU flag set")
            self._bad_imu = True

    def _initialize_imu(self):
        """Gravity/bias/scale estimation over the KF window + map alignment
        (InitializeIMU, LocalMapping.cc:1196)."""
        m = self.map
        n_kf = self._nkf
        k_ids = list(range(max(0, n_kf - len(self._kf_preints) - 1), n_kf))
        if len(k_ids) < 2 or len(self._kf_preints) < len(k_ids) - 1:
            return
        pres = self._kf_preints[-(len(k_ids) - 1):]
        pres_stack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pres)
        opt_scale = self.sensor == "mono"
        R_bc, t_bc = self._tbc
        R_wg, bg, ba, s, v = inertial_init_optimization(
            m.kf_R[jnp.asarray(k_ids)], m.kf_t[jnp.asarray(k_ids)],
            jnp.ones(len(k_ids), bool), pres_stack,
            jnp.ones(len(k_ids) - 1, bool), opt_scale=opt_scale,
            R_bc=R_bc, t_bc=t_bc)
        s_f = float(s)
        if opt_scale and (s_f < 0.1):   # scale sanity abort (LocalMapping.cc)
            return
        # align gravity: rotate the world by R_gw = R_wg^T (+ scale for mono)
        Rgw = jnp.swapaxes(R_wg, -1, -2)
        self.map = transform_map(m, Rgw, jnp.zeros(3),
                                 jnp.float32(s_f if opt_scale else 1.0))
        self.imu_bias = (bg, ba)
        self.frame_state_v = Rgw @ v[-1]
        self.imu_ready = True
        # loop/merge machinery switches to inertial mode: 4-DoF essential
        # graph, fixed-scale Sim3, tightened gates (LoopClosing.cc:144-163)
        if self.loop_closer is not None:
            self.loop_closer.inertial = True
        if self.map_merger is not None:
            self.map_merger.inertial = True
        self._imu_init_ts = self._kf_times[-1] if self._kf_times else None
        # re-anchor current pose from the transformed map
        self.pose = (self.map.kf_R[self.last_kf_id],
                     self.map.kf_t[self.last_kf_id])
        bg_, ba_ = self.imu_bias
        self.anchor_state = InertialFrameState(
            R=self.pose[0], t=self.pose[1], v=self.frame_state_v,
            bg=bg_, ba=ba_)
        Verbose.log(f"[tracker] IMU initialized (scale {s_f:.3f})")

    # -- outputs ------------------------------------------------------------
    def trajectory_centers(self) -> np.ndarray:
        out = []
        for ts, R, t in self.trajectory:
            out.append(-R.T @ t)
        return np.stack(out) if out else np.zeros((0, 3))

    def trajectory_poses(self):
        return [(ts, (R, t)) for ts, R, t in self.trajectory]


# Backwards-compatible alias (round-1 API)
class StereoTracker(Tracker):
    def __init__(self, cfg: SlamConfig, **kw):
        kw.setdefault("enable_loop_closing", False)
        super().__init__(cfg, sensor="stereo", **kw)

"""Loop detection + correction over the tensor map.

Re-design of the reference's LoopClosing thread
(/root/reference app/src/main/cpp/src/LoopClosing.cc): NewDetectCommonRegions
(:324 — KFDB DetectNBestCandidates -> BoW geometric check -> Sim3Solver
RANSAC -> OptimizeSim3 -> temporal consistency of 3), CorrectLoop (:969 —
propagate the corrected Sim3 over the current covisible window, correct
MapPoints, SearchAndFuse, OptimizeEssentialGraph, optional GBA).

Host-side `LoopCloser` drives the per-keyframe detection state machine
(counters are scalars); all heavy math is in jitted helpers:
  * candidate matching: full descriptor matmul between landmark-bearing
    features (SearchByBoW becomes brute-force matmul matching — see
    tracking/matching.py design note);
  * Sim3 verification: mapping/sim3.py batched RANSAC + GN;
  * graph correction: mapping/pose_graph.py dense solve + one batched
    landmark re-anchoring pass.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..models import map_state as ms
from ..utils import cameras, lie
from ..utils.timing import Verbose
from . import pose_graph, sim3 as sim3_mod


@partial(jax.jit, static_argnames=())
def match_kf_landmarks(m: ms.MapState, kf_a, kf_b):
    """Descriptor-match the landmark-bearing features of two keyframes.

    Returns (p_a_cam (F,3), p_b_cam (F,3), uv_a, uv_b, valid, idx) aligned
    to kf_a's feature slots (idx = matched kf_b feature slot, -1 = none) —
    the input of Sim3 RANSAC (the reference's SearchByBoW(KF, KF) +
    Sim3Solver input assembly, LoopClosing.cc:578+).
    """
    from ..tracking.matching import match_descriptors_ratio

    a = jnp.clip(kf_a, 0, m.max_kf - 1)
    b = jnp.clip(kf_b, 0, m.max_kf - 1)
    F = m.n_feat
    has_a = m.kf_feat_valid[a] & (m.kf_mp[a] >= 0)
    has_b = m.kf_feat_valid[b] & (m.kf_mp[b] >= 0)
    idx, ok = match_descriptors_ratio(m.kf_desc[a], has_a, m.kf_desc[b],
                                      has_b, th=75.0, ratio=0.9)
    idx_c = jnp.clip(idx, 0, F - 1)
    mp_a = jnp.clip(m.kf_mp[a], 0, m.max_mp - 1)
    mp_b = jnp.clip(m.kf_mp[b][idx_c], 0, m.max_mp - 1)
    valid = ok & m.mp_valid[mp_a] & m.mp_valid[mp_b]
    p_a = lie.se3_apply(m.kf_R[a], m.kf_t[a], m.mp_pos[mp_a])
    p_b = lie.se3_apply(m.kf_R[b], m.kf_t[b], m.mp_pos[mp_b])
    return (p_a, p_b, m.kf_xy[a], m.kf_xy[b][idx_c], valid,
            jnp.where(valid, idx, -1))


def _sim3_project_match(p_in_tgt, src_ok, src_desc, src_min_dist, src_max_dist,
                        xy_t, lvl_t, desc_t, ok_t, cam_params,
                        cam_model: int, img_w: int, img_h: int,
                        n_levels: int, radius: float):
    """Project source landmarks (already in the target camera frame) and
    match each to the best target feature inside the scale-predicted radius
    (one direction of ORBmatcher::SearchBySim3's dual sweep). Returns the
    matched target feature per source slot (-1 = none)."""
    from ..ops.masks import leq_int, penalize, step01
    from ..ops.matcher import hamming_matrix
    from ..ops.pyramid import scale_factors
    from ..tracking.matching import TH_HIGH, predicted_level

    z = p_in_tgt[..., 2]
    uv = cameras.project(cam_model, cam_params, p_in_tgt)
    dist = jnp.linalg.norm(p_in_tgt, axis=-1)
    vis = src_ok.astype(jnp.float32) * step01((z - 0.1) * 10.0)
    vis = vis * step01(uv[..., 0] + 1.0) * step01(img_w - uv[..., 0])
    vis = vis * step01(uv[..., 1] + 1.0) * step01(img_h - uv[..., 1])
    # scale-invariance distance band (SearchBySim3 dist3D gate,
    # ORBmatcher.cc:1464: minDistance <= dist3D <= maxDistance)
    vis = vis * step01((dist - 0.8 * src_min_dist) * 8.0)
    vis = vis * step01((1.2 * src_max_dist - dist) * 8.0)
    lvl = predicted_level(dist, src_max_dist, n_levels)
    sf = jnp.asarray(scale_factors(n_levels))
    r_scaled = radius * sf[lvl]

    d2 = jnp.sum((uv[:, None, :] - xy_t[None, :, :]) ** 2, axis=-1)
    g = step01(r_scaled[:, None] ** 2 - d2 + 1.0)
    dlvl = jnp.abs(lvl_t[None, :] - lvl[:, None]).astype(jnp.float32)
    g = g * step01(2.0 - dlvl)
    g = g * vis[:, None] * ok_t.astype(jnp.float32)[None, :]
    dm = hamming_matrix(src_desc, desc_t)
    dm = penalize(dm, g * leq_int(dm, TH_HIGH))
    best = jnp.argmin(dm, axis=1)
    from ..ops.masks import is_finite_match
    hasm = is_finite_match(jnp.min(dm, axis=1))
    return jnp.where(hasm > 0.5, best, -1)


@partial(jax.jit, static_argnames=("cam_model", "img_w", "img_h",
                                   "n_levels", "radius"))
def search_by_sim3(m: ms.MapState, kf_a, kf_b, R12, t12, s12, cam_params,
                   prev_idx, prev_ok, cam_model: int = 0,
                   img_w: int = 640, img_h: int = 400, n_levels: int = 8,
                   radius: float = 7.5):
    """Grow loop correspondences through the estimated Sim3 before the
    final OptimizeSim3 (ORBmatcher::SearchBySim3, ORBmatcher.cc:1464):
    project kf_a's landmarks into kf_b through S21 and kf_b's into kf_a
    through S12, match each within the scale-predicted radius (th=7.5, gate
    TH_HIGH), and accept MUTUAL agreements as new matches; slots with an
    existing match (prev_idx/prev_ok, aligned to kf_a's features) keep it.

    S12 convention: p_a_cam ~= s12 * R12 @ p_b_cam + t12 (the sim3_ransac
    output). Returns (p_a_cam, p_b_cam, uv_a, uv_b, valid) aligned to kf_a's
    feature slots — the optimize_sim3 input."""
    a = jnp.clip(kf_a, 0, m.max_kf - 1)
    b = jnp.clip(kf_b, 0, m.max_kf - 1)
    F = m.n_feat
    mp_a = jnp.clip(m.kf_mp[a], 0, m.max_mp - 1)
    mp_b = jnp.clip(m.kf_mp[b], 0, m.max_mp - 1)
    has_a = m.kf_feat_valid[a] & (m.kf_mp[a] >= 0) & m.mp_valid[mp_a]
    has_b = m.kf_feat_valid[b] & (m.kf_mp[b] >= 0) & m.mp_valid[mp_b]
    p_a_cam = lie.se3_apply(m.kf_R[a], m.kf_t[a], m.mp_pos[mp_a])
    p_b_cam = lie.se3_apply(m.kf_R[b], m.kf_t[b], m.mp_pos[mp_b])

    p_b_in_a = s12 * (p_b_cam @ R12.T) + t12
    Ri, ti, si = lie.sim3_inverse(R12, t12, s12)
    p_a_in_b = si * (p_a_cam @ Ri.T) + ti

    match_ab = _sim3_project_match(
        p_a_in_b, has_a, m.kf_desc[a], m.mp_min_dist[mp_a], m.mp_max_dist[mp_a],
        m.kf_xy[b], m.kf_level[b], m.kf_desc[b], has_b, cam_params,
        cam_model, img_w, img_h, n_levels, radius)
    match_ba = _sim3_project_match(
        p_b_in_a, has_b, m.kf_desc[b], m.mp_min_dist[mp_b], m.mp_max_dist[mp_b],
        m.kf_xy[a], m.kf_level[a], m.kf_desc[a], has_a, cam_params,
        cam_model, img_w, img_h, n_levels, radius)

    j = jnp.clip(match_ab, 0, F - 1)
    mutual = (match_ab >= 0) & (match_ba[j] == jnp.arange(F))
    use_new = mutual & has_a & has_b[j] & ~prev_ok
    idx_out = jnp.where(prev_ok, jnp.clip(prev_idx, 0, F - 1),
                        jnp.where(use_new, j, 0))
    ok_out = prev_ok | use_new
    return (p_a_cam, p_b_cam[idx_out], m.kf_xy[a], m.kf_xy[b][idx_out],
            ok_out)


@partial(jax.jit, static_argnames=("cam_model", "img_w", "img_h",
                                   "n_levels", "radius", "n_covis"))
def project_count_sim3(m: ms.MapState, kf_cur, kf_loop, R12, t12, s12,
                       cam_params, cam_model: int = 0, img_w: int = 640,
                       img_h: int = 400, n_levels: int = 8,
                       radius: float = 8.0, n_covis: int = 10):
    """Count projection matches of the loop neighborhood into the current KF
    through the candidate Sim3 (the verification SearchByProjection of
    DetectCommonRegionsFromBoW, LoopClosing.cc:755/791: the landmarks
    observed by the matched KF + its 10 best covisible neighbors are
    projected through Scw = S12 o T_loop_w and matched to the current KF's
    features; the resulting count gates acceptance at nProjMatches /
    nProjOptMatches).

    S12 convention: p_cur_cam ~= s12 * R12 @ p_loop_cam + t12 (the
    sim3_ransac/optimize_sim3 output for (p_cur, p_loop) inputs). The scale
    is folded by pre-scaling the world: R_cw (s*p_w) + t_cw with
    R_cw = R12 R_l, t_cw = s12 R12 t_l + t12 — viewing directions and the
    scale-invariance band are scale-equivariant, so every isInFrustum gate
    keeps its meaning in the scaled frame."""
    from ..tracking.matching import search_by_projection
    from .local_mapping import observed_mp_mask, top_covisible

    nbrs = top_covisible(m, kf_loop, n_covis)
    ids = jnp.concatenate([nbrs, jnp.asarray(kf_loop, jnp.int32).reshape(1)])
    mask = observed_mp_mask(m, ids)
    l = jnp.clip(kf_loop, 0, m.max_kf - 1)
    c = jnp.clip(kf_cur, 0, m.max_kf - 1)
    R_cw = R12 @ m.kf_R[l]
    t_cw = s12 * (R12 @ m.kf_t[l]) + t12
    # landmarks without a stored normal (zero vector: deserialized or
    # externally-built maps) pass the view-angle gate (normal := view dir);
    # the scale-band gate handles max_dist==0 inside search_by_projection
    cw = -jnp.einsum("ji,j->i", R_cw, t_cw)          # scaled-world center
    view = m.mp_pos * s12 - cw
    view = view / jnp.maximum(jnp.linalg.norm(view, axis=-1, keepdims=True),
                              1e-9)
    has_n = jnp.linalg.norm(m.mp_normal, axis=-1) > 1e-6
    normal = jnp.where(has_n[:, None], m.mp_normal, view)
    pm = search_by_projection(
        m.mp_pos * s12, m.mp_desc, mask, normal,
        m.mp_min_dist * s12, m.mp_max_dist * s12,
        R_cw, t_cw, cam_params, m.kf_xy[c], m.kf_level[c], m.kf_desc[c],
        m.kf_feat_valid[c], radius, cam_model=cam_model, img_w=img_w,
        img_h=img_h, n_levels=n_levels)
    # count DISTINCT matched features: multiple landmarks matching the same
    # feature must count once (the reference's nProjMatches is per-feature —
    # vpMatchedMPs slots — so duplicates would inflate the gate)
    F = m.n_feat
    tgt = jnp.where(pm.mp_feat >= 0, pm.mp_feat, F)
    hit = jnp.zeros(F + 1, bool).at[tgt].set(True, mode="drop")
    return jnp.sum(hit[:F].astype(jnp.int32))


@jax.jit
def match_kf_landmarks_cross(ma: ms.MapState, kf_a, mb: ms.MapState, kf_b):
    """Cross-map variant of match_kf_landmarks: keyframe kf_a of map `ma` vs
    keyframe kf_b of map `mb` (the merge-detection geometry input,
    LoopClosing::NewDetectCommonRegions merge branch, LoopClosing.cc:324+).
    Returns (p_a_cam, p_b_cam, uv_a, uv_b, valid) aligned to kf_a's slots."""
    from ..tracking.matching import match_descriptors_ratio

    a = jnp.clip(kf_a, 0, ma.max_kf - 1)
    b = jnp.clip(kf_b, 0, mb.max_kf - 1)
    F = ma.n_feat
    has_a = ma.kf_feat_valid[a] & (ma.kf_mp[a] >= 0)
    has_b = mb.kf_feat_valid[b] & (mb.kf_mp[b] >= 0)
    idx, ok = match_descriptors_ratio(ma.kf_desc[a], has_a, mb.kf_desc[b],
                                      has_b, th=75.0, ratio=0.9)
    idx_c = jnp.clip(idx, 0, F - 1)
    mp_a = jnp.clip(ma.kf_mp[a], 0, ma.max_mp - 1)
    mp_b = jnp.clip(mb.kf_mp[b][idx_c], 0, mb.max_mp - 1)
    valid = ok & ma.mp_valid[mp_a] & mb.mp_valid[mp_b]
    p_a = lie.se3_apply(ma.kf_R[a], ma.kf_t[a], ma.mp_pos[mp_a])
    p_b = lie.se3_apply(mb.kf_R[b], mb.kf_t[b], mb.mp_pos[mp_b])
    return p_a, p_b, ma.kf_xy[a], mb.kf_xy[b][idx_c], valid


@jax.jit
def merge_world_sim3(R_cur, t_cur, R12, t12, s12, R_old, t_old):
    """World-frame Sim3 (current-map world <- old-map world) from a
    camera-frame Sim3 S12 (old-KF camera -> current-KF camera):
        S_w = T_cw_cur^-1 o S12 o T_cw_old."""
    one = jnp.float32(1.0)
    Ri, ti, si = lie.sim3_inverse(R_cur, t_cur, one)
    Rm, tm, sm = lie.sim3_compose(R12, t12, s12, R_old, t_old, one)
    return lie.sim3_compose(Ri, ti, si, Rm, tm, sm)


class MapMerger:
    """Cross-map place recognition + Sim3 verification + Atlas merge.

    The reference's multi-map merge path (LoopClosing.cc:
    NewDetectCommonRegions querying the shared KeyFrameDatabase across maps
    -> Sim3 verification -> MergeLocal:1215 fusing the maps). Here each
    retired map keeps its frozen BoW database; every new keyframe of the
    active map is queried against all of them, and a temporally-consistent,
    Sim3-verified hit triggers Atlas.merge (old map transformed into the
    current world frame and appended)."""

    def __init__(self, cfg, min_matches: int = 20, min_inliers: int = 20,
                 consistency_needed: int = 3, score_th: float = 0.015):
        self.cfg = cfg
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.consistency_needed = consistency_needed
        self.score_th = score_th
        self.archives = []            # [{"map_idx": int, "db": PlaceRecognition}]
        self.consistent = (-1, -1)    # (archive position, candidate kf)
        self.count = 0
        self.n_merges = 0
        # set by the tracker once IMU is initialized: tightens the merge
        # scale gate to [0.9, 1.1] and routes the weld through the
        # gravity-consistent inertial path (MergeLocal2, LoopClosing.cc:1783)
        self.inertial = False
        # bookkeeping of the last merge for the tracker's MergeInertialBA
        # pass: {"kf_cur", "kf_old", "gaps": remapped preintegration registry}
        self.last_merge = None

    def archive(self, map_idx: int, db, gaps=None) -> None:
        """Freeze the BoW database (+ the per-gap IMU preintegration
        registry) of a map being retired (new-map spawn). The registry is
        what makes a later MergeInertialBA possible: inertial edges survive
        the map retirement and re-enter the weld window after the merge."""
        if db is not None:
            self.archives.append({"map_idx": map_idx, "db": db,
                                  "gaps": dict(gaps) if gaps else {}})

    def on_keyframe(self, atlas, kf_id: int, cam_params) -> bool:
        """Query archived maps with the active map's new keyframe; on a
        verified hit, merge that map into the current one. Returns True if a
        merge happened (caller must rebuild its live BoW database)."""
        if not self.archives:
            return False
        m = atlas.current_map

        best = (-1, -1, 0.0)  # (archive position, cand kf, score)
        for pos, arc in enumerate(self.archives):
            ids, scores = arc["db"].query(m.kf_desc[kf_id],
                                          m.kf_feat_valid[kf_id], n_best=1)
            if int(ids[0]) >= 0 and float(scores[0]) > best[2]:
                best = (pos, int(ids[0]), float(scores[0]))
        pos, cand, score = best
        if pos < 0 or score <= self.score_th:
            self.count = 0
            return False

        # temporal consistency: consecutive hits on the same archive, nearby KF
        if self.consistent[0] == pos and abs(cand - self.consistent[1]) <= 2:
            self.count += 1
        else:
            self.count = 1
        self.consistent = (pos, cand)
        if self.count < self.consistency_needed:
            return False

        arc = self.archives[pos]
        old = atlas.maps[arc["map_idx"]]
        p_a, p_b, uv_a, uv_b, valid = match_kf_landmarks_cross(
            m, jnp.int32(kf_id), old, jnp.int32(cand))
        if int(jnp.sum(valid)) < self.min_matches:
            return False
        R12, t12, s12, inl, n_inl = sim3_mod.sim3_ransac(
            p_a, p_b, uv_a, uv_b, valid, cam_params)
        if int(n_inl) < self.min_inliers:
            return False
        R12, t12, s12, inl, n_inl = sim3_mod.optimize_sim3(
            R12, t12, s12, p_a, p_b, uv_a, uv_b, inl & valid, cam_params)
        if int(n_inl) < self.min_inliers:
            return False
        # merge-scale sanity gate (reference: scale in [0.9, 1.1] for
        # inertial merges, LoopClosing.cc:144-163; visual maps allow more)
        s_lo, s_hi = (0.9, 1.1) if self.inertial else (0.5, 2.0)
        if not (s_lo < float(s12) < s_hi):
            return False

        Rw, tw, sw = merge_world_sim3(
            m.kf_R[kf_id], m.kf_t[kf_id], R12, t12, s12,
            old.kf_R[cand], old.kf_t[cand])
        if self.inertial:
            # gravity-consistent weld (MergeLocal2, LoopClosing.cc:1783):
            # both maps are gravity-aligned (+y down), so the world-frame
            # correction must be yaw-only — project out pitch/roll and pin
            # scale to 1 (observable from the IMU)
            Rn = np.asarray(Rw, np.float64)
            yaw = np.arctan2(Rn[0, 2] - Rn[2, 0], Rn[0, 0] + Rn[2, 2])
            cy, sy = np.cos(yaw), np.sin(yaw)
            Rw = jnp.asarray(np.array([[cy, 0, sy], [0, 1, 0],
                                       [-sy, 0, cy]], np.float32))
            sw = jnp.float32(1.0)
        src_idx = arc["map_idx"]
        n_dst_before = int(m.n_kf)
        # the old map's cand KF lands at this index after merge_into's
        # valid-compacting append
        kf_valid_old = np.asarray(old.kf_valid)
        rank = np.cumsum(kf_valid_old) - 1
        cand_new = n_dst_before + int(rank[cand])
        atlas.merge(src_idx, Rw, tw, sw)
        self._welding_ba(atlas, kf_id, cand_new, cam_params)
        # remap the archived preintegration registry into merged keyframe
        # ids (consumed by the tracker's MergeInertialBA pass)
        gaps_new = {}
        for dst_k, (src_k, pre) in arc.get("gaps", {}).items():
            if (0 <= dst_k < len(kf_valid_old) and kf_valid_old[dst_k]
                    and 0 <= src_k < len(kf_valid_old) and kf_valid_old[src_k]):
                gaps_new[n_dst_before + int(rank[dst_k])] = (
                    n_dst_before + int(rank[src_k]), pre)
        self.last_merge = {"kf_cur": kf_id, "kf_old": cand_new,
                           "gaps": gaps_new}
        # fix up archive bookkeeping after the source map's removal
        self.archives.pop(pos)
        for a in self.archives:
            if a["map_idx"] > src_idx:
                a["map_idx"] -= 1
        self.count = 0
        self.consistent = (-1, -1)
        self.n_merges += 1
        return True

    WELD_HALF = 3  # KFs on each side of the weld seam

    def _welding_ba(self, atlas, kf_cur: int, kf_old: int, cam_params):
        """Welding-window BA after the map fusion (MergeLocal's local BA over
        the weld region, Optimizer.cc:3532 LocalBundleAdjustment variant):
        jointly refine the KFs around both sides of the seam with the current
        KF held fixed (it carries the Sim3-verified alignment)."""
        from .map_ba import map_window_ba
        m = atlas.current_map
        n_kf = int(m.n_kf)
        w = self.WELD_HALF
        sel = sorted(set(
            list(range(max(0, kf_cur - w), min(kf_cur + 1, n_kf))) +
            list(range(max(0, kf_old - w), min(kf_old + w + 1, n_kf)))))
        if len(sel) < 3:
            return
        C = 2 * (2 * w + 1)
        ids = np.full(C, -1, np.int32)
        fixed = np.zeros(C, bool)
        ids[:len(sel)] = sel[:C]
        fixed[:len(sel)] = [k == kf_cur for k in sel[:C]]
        if not fixed.any():
            fixed[0] = True  # gauge fallback
        cfg = self.cfg
        atlas.current_map = map_window_ba(
            m, jnp.asarray(ids), jnp.asarray(fixed), cam_params,
            float(cfg.bf), cam_model=cfg.camera.model_id,
            n_ba_points=min(cfg.ba.max_points, int(m.max_mp)),
            n_iters=cfg.ba.n_iters)


@partial(jax.jit, static_argnames=("e_max",))
def essential_edges(m: ms.MapState, e_max: int = 1024, min_weight: float = 100.0):
    """Essential-graph edge list (OptimizeEssentialGraph input,
    Optimizer.cc:1511): spanning-tree edges (KeyFrame.h:322 mpParent) +
    sequential odometry chain + strong covisibility edges (weight >= 100,
    KeyFrame::GetCovisiblesByWeight semantics). The caller appends the
    persistent loop edges (mspLoopEdges). Returns (e_i, e_j, e_valid) of
    static size e_max + K."""
    from ..ops.masks import step01
    K = m.max_kf
    e_max = min(e_max, K * K)   # small maps: can't select more pairs
    C = ms.covisibility(m)
    ii = jax.lax.broadcasted_iota(jnp.int32, (K, K), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (K, K), 1)
    # arithmetic gates (2-D preds are hazardous on this backend, see ops/masks)
    upper = step01((jj - ii).astype(jnp.float32))
    seq = upper * step01(1.0 - jnp.abs(jj - ii - 1).astype(jnp.float32))
    kv = m.kf_valid.astype(jnp.float32)
    valid_pair = kv[:, None] * kv[None, :]
    w = (C * step01(C - min_weight + 1.0) + seq * 1e6) * upper * valid_pair
    flat = w.reshape(-1)
    top_w, top_idx = jax.lax.top_k(flat, e_max)
    e_i = top_idx // K
    e_j = top_idx % K
    # spanning tree block: edge (parent[j], j) per keyframe with a parent
    par = m.kf_parent
    par_c = jnp.clip(par, 0, K - 1)
    tree_valid = (par >= 0) & m.kf_valid & m.kf_valid[par_c]
    e_i = jnp.concatenate([e_i.astype(jnp.int32), par_c])
    e_j = jnp.concatenate([e_j.astype(jnp.int32),
                           jnp.arange(K, dtype=jnp.int32)])
    e_valid = jnp.concatenate([top_w > 0, tree_valid])
    return e_i, e_j, e_valid


@jax.jit
def apply_pose_graph_result(m: ms.MapState, new_R, new_t, new_s,
                            old_R, old_t) -> ms.MapState:
    """Write corrected poses back (Sim3 -> SE3 with t/s, reference
    LoopClosing.cc:1035 CorrectedSim3 handling) and re-anchor every landmark
    through its first-observing keyframe:  p' = Tcw_new^-1 * s * (Tcw_old * p).
    """
    se3_t = new_t / jnp.maximum(new_s[:, None], 1e-9)
    ref = jnp.clip(m.mp_first_kf, 0, m.max_kf - 1)
    has_ref = (m.mp_first_kf >= 0) & m.mp_valid

    p_cam = lie.se3_apply(old_R[ref], old_t[ref], m.mp_pos)
    Rn, tn = new_R[ref], se3_t[ref]
    Rwc = jnp.swapaxes(Rn, -1, -2)
    p_new = jnp.einsum("pij,pj->pi", Rwc, p_cam - tn)
    h = has_ref.astype(jnp.float32)[:, None]
    mp_pos = h * p_new + (1.0 - h) * m.mp_pos
    return m._replace(kf_R=new_R, kf_t=se3_t, mp_pos=mp_pos)


@partial(jax.jit, static_argnames=("k", "depth", "n_best"))
def loop_probe(m: ms.MapState, bow_db, active, centroids, idf, kf_id,
               k: int, depth: int, n_best: int = 3, prev_cand=None):
    """Fused per-keyframe loop-detection probe: covisibility row + BoW
    descent + exclusion + top-N candidates, ONE device round trip.

    Returns a (3*n_best+1,) f32 pack [ids | scores | covis_w | min_score].
    `covis_w` is each candidate's covisibility weight with `prev_cand` (the
    previously consistent candidate) when given, else with the current KF —
    the reference's consistent-group test compares the NEW candidate group
    against the PREVIOUS one (DetectCommonRegionsFromBoW consistency /
    mnLoopNumCoincidences, LoopClosing.cc:396+): at a genuine revisit the
    candidate has zero covisibility with the CURRENT keyframe by
    construction, so group consistency must be measured candidate-to-
    candidate. This is the common no-loop-detected path of
    NewDetectCommonRegions (LoopClosing.cc:324+) collapsed into a single
    executable so the per-KF cost is one fetch instead of several.
    """
    from ..models.vocabulary import _descend, bow_vector, l1_scores
    K = m.max_kf
    O = ms.observation_matrix(m)                    # (K, P)
    covis_row = O @ O[kf_id]                        # (K,)
    words = _descend(centroids, m.kf_desc[kf_id], k, depth)
    q = bow_vector(words, m.kf_feat_valid[kf_id], idf, k ** depth)
    s = l1_scores(bow_db, q)
    ii = jnp.arange(K)
    # the BoW database is append-only; CULLED keyframes must not be
    # candidates (the reference erases them: KeyFrame::SetBadFlag ->
    # KeyFrameDatabase::erase). A culled KF has covis_row == 0 and a stale
    # pose — without this mask it sails past the covisibility exclusion and
    # "verifies" as a loop against stale geometry.
    active = active & m.kf_valid
    # dynamic score floor (DetectLoop, LoopClosing.cc:96+): a candidate
    # must look at least as similar as the WORST covisible neighbor —
    # the defense against perceptual aliasing in self-similar scenes
    covis_mask = (covis_row >= 15.0) & active & (ii != kf_id)
    # empty covisible set -> absolute floor 0, NOT the 1.0 sentinel (which
    # would reject every candidate since l1 scores are <= 1)
    min_score = jnp.where(jnp.any(covis_mask),
                          jnp.min(jnp.where(covis_mask, s, 1.0)), 0.0)
    # temporal exclusion by TIMESTAMP (2 s) in addition to 8 keyframe ids
    # (kf_ts is MAP-RELATIVE — the tracker subtracts a float64 origin before
    # insert, so the f32 subtraction below keeps sub-second resolution even
    # for epoch-stamped datasets like EuRoC):
    # with the lagged/pipelined front end, keyframes born within the
    # in-flight window can carry duplicate landmarks (bindings computed
    # against a stale map), so covisibility alone cannot be trusted to
    # exclude near-in-time keyframes — and under dense keyframing, 8 ids
    # can span FEWER frames than the pipeline depth. A same-place revisit
    # in under 2 s is not a loop worth closing.
    dts = jnp.abs(m.kf_ts - m.kf_ts[kf_id])
    exclude = (covis_row > 0) | (~active) | (jnp.abs(ii - kf_id) <= 8) \
        | (dts < 2.0)
    s = jnp.where(exclude, -1.0, s)
    top_s, top_i = jax.lax.top_k(s, n_best)
    if prev_cand is None:
        covis_out = covis_row[top_i]
    else:
        pc = jnp.clip(prev_cand, 0, K - 1)
        covis_out = (O @ O[pc])[top_i] * (prev_cand >= 0)
    # BoW-match count of the top candidate (the nBoWMatches >= 20 gate of
    # DetectCommonRegionsFromBoW, LoopClosing.cc:581): computing it here —
    # one (F,F) Hamming matmul — lets the host kill perceptual-aliasing
    # candidates from the pack alone, with ZERO further device round trips
    _pa, _pb, _ua, _ub, bow_valid, _idx = match_kf_landmarks(m, kf_id,
                                                             top_i[0])
    n_bow = jnp.sum(bow_valid.astype(jnp.float32))
    return jnp.concatenate([top_i.astype(jnp.float32), top_s,
                            covis_out, min_score[None], n_bow[None]])


@partial(jax.jit, static_argnames=("k", "depth", "n_best", "cam_model",
                                   "img_w", "img_h", "n_levels", "n_tri",
                                   "n_fuse", "do_cull_kf", "with_probe"))
def mapper_step_fused(m: ms.MapState, bow_db, active, centroids, idf, kf_id,
                      cam_params, k: int, depth: int, n_best: int = 3,
                      cam_model: int = 0, img_w: int = 640, img_h: int = 400,
                      n_levels: int = 8, n_tri: int = 10, n_fuse: int = 3,
                      do_cull_kf: bool = True, with_probe: bool = True,
                      th_far=None, prev_cand=None):
    """The ENTIRE per-keyframe mapper-thread chain as one executable:
    ComputeBoW + database add (LocalMapping::ProcessNewKeyFrame,
    LocalMapping.cc:304) -> cull/triangulate/fuse/KF-cull (mapping_step) ->
    the LoopClosing candidate probe (NewDetectCommonRegions fast path,
    LoopClosing.cc:324). Issued as 4 separate dispatches the mapper thread
    paid 4 GIL-contended launch turns per keyframe while holding the map
    lock; fused it pays one.

    Returns (new map, new bow_db, new active, probe_pack (16,)). Pack
    layout: [ids(3) | scores(3) | covis_w(3) | min_score | n_mp | n_kf |
    zeros] — slots 10/11 carry the landmark/keyframe counts so the host
    tracks capacity pressure without a dedicated fetch."""
    from ..models.vocabulary import _descend, bow_vector
    from .local_mapping import mapping_step

    kf_id = jnp.asarray(kf_id, jnp.int32)
    words = _descend(centroids, m.kf_desc[kf_id], k, depth)
    v = bow_vector(words, m.kf_feat_valid[kf_id], idf, k ** depth)
    bow_db2 = bow_db.at[kf_id].set(v)
    active2 = active.at[kf_id].set(True)
    m2 = mapping_step(m, kf_id, cam_params, cam_model=cam_model, img_w=img_w,
                      img_h=img_h, n_levels=n_levels, n_tri=n_tri,
                      n_fuse=n_fuse, do_cull_kf=do_cull_kf, th_far=th_far)
    if with_probe:
        probe = loop_probe(m2, bow_db2, active2, centroids, idf, kf_id,
                           k=k, depth=depth, n_best=n_best,
                           prev_cand=prev_cand)
    else:
        probe = jnp.full(3 * n_best + 2, -1.0, jnp.float32)
    aux = jnp.stack([m2.n_mp.astype(jnp.float32),
                     m2.n_kf.astype(jnp.float32)])
    pack = jnp.concatenate([probe, aux])
    pack = jnp.concatenate([pack, jnp.zeros(16 - pack.shape[0], jnp.float32)])
    return m2, bow_db2, active2, pack


@partial(jax.jit, static_argnames=("cam_model", "img_w", "img_h",
                                   "n_levels", "fix_scale"))
def verify_loop_fused(m: ms.MapState, kf_id, cand, cam_params,
                      cam_model: int = 0, img_w: int = 640, img_h: int = 400,
                      n_levels: int = 8, fix_scale: bool = False):
    """The ENTIRE geometric loop-verification cascade as one executable
    with ONE result pack: BoW landmark matching -> Sim3 RANSAC -> coarse
    neighborhood reprojection -> SearchBySim3 grow -> OptimizeSim3 -> fine
    reprojection -> inertial pitch/roll decomposition
    (DetectCommonRegionsFromBoW, LoopClosing.cc:583-800).

    Issued as separate dispatches the host would pay ~6 blocking device
    syncs per verification, inside the tracker's finalize path; every stage
    here runs unconditionally and
    the HOST applies the reference's gate ladder to the fetched pack.
    Pack layout (24 f32):
      [0] n_matches  [1] n_inl_ransac  [2] n_proj_coarse
      [3] n_inl_opt  [4] n_proj_fine   [5:14] R12  [14:17] t12  [17] s12
      [18:21] phi (so3 log of the implied current-pose correction, for the
      inertial yaw-only gate)  [21:24] zeros
    """
    kf_id = jnp.asarray(kf_id, jnp.int32)
    cand = jnp.asarray(cand, jnp.int32)
    p_a, p_b, uv_a, uv_b, valid, idx = match_kf_landmarks(m, kf_id, cand)
    n_match = jnp.sum(valid.astype(jnp.float32))
    R12, t12, s12, inl, n_inl = sim3_mod.sim3_ransac(
        p_a, p_b, uv_a, uv_b, valid, cam_params, fix_scale=fix_scale)
    ck = dict(cam_model=cam_model, img_w=img_w, img_h=img_h,
              n_levels=n_levels)
    n_proj = project_count_sim3(m, kf_id, cand, R12, t12, s12, cam_params,
                                radius=8.0, **ck)
    p_a2, p_b2, uv_a2, uv_b2, v2 = search_by_sim3(
        m, kf_id, cand, R12, t12, s12, cam_params, idx, inl & valid, **ck)
    R12o, t12o, s12o, inlo, n_inlo = sim3_mod.optimize_sim3(
        R12, t12, s12, p_a2, p_b2, uv_a2, uv_b2, v2, cam_params,
        fix_scale=fix_scale)
    n_proj2 = project_count_sim3(m, kf_id, cand, R12o, t12o, s12o,
                                 cam_params, radius=5.0, **ck)
    # implied rotation correction of the current keyframe (inertial gate)
    Rl, tl = m.kf_R[cand], m.kf_t[cand]
    Rc_new, _, _ = lie.sim3_compose(R12o, t12o, s12o, Rl, tl,
                                    jnp.float32(1.0))
    phi = lie.so3_log(Rc_new @ jnp.swapaxes(m.kf_R[kf_id], -1, -2))
    return jnp.concatenate([
        jnp.stack([n_match, n_inl.astype(jnp.float32),
                   n_proj.astype(jnp.float32), n_inlo.astype(jnp.float32),
                   n_proj2.astype(jnp.float32)]),
        R12o.reshape(-1), t12o, s12o.reshape(1), phi,
        jnp.zeros(3, jnp.float32)])


class LoopCloser:
    """Host-side loop-detection state machine + correction driver."""

    # staged-verification thresholds (DetectCommonRegionsFromBoW,
    # LoopClosing.cc:583-589: nBoWMatches=20, nBoWInliers=15, nSim3Inliers=20,
    # nProjMatches=50, nProjOptMatches=80 at the upstream 1250-feature
    # budget; the projection counts scale with the configured budget, with
    # floors so a small-budget rig still verifies meaningfully)
    RANSAC_INLIERS = 15          # nBoWInliers
    REF_FEAT_BUDGET = 1250.0
    PROJ_MATCHES = 50            # nProjMatches (at REF_FEAT_BUDGET)
    PROJ_OPT_MATCHES = 80        # nProjOptMatches (at REF_FEAT_BUDGET)
    PROJ_FLOOR = 20
    PROJ_OPT_FLOOR = 25

    def __init__(self, cfg, place_rec, min_matches: int = 20,
                 min_inliers: int = 20, consistency_needed: int = 3,
                 gba_iters: int = 10, fix_scale: bool = False):
        self.cfg = cfg
        self.pr = place_rec
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.consistency_needed = consistency_needed
        self.consistent_candidate = -1
        self.consistency_count = 0
        self.last_loop_kf = -999
        self.n_loops = 0
        # inertial mode (set by the tracker once IMU is initialized): routes
        # the essential-graph correction to the 4-DoF yaw+translation
        # optimizer (OptimizeEssentialGraph4DoF, Optimizer.cc:5338) — a 7-DoF
        # Sim3 correction on an IMU-initialized map would bend the observable
        # scale and gravity direction — and arms the inertial sanity gates
        # (LoopClosing.cc:144-163): scale in [0.9, 1.1], pitch/roll of the
        # correction < 0.008 rad
        self.inertial = False
        # stereo/RGBD: depth fixes scale, Sim3Solver runs with bFixScale
        # (LoopClosing.cc:585 mbFixScale)
        self.fix_scale = fix_scale
        # rigid delta of the LAST correction (device arrays, set by
        # correct()): consumers fetch it once per actual loop instead of
        # snapshotting poses around every probe (two blocking fetches per
        # probe)
        self.last_delta = None
        # persistent loop edges (KeyFrame::mspLoopEdges, KeyFrame.h:324):
        # every confirmed loop's (loop_kf, cur_kf) pair is remembered and
        # re-enters every later essential-graph optimization, so a second
        # loop closure cannot discard the constraint of the first
        self.loop_edges: list = []
        # global BA after loop correction (RunGlobalBundleAdjustment,
        # LoopClosing.cc:1206/2268); abort_gba is the mbStopGBA equivalent,
        # polled between jitted LM chunks. With async_gba the GBA is NOT run
        # here — the tracker spawns it on a dedicated thread (mpThreadGBA)
        # when it sees n_loops advance, and merges the result when done.
        self.gba_iters = gba_iters
        self.abort_gba = False
        self.async_gba = bool(getattr(getattr(cfg, "mapping", None),
                                      "async_gba", False))

    PROBE_N = 3
    LOOP_EDGE_CAP = 16

    def remap_keyframes(self, kf_new) -> None:
        """Rewrite stored loop-edge keyframe ids after a map compaction /
        merge re-indexed the keyframe slots (kf_new: old id -> new id or -1).
        Edges touching a culled keyframe are dropped."""
        out = []
        for i, j in self.loop_edges:
            if 0 <= i < len(kf_new) and 0 <= j < len(kf_new):
                ni, nj = int(kf_new[i]), int(kf_new[j])
                if ni >= 0 and nj >= 0:
                    out.append((ni, nj))
        self.loop_edges = out

    def probe_gates_ok(self, kf_id: int, n_kf: int) -> bool:
        return not (n_kf < 8 or kf_id - self.last_loop_kf < 10)

    def dispatch_probe(self, m: ms.MapState, kf_id: int, n_kf: int):
        """Dispatch the fused candidate probe WITHOUT fetching (pipelined
        mode: the result is consumed one burst later, like the reference's
        LoopClosing thread draining its keyframe queue asynchronously,
        LoopClosing.cc:90). Returns a device handle of 16 floats (padded to
        the tracker's scalar-pack width) or None if gated/unsupported."""
        from ..tracking.reloc import PlaceRecognition
        if not self.probe_gates_ok(kf_id, n_kf):
            return None
        if not isinstance(self.pr, PlaceRecognition):
            return None
        voc = self.pr.voc
        out = loop_probe(m, self.pr.bow_db, self.pr.active, voc.centroids,
                         voc.idf, jnp.int32(kf_id), k=voc.k, depth=voc.depth,
                         n_best=self.PROBE_N,
                         prev_cand=jnp.int32(self.consistent_candidate))
        return jnp.concatenate([out, jnp.zeros(16 - 3 * self.PROBE_N - 2)])

    def on_probe_result(self, m: ms.MapState, kf_id: int, vals,
                        cam_params) -> ms.MapState:
        """Consume a fetched probe pack: temporal-consistency state machine,
        geometric verification and correction on a confirmed loop."""
        n = self.PROBE_N
        ids = vals[:n].astype(np.int32)
        scores = vals[n:2 * n]
        covis_w = vals[2 * n:3 * n]
        return self._after_probe(m, kf_id, ids, scores, covis_w, cam_params,
                                 min_score=float(vals[3 * n]),
                                 n_bow=float(vals[3 * n + 1])
                                 if len(vals) > 3 * n + 1 else None)

    def _probe(self, m: ms.MapState, kf_id: int):
        """Candidate retrieval: fused single-fetch path for the dense JAX
        database; legacy multi-call path for the native inverted file."""
        from ..tracking.reloc import PlaceRecognition
        n_best = 3
        if isinstance(self.pr, PlaceRecognition):
            voc = self.pr.voc
            out = np.asarray(loop_probe(
                m, self.pr.bow_db, self.pr.active, voc.centroids, voc.idf,
                jnp.int32(kf_id), k=voc.k, depth=voc.depth, n_best=n_best,
                prev_cand=jnp.int32(self.consistent_candidate)))
            return (out[:n_best].astype(np.int32), out[n_best:2 * n_best],
                    out[2 * n_best:3 * n_best], float(out[3 * n_best]))
        covis = np.asarray(ms.covisibility(m)[kf_id])
        exclude = covis > 0
        exclude[kf_id] = True
        exclude[max(0, kf_id - 8):kf_id + 9] = True  # temporal neighbors
        # timestamp exclusion (mirrors loop_probe): <2 s is not a loop
        ts_all = np.asarray(m.kf_ts)
        exclude |= np.abs(ts_all - ts_all[kf_id]) < 2.0
        # culled keyframes are not candidates (KeyFrameDatabase::erase)
        exclude |= ~np.asarray(m.kf_valid)
        # dynamic floor: worst covisible-neighbor score (DetectLoop), same
        # >=15 covisibility-weight threshold as the fused loop_probe path
        s_all = np.asarray(self.pr.query_scores(
            m.kf_desc[kf_id], m.kf_feat_valid[kf_id])) \
            if hasattr(self.pr, "query_scores") else None
        covis_ids = np.flatnonzero(covis >= 15)
        covis_ids = covis_ids[covis_ids != kf_id]
        if s_all is not None and len(covis_ids):
            min_score = float(s_all[covis_ids].min())
        else:
            min_score = 0.0
            Verbose.log(f"[loop] KF {kf_id}: no covisible neighbor w>=15, "
                        "minScore floor 0")
        ids, scores = self.pr.query(m.kf_desc[kf_id], m.kf_feat_valid[kf_id],
                                    exclude_mask=jnp.asarray(exclude),
                                    n_best=n_best)
        ids = np.asarray(ids)
        # candidate-group consistency weight vs the PREVIOUS consistent
        # candidate (see loop_probe docstring)
        prev = self.consistent_candidate
        if prev >= 0:
            cw = np.asarray(ms.covisibility(m)[prev])[
                np.clip(ids, 0, m.max_kf - 1)]
        else:
            cw = np.zeros(len(ids), np.float32)
        return (ids, np.asarray(scores), cw, min_score)

    def on_keyframe(self, m: ms.MapState, kf_id: int, cam_params,
                    n_kf: Optional[int] = None) -> ms.MapState:
        """Run detection for a new keyframe; on a confirmed loop, correct the
        map. Returns the (possibly corrected) map. `n_kf` lets callers pass a
        host-side mirror of map.n_kf to avoid a device sync."""
        if n_kf is None:
            n_kf = int(m.n_kf)
        # reference gates: skip until enough KFs and not right after a loop
        if not self.probe_gates_ok(kf_id, n_kf):
            return m

        # covisibility-excluded BoW query (LoopClosing.cc:341+) — one fused
        # probe + one fetch when the live database is the dense JAX one
        probe = self._probe(m, kf_id)
        if probe is None:
            return m
        ids, scores, covis_w, min_score = probe
        return self._after_probe(m, kf_id, ids, scores, covis_w, cam_params,
                                 min_score=min_score)

    # when True, candidates must also beat the worst covisible neighbor's
    # BoW score (the ORB-SLAM2-era DetectLoop minScore). The production
    # ORB-SLAM3 path this build follows (NewDetectCommonRegions,
    # LoopClosing.cc:491: DetectNBestCandidates(3) with NO score floor)
    # relies on the geometric cascade + 3-coincidence consistency instead —
    # in self-similar scenes the covisible floor suppresses TRUE revisits
    # (neighbors look as alike as the revisit does).
    use_min_score_floor = False

    def _after_probe(self, m: ms.MapState, kf_id: int, ids, scores, covis_w,
                     cam_params, min_score: float = 0.0,
                     n_bow=None) -> ms.MapState:
        cand = int(ids[0])
        floor = max(0.015, min_score) if self.use_min_score_floor else 0.015
        if cand < 0 or float(scores[0]) <= floor:
            self.consistency_count = 0
            return m

        # temporal consistency: 3 consecutive keyframes whose candidate
        # group overlaps the previous one (mnLoopNumCoincidences >= 3,
        # LoopClosing.cc:396+). covis_w[0] = covisibility of the new
        # candidate with the PREVIOUS consistent candidate (probe pack);
        # nearby-id candidates count too (dense keyframing makes adjacent
        # ids covisible by construction).
        if self.consistent_candidate >= 0 and \
                (covis_w[0] > 0 or abs(cand - self.consistent_candidate) <= 5):
            self.consistency_count += 1
        else:
            self.consistency_count = 1
        Verbose.log(f"[loop] KF {kf_id}: cand {cand} score "
                    f"{float(scores[0]):.3f} covis_prev {float(covis_w[0]):.0f} "
                    f"(prev {self.consistent_candidate}) "
                    f"count {self.consistency_count}", lvl=2)
        self.consistent_candidate = cand
        if self.consistency_count < self.consistency_needed:
            return m
        # BoW-match gate from the probe pack (nBoWMatches >= 20,
        # LoopClosing.cc:581): perceptual-aliasing candidates — high BoW
        # score, no geometric support — die HERE with zero device round
        # trips (the count was computed inside the fused probe)
        if n_bow is not None and 0 <= n_bow < self.min_matches:
            return m

        # geometric verification cascade (DetectCommonRegionsFromBoW,
        # LoopClosing.cc:583-800): BoW matches >= 20 -> Sim3 RANSAC >= 15
        # inliers -> coarse projection of the loop neighborhood >= nProj ->
        # SearchBySim3 grow + OptimizeSim3 >= 20 -> fine projection through
        # the optimized Sim3 >= nProjOpt. The projection stages are what
        # kill perceptual-aliasing false positives: a spurious Sim3 cannot
        # re-project a whole neighborhood of landmarks consistently.
        fix_scale = self.fix_scale or self.inertial
        cfg_cam = self.cfg.camera
        fs = float(m.n_feat) / self.REF_FEAT_BUDGET
        proj_th = max(self.PROJ_FLOOR, round(self.PROJ_MATCHES * fs))
        proj_opt_th = max(self.PROJ_OPT_FLOOR,
                          round(self.PROJ_OPT_MATCHES * fs))
        # the whole cascade as ONE executable + ONE fetch (it used to be ~6
        # blocking round trips serialized against the tracker's frames);
        # the gate ladder below is unchanged (LoopClosing.cc:583-800)
        pack = np.asarray(verify_loop_fused(
            m, jnp.int32(kf_id), jnp.int32(cand), cam_params,
            cam_model=cfg_cam.model_id, img_w=cfg_cam.width,
            img_h=cfg_cam.height, n_levels=self.cfg.orb.n_levels,
            fix_scale=fix_scale))
        n_match, n_inl, n_proj, n_inlo, n_proj2 = (
            int(pack[0]), int(pack[1]), int(pack[2]), int(pack[3]),
            int(pack[4]))
        R12 = jnp.asarray(pack[5:14].reshape(3, 3))
        t12 = jnp.asarray(pack[14:17])
        s12 = jnp.float32(pack[17])
        phi = pack[18:21]
        if n_match < self.min_matches:
            return m
        if n_inl < self.RANSAC_INLIERS:
            return m
        # coarse neighborhood reprojection gate (th=8, nProjMatches)
        if n_proj < proj_th:
            Verbose.log(f"[loop] {kf_id}->{cand} rejected: coarse "
                        f"reprojection {n_proj} < {proj_th}")
            self.consistency_count = 0
            return m
        # OptimizeSim3 inliers after the SearchBySim3 grow
        if n_inlo < self.min_inliers:
            return m
        # fine neighborhood reprojection through the OPTIMIZED Sim3 (th=5,
        # nProjOptMatches — LoopClosing.cc:791)
        if n_proj2 < proj_opt_th:
            Verbose.log(f"[loop] {kf_id}->{cand} rejected: fine "
                        f"reprojection {n_proj2} < {proj_opt_th}")
            self.consistency_count = 0
            return m

        if self.inertial:
            # inertial sanity gates (LoopClosing.cc:144-163): the correction
            # must not bend scale (observable from the IMU) and must be
            # yaw-dominant — gravity alignment pins pitch/roll, so a loop
            # hypothesis demanding a big pitch/roll correction is spurious
            if not (0.9 < float(s12) < 1.1):
                Verbose.log(f"[loop] inertial scale gate rejected s={float(s12):.3f}")
                self.consistency_count = 0
                return m
            # pitch/roll (x, z — yaw is about the gravity axis y) < 0.008
            if abs(float(phi[0])) > 0.008 or abs(float(phi[2])) > 0.008:
                Verbose.log(f"[loop] inertial yaw-only gate rejected "
                            f"phi={phi.round(4).tolist()}")
                self.consistency_count = 0
                return m

        Verbose.log(f"[loop] correcting {kf_id}->{cand}: score "
                    f"{float(scores[0]):.3f} (minScore {min_score:.3f}), "
                    f"{n_inlo} sim3 inliers, s={float(s12):.3f}")
        m = self.correct(m, kf_id, cand, (R12, t12, s12))
        self.last_loop_kf = kf_id
        self.consistency_count = 0
        self.n_loops += 1

        # full-map BA after the essential-graph correction
        # (RunGlobalBundleAdjustment, LoopClosing.cc:1206); in async mode the
        # tracker spawns it on the GBA thread instead
        if self.gba_iters > 0 and not self.async_gba:
            from .map_ba import global_bundle_adjust_auto
            self.abort_gba = False
            m = global_bundle_adjust_auto(
                m, cam_params, bf=float(self.cfg.bf),
                cam_model=self.cfg.camera.model_id,
                n_iters=self.gba_iters, chunk=5,
                n_ba_points=min(int(m.max_mp), 4096),
                should_abort=lambda: self.abort_gba)
        return m

    def correct(self, m: ms.MapState, kf_cur: int, kf_loop: int, S12) -> ms.MapState:
        """CorrectLoop (LoopClosing.cc:969): set the corrected current pose,
        then optimize the essential graph with the loop edge and re-anchor
        landmarks."""
        R12, t12, s12 = S12  # S12: loop-KF-camera <- current-KF-camera? No:
        # match_kf_landmarks returned (p_cur_cam, p_loop_cam); sim3 maps
        # loop-cam points INTO the current camera: p_cur ~ S12 p_loop.
        K = m.max_kf
        old_R, old_t = m.kf_R, m.kf_t
        s_ones = jnp.ones(K, jnp.float32)

        # corrected current pose: p_cur ~ S12 p_loop, so
        # S_cur_w(corrected) = S12 o T_loop_w (the loop KF is trusted)
        Rl, tl = m.kf_R[kf_loop], m.kf_t[kf_loop]
        Rc_new, tc_new, sc_new = lie.sim3_compose(
            R12, t12, s12, Rl, tl, jnp.float32(1.0))

        # edge list: covisibility/sequential edges + ALL previously-stored
        # loop edges (KeyFrame::mspLoopEdges re-entering every
        # OptimizeEssentialGraph, Optimizer.cc:1511) + the new loop edge with
        # the corrected relative measurement
        e_i, e_j, e_valid = essential_edges(m)
        # fixed-capacity historical-loop-edge block (static shapes: one
        # compiled pose-graph signature regardless of how many loops closed)
        cap = self.LOOP_EDGE_CAP
        hist = self.loop_edges[-cap:]
        old_i = np.zeros(cap, np.int32)
        old_j = np.zeros(cap, np.int32)
        old_v = np.zeros(cap, bool)
        for n, (i, j) in enumerate(hist):
            old_i[n], old_j[n], old_v[n] = i, j, True
        old_i, old_j = jnp.asarray(old_i), jnp.asarray(old_j)
        e_i = jnp.concatenate([e_i, old_i])
        e_j = jnp.concatenate([e_j, old_j])
        e_valid = jnp.concatenate([
            e_valid, jnp.asarray(old_v) & m.kf_valid[old_i] & m.kf_valid[old_j]])
        Rrel, trel, srel = pose_graph.relative_sim3(
            Rc_new, tc_new, sc_new, Rl, tl, jnp.float32(1.0))
        # append loop edge (i=loop, j=cur): S_j S_i^-1 = Scur Sloop^-1
        e_i = jnp.concatenate([e_i, jnp.asarray([kf_loop], jnp.int32)])
        e_j = jnp.concatenate([e_j, jnp.asarray([kf_cur], jnp.int32)])
        e_valid = jnp.concatenate([e_valid, jnp.asarray([True])])
        e_R = jnp.concatenate([
            jax.vmap(lambda i, j: pose_graph.relative_sim3(
                m.kf_R[j], m.kf_t[j], jnp.float32(1.0),
                m.kf_R[i], m.kf_t[i], jnp.float32(1.0))[0])(e_i[:-1], e_j[:-1]),
            Rrel[None]])
        e_t = jnp.concatenate([
            jax.vmap(lambda i, j: pose_graph.relative_sim3(
                m.kf_R[j], m.kf_t[j], jnp.float32(1.0),
                m.kf_R[i], m.kf_t[i], jnp.float32(1.0))[1])(e_i[:-1], e_j[:-1]),
            trel[None]])
        e_s = jnp.concatenate([
            jnp.ones(e_i.shape[0] - 1, jnp.float32), srel[None].reshape(1)])
        self.loop_edges.append((int(kf_loop), int(kf_cur)))

        fixed = jnp.zeros(K, bool).at[kf_loop].set(True)
        # seed the current KF at its corrected pose so the graph pulls the
        # rest of the trajectory toward the loop closure
        kf_R0 = m.kf_R.at[kf_cur].set(Rc_new)
        kf_t0 = m.kf_t.at[kf_cur].set(tc_new)
        kf_s0 = s_ones.at[kf_cur].set(sc_new)

        # inertial maps: 4-DoF yaw+translation graph (the IMU pins scale,
        # pitch and roll — OptimizeEssentialGraph4DoF, Optimizer.cc:5338);
        # pure-visual maps: full 7-DoF Sim3 (Optimizer.cc:1511)
        mode = "4dof" if self.inertial else "sim3"
        new_R, new_t, new_s = pose_graph.optimize_pose_graph(
            kf_R0, kf_t0, kf_s0, m.kf_valid, fixed,
            e_i, e_j, e_R, e_t, e_s, e_valid, mode=mode, n_iters=15)
        m2 = apply_pose_graph_result(m, new_R, new_t, new_s, old_R, old_t)
        # rigid delta of the current KF's pose (for in-flight frame poses
        # tracked against the pre-correction world) — device-side; fetched
        # by the consumer only when a loop actually fired
        oRc, oTc = old_R[kf_cur], old_t[kf_cur]
        nRc, nTc = m2.kf_R[kf_cur], m2.kf_t[kf_cur]
        self.last_delta = (oRc.T @ nRc, oRc.T @ (nTc - oTc))
        return m2

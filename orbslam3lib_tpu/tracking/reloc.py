"""Relocalization: BoW candidate retrieval + batched PnP RANSAC + pose refine.

Replacement for the reference's relocalization path
(/root/reference app/src/main/cpp/src/Tracking.cc:3670 Relocalization():
KeyFrameDatabase::DetectRelocalizationCandidates -> SearchByBoW ->
MLPnPsolver::iterate RANSAC -> PoseOptimization -> projection refine).

The sequential early-exit RANSAC of MLPnPsolver becomes a fully batched
hypothesis sweep (SURVEY.md §7 "RANSAC loops: batched hypothesis evaluation
vmapped over K hypotheses"): each hypothesis solves a 6-point DLT for the
projection matrix, decomposes it to (R, t), and all hypotheses score all
correspondences at once. The winner seeds the standard pose LM.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import cameras, lie
from .pose_opt import PoseObs, pose_optimization


def _p6p_dlt(p3d: jnp.ndarray, xy_norm: jnp.ndarray):
    """Solve [R|t] from >=6 3D-2D correspondences (normalized camera coords)
    by DLT on the 3x4 projection matrix + orthonormalization.

    p3d (S,3), xy_norm (S,2). Returns (R (3,3), t (3,))."""
    S = p3d.shape[0]
    X = jnp.concatenate([p3d, jnp.ones((S, 1))], axis=1)       # (S,4)
    zeros = jnp.zeros((S, 4))
    u = xy_norm[:, 0:1]
    v = xy_norm[:, 1:2]
    rows_u = jnp.concatenate([X, zeros, -u * X], axis=1)        # (S,12)
    rows_v = jnp.concatenate([zeros, X, -v * X], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)               # (2S,12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    P = vt[-1].reshape(3, 4)
    M = P[:, :3]
    # sign: points must be in front -> mean depth positive
    depths = X @ P[2]
    sign = jnp.where(jnp.mean(depths) < 0, -1.0, 1.0)
    P = P * sign
    M = P[:, :3]
    # orthonormalize M -> R via SVD; scale = mean singular value
    U, D, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    Dfix = jnp.diag(jnp.asarray([1.0, 1.0, 1.0]) * jnp.stack(
        [jnp.float32(1.0), jnp.float32(1.0), det]))
    R = U @ Dfix @ Vt
    scale = jnp.mean(D)
    t = P[:, 3] / jnp.maximum(scale, 1e-9)
    return R, t


@partial(jax.jit, static_argnames=("cam_model", "n_hyp", "sample_size"))
def pnp_ransac(p_world, uv, valid, cam_params, cam_model: int = cameras.PINHOLE,
               n_hyp: int = 128, sample_size: int = 6,
               inlier_px: float = 5.991 ** 0.5 * 2.0, seed: int = 0):
    """Batched PnP RANSAC. Returns (R, t, inlier_mask, n_inliers).

    All hypotheses are solved and scored in parallel (vmap); the best seeds
    nothing further here — callers refine with pose_optimization.
    """
    M = p_world.shape[0]
    key = jax.random.PRNGKey(seed)
    # sample with probability weighted by validity
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, M, shape=(n_hyp, sample_size), p=probs)

    xy_norm = cameras.unproject(cam_model, cam_params, uv)[..., :2]

    def solve(sample_idx):
        return _p6p_dlt(p_world[sample_idx], xy_norm[sample_idx])

    Rs, ts = jax.vmap(solve)(idx)                                # (H,3,3),(H,3)

    # score all hypotheses against all points
    p_c = jnp.einsum("hij,mj->hmi", Rs, p_world) + ts[:, None, :]
    uv_hat = cameras.project(cam_model, cam_params, p_c)
    err2 = jnp.sum((uv_hat - uv[None, :, :]) ** 2, axis=-1)      # (H,M)
    front = p_c[..., 2] > 0.05
    ok = (err2 < inlier_px ** 2) & front & valid[None, :]
    scores = jnp.sum(ok, axis=1)
    best = jnp.argmax(scores)
    return Rs[best], ts[best], ok[best], scores[best]


@partial(jax.jit, static_argnames=("cam_model", "img_w", "img_h", "n_levels"))
def relocalize_against_kf(m, kf_id, feat_xy, feat_level, feat_desc,
                          feat_valid, feat_angle, cam_params,
                          cam_model: int = cameras.PINHOLE,
                          img_w: int = 640, img_h: int = 400,
                          n_levels: int = 8):
    """One relocalization attempt against one candidate keyframe, with the
    reference's full refinement chain (Tracking::Relocalization,
    Tracking.cc:3670+): SearchByBoW-style matching (ratio 0.75, rotation
    histogram) -> PnP RANSAC -> pose LM -> projection search over the
    candidate's map region (radius 10, TH_HIGH) -> re-optimize. Returns
    (R, t, n_inliers); callers gate at >=50 (the reference's nGood gate).
    """
    from ..mapping.local_mapping import observed_mp_mask
    from .matching import (match_descriptors_ratio, rotation_consistency,
                           search_by_projection)

    k = jnp.clip(kf_id, 0, m.max_kf - 1)
    F = feat_desc.shape[0]
    P = m.max_mp
    kf_has_mp = (m.kf_mp[k] >= 0) & m.kf_feat_valid[k]
    idx, ok = match_descriptors_ratio(feat_desc, feat_valid, m.kf_desc[k],
                                      kf_has_mp, th=100.0, ratio=0.75)
    ok = rotation_consistency(
        feat_angle, m.kf_angle[k][jnp.clip(idx, 0, F - 1)], ok)
    mp_ids = m.kf_mp[k][jnp.clip(idx, 0, F - 1)]
    mp_ids_c = jnp.clip(mp_ids, 0, P - 1)
    good = ok & (mp_ids >= 0) & m.mp_valid[mp_ids_c]
    p_w = m.mp_pos[mp_ids_c]

    R0, t0, inl, n0 = pnp_ransac(p_w, feat_xy, good, cam_params,
                                 cam_model=cam_model)
    obs = PoseObs(p_world=p_w, uv=feat_xy,
                  inv_sigma2=jnp.ones(F, jnp.float32),
                  u_right=jnp.zeros(F, jnp.float32),
                  is_stereo=jnp.zeros(F, bool),
                  valid=good & inl)
    R1, t1, inl1, n1 = pose_optimization(R0, t0, obs, cam_params,
                                         cam_model=cam_model)

    # projection-refine loop (Tracking.cc:3744+: SearchByProjection over the
    # candidate's points with a 10 px window when nGood < 50, then re-opt)
    cand = observed_mp_mask(m, jnp.asarray([k]).reshape(1))
    pm = search_by_projection(
        m.mp_pos, m.mp_desc, cand, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
        R1, t1, cam_params, feat_xy, feat_level, feat_desc, feat_valid,
        radius=10.0, cam_model=cam_model, img_w=img_w, img_h=img_h,
        th_desc=100.0, n_levels=n_levels)
    matched = pm.mp_feat >= 0
    tgt = jnp.where(matched, pm.mp_feat, F)
    feat_mp = jnp.full(F, -1, jnp.int32).at[tgt].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop")
    has2 = feat_mp >= 0
    obs2 = PoseObs(p_world=m.mp_pos[jnp.clip(feat_mp, 0, P - 1)],
                   uv=feat_xy,
                   inv_sigma2=jnp.ones(F, jnp.float32),
                   u_right=jnp.zeros(F, jnp.float32),
                   is_stereo=jnp.zeros(F, bool),
                   valid=has2)
    R2, t2, inl2, n2 = pose_optimization(R1, t1, obs2, cam_params,
                                         cam_model=cam_model)
    use2 = n2 > n1
    R = jnp.where(use2, R2, R1)
    t = jnp.where(use2, t2, t1)
    return R, t, jnp.maximum(n1, n2)


@partial(jax.jit, static_argnames=("cam_model", "bf", "n_levels"))
def track_reference_kf(m, kf_id, R0, t0, feat_xy, feat_level, feat_desc,
                       feat_valid, feat_angle, u_right, depth, cam_params,
                       cam_model: int = cameras.PINHOLE, bf: float = 0.0,
                       n_levels: int = 8):
    """TrackReferenceKeyFrame (Tracking.cc:2778): when motion-model tracking
    fails, match the frame to the reference keyframe's landmark-bearing
    features (SearchByBoW semantics: ratio 0.7, TH_LOW, rotation histogram)
    and pose-optimize seeded at the LAST frame's pose. Returns
    (R, t, n_inliers)."""
    from ..mapping.map_ba import inv_sigma2 as _inv_s2
    from .matching import match_descriptors_ratio, rotation_consistency

    k = jnp.clip(kf_id, 0, m.max_kf - 1)
    F = feat_desc.shape[0]
    P = m.max_mp
    kf_has_mp = (m.kf_mp[k] >= 0) & m.kf_feat_valid[k]
    idx, ok = match_descriptors_ratio(feat_desc, feat_valid, m.kf_desc[k],
                                      kf_has_mp, th=50.0, ratio=0.7)
    ok = rotation_consistency(
        feat_angle, m.kf_angle[k][jnp.clip(idx, 0, F - 1)], ok)
    mp_ids = m.kf_mp[k][jnp.clip(idx, 0, F - 1)]
    mp_ids_c = jnp.clip(mp_ids, 0, P - 1)
    good = ok & (mp_ids >= 0) & m.mp_valid[mp_ids_c]
    obs = PoseObs(p_world=m.mp_pos[mp_ids_c],
                  uv=feat_xy,
                  inv_sigma2=_inv_s2(feat_level, n_levels),
                  u_right=jnp.where(depth > 0, u_right, 0.0),
                  is_stereo=good & (depth > 0),
                  valid=good)
    R, t, inl, n_inl = pose_optimization(R0, t0, obs, cam_params,
                                         cam_model=cam_model, bf=bf)
    return R, t, n_inl


@partial(jax.jit, static_argnames=("n_best", "n_covis"))
def detect_reloc_candidates(m, bow_db, active, q, n_best: int = 3,
                            n_covis: int = 10):
    """KeyFrameDatabase::DetectRelocalizationCandidates
    (KeyFrameDatabase.cc): candidate gating beyond a plain top-N score
    query. (1) shared-words gate: only keyframes sharing >= 0.8x the
    maximum common-word count with the query stay candidates; (2)
    covisibility accumulation: each candidate's score is accumulated over
    its best covisible neighbors, groups below 0.75x the best accumulated
    score are dropped, and each surviving group is represented by its
    best-scoring member. One fused executable: word intersection + L1
    scores + the covisibility matmul.

    Returns (ids (n_best,), acc_scores (n_best,)), ids -1-padded."""
    from ..models import map_state as ms
    from ..models.vocabulary import l1_scores

    K = m.max_kf
    s = l1_scores(bow_db, q)
    common = (bow_db > 0).astype(jnp.float32) @ (q > 0).astype(jnp.float32)
    act = active & m.kf_valid
    max_c = jnp.max(jnp.where(act, common, 0.0))
    cand = act & (common >= 0.8 * max_c) & (common > 0)
    s_c = jnp.where(cand, s, 0.0)

    O = ms.observation_matrix(m)                    # (K, P)
    C = O @ O.T
    C = C * (1.0 - jnp.eye(K, dtype=C.dtype))       # zero the diagonal
    top_w, top_i = jax.lax.top_k(C, n_covis)        # best covisibles per KF
    nb_ok = (top_w > 0).astype(jnp.float32)
    acc = s_c + jnp.sum(s_c[top_i] * nb_ok, axis=1)
    acc = jnp.where(cand, acc, -1.0)
    best_acc = jnp.max(acc)
    keep = cand & (acc >= 0.75 * best_acc)

    # each group's best-scoring member (the reference's pBestKF)
    grp = jnp.concatenate([jnp.arange(K)[:, None], top_i], axis=1)  # (K, 1+n)
    grp_s = jnp.concatenate([s_c[:, None], s_c[top_i] * nb_ok], axis=1)
    best_member = grp[jnp.arange(K), jnp.argmax(grp_s, axis=1)]

    acc_k = jnp.where(keep, acc, -1.0)
    top_acc, top_gi = jax.lax.top_k(acc_k, n_best)
    ids = jnp.where(top_acc > 0, best_member[top_gi], -1)
    return ids.astype(jnp.int32), top_acc


def make_place_recognition(voc, max_kf: int, prefer_native: bool = True):
    """Factory: the native C++ inverted-file database when available (the
    reference's KeyFrameDatabase is host C++ — SURVEY.md §7 flags BoW descent
    as host-CPU work), else the dense JAX implementation. Both expose the
    same add()/query()/.voc contract and are oracle-tested against each
    other (tests/test_native_bow.py). Env ORBSLAM3_TPU_NATIVE_BOW=0 forces
    the JAX path."""
    import os
    if prefer_native and os.environ.get("ORBSLAM3_TPU_NATIVE_BOW", "1") != "0":
        try:
            from ..native import NativeBowDatabase, load_library
            if load_library() is not None:
                db = NativeBowDatabase(voc, max_kf)
                db.voc = voc
                return db
        except Exception:
            pass
    return PlaceRecognition(voc, max_kf)


class PlaceRecognition:
    """Dense BoW keyframe database (the KeyFrameDatabase equivalent).

    Holds a (max_kf, W) tf-idf matrix; add() on keyframe insert, query()
    returns top-N candidate keyframe ids by DBoW2 L1 score."""

    def __init__(self, voc, max_kf: int):
        from ..models import vocabulary as vb
        self.voc = voc
        self.vb = vb
        self.bow_db = jnp.zeros((max_kf, voc.n_words), jnp.float32)
        self.active = jnp.zeros(max_kf, bool)

    def add(self, kf_id: int, desc_bits, valid):
        v = self.vb.bow_from_descriptors(self.voc, desc_bits, valid)
        self.bow_db = self.bow_db.at[kf_id].set(v)
        self.active = self.active.at[kf_id].set(True)

    def query(self, desc_bits, valid, exclude_mask=None, n_best: int = 3):
        """Returns (ids (n_best,), scores (n_best,)) best-first."""
        q = self.vb.bow_from_descriptors(self.voc, desc_bits, valid)
        s = self.vb.l1_scores(self.bow_db, q)
        s = jnp.where(self.active, s, -1.0)
        if exclude_mask is not None:
            s = jnp.where(exclude_mask, -1.0, s)
        top_s, top_i = jax.lax.top_k(s, n_best)
        return top_i, top_s

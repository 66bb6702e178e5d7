"""Local mapping ops: new-landmark triangulation, landmark/keyframe culling,
duplicate fusion.

Re-design of the reference's LocalMapping thread body
(/root/reference app/src/main/cpp/src/LocalMapping.cc): CreateNewMapPoints
(:394 — epipolar SearchForTriangulation with covisible KFs, parallax /
positive-depth / reprojection / scale-consistency gates), MapPointCulling
(:352 — found/visible ratio < 0.25 or too few observations while young),
SearchInNeighbors (:726 — ORBmatcher::Fuse both directions with
MapPoint::Replace), KeyFrameCulling (:914 — >=90% redundant observations).

Everything is fixed-shape masked tensor math over the MapState arrays:
  * pair matching + epipolar gating are (F, F) arithmetic-gate matrices with
    the Hamming matmul (same pattern as tracking/matching.py);
  * triangulation is the batched DLT of utils/cameras.py;
  * culling decisions are pure elementwise passes over the landmark arrays;
  * MapPoint::Replace becomes a replace-table gather over kf_mp.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models import map_state as ms
from ..ops.masks import BIG, is_finite_match, leq_int, penalize, step01
from ..ops.matcher import hamming_matrix
from ..ops.pyramid import scale_factors
from ..utils import cameras, lie


@partial(jax.jit, static_argnames=("n",))
def top_covisible(m: ms.MapState, kf_id, n: int = 10):
    """Top-n covisible keyframes of kf_id by shared-observation weight
    (KeyFrame::GetBestCovisibilityKeyFrames, KeyFrame.h:81). One matmul
    for the covisibility row; ids are -1 where no covisible KF exists."""
    O = ms.observation_matrix(m)                 # (K, P)
    row = O @ O[jnp.clip(kf_id, 0, m.max_kf - 1)]
    row = jnp.where(jnp.arange(m.max_kf) == kf_id, 0.0, row)
    row = row * m.kf_valid
    top_w, top_i = jax.lax.top_k(row, n)
    return jnp.where(top_w > 0, top_i.astype(jnp.int32), -1)


@partial(jax.jit, static_argnames=("n_win", "n_fixed"))
def covis_ba_window(m: ms.MapState, kf_id, n_win: int, n_fixed: int):
    """Local-BA window by covisibility (Optimizer.cc:1124 semantics): the
    current KF + its best covisible neighbors are optimizable; the OLDEST
    n_fixed members of the selection anchor the gauge (the reference fixes
    the non-window observers; the oldest covisible members are exactly the
    ones most constrained by the rest of the map).

    Returns (ids (n_fixed+n_win,), fixed (n_fixed+n_win,) bool), -1-padded,
    ordered oldest-first so fixed slots lead."""
    C = n_fixed + n_win
    nbrs = top_covisible(m, kf_id, C - 1)
    BIGID = jnp.int32(10 ** 9)
    sel = jnp.concatenate([jnp.where(nbrs >= 0, nbrs, BIGID),
                           jnp.asarray(kf_id, jnp.int32).reshape(1)])
    sel = jnp.sort(sel)                          # oldest first, pads last
    ids = jnp.where(sel < BIGID, sel, -1)
    fixed = jnp.arange(C) < n_fixed
    return ids, fixed


@jax.jit
def observed_mp_mask(m: ms.MapState, kf_ids) -> jnp.ndarray:
    """(P,) bool: landmarks observed by any of kf_ids (-1 entries ignored)."""
    ids = jnp.clip(kf_ids, 0, m.max_kf - 1)
    rows = m.kf_mp[ids]                          # (A, F)
    ok = (kf_ids[:, None] >= 0) & (rows >= 0) & m.kf_feat_valid[ids]
    tgt = jnp.where(ok, rows, m.max_mp)
    mask = jnp.zeros(m.max_mp + 1, bool).at[tgt.reshape(-1)].set(
        True, mode="drop")
    return mask[:m.max_mp] & m.mp_valid


def _tri_pair_candidates(m: ms.MapState, kf_a, kf_b, cam_params,
                         cam_model: int, n_levels: int,
                         nn_ratio: float, th_desc: float, epi_sigma: float,
                         th_far=None):
    """Pure candidate stage of triangulate_pair: match + triangulate + gate,
    NO map mutation. Returns (want (F,), p_w (F,3), best (F,), cosp (F,),
    normal (F,3), min_dist (F,), max_dist (F,)) — vmappable over kf_b for
    the fused multi-neighbor pass."""
    F = m.n_feat
    a = jnp.clip(kf_a, 0, m.max_kf - 1)
    b = jnp.clip(kf_b, 0, m.max_kf - 1)
    Ra, ta = m.kf_R[a], m.kf_t[a]
    Rb, tb = m.kf_R[b], m.kf_t[b]
    free_a = m.kf_feat_valid[a] & (m.kf_mp[a] < 0)
    free_b = m.kf_feat_valid[b] & (m.kf_mp[b] < 0)

    # relative pose cam_a <- cam_b and baseline gate (LocalMapping.cc:441:
    # baseline must exceed scene-scale threshold; we gate on |t| > 1e-3)
    Rab = Ra @ Rb.T
    tab = ta - Rab @ tb
    E = lie.hat(tab) @ Rab  # essential: x_a^T E x_b = 0

    ray_a = cameras.unproject(cam_model, cam_params, m.kf_xy[a])  # (F,3)
    ray_b = cameras.unproject(cam_model, cam_params, m.kf_xy[b])

    # epipolar distance of ray_b to the line E^T ray_a, in normalized coords
    l_b = ray_a @ E                         # (F,3) line coeffs for cam_b
    num = jnp.abs(jnp.einsum("ac,bc->ab", l_b, ray_b))
    den = jnp.sqrt(l_b[:, 0:1] ** 2 + l_b[:, 1:2] ** 2 + 1e-12)
    fx = cam_params[0]
    epi_px = (num / den) * fx               # approx pixel distance
    sf = jnp.asarray(scale_factors(n_levels))
    sig_b = sf[jnp.clip(m.kf_level[b], 0, n_levels - 1)]
    g_epi = step01(3.84 * epi_sigma * sig_b[None, :] - epi_px + 0.5)

    d = hamming_matrix(m.kf_desc[a], m.kf_desc[b])
    g = g_epi * leq_int(d, th_desc)
    g = g * free_a.astype(jnp.float32)[:, None] * free_b.astype(jnp.float32)[None, :]
    dm = penalize(d, g)
    # kNN-2 ratio test along b
    best = jnp.argmin(dm, axis=1)
    d1 = jnp.min(dm, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, dm.shape, 1)
    not_best = step01(jnp.abs(cols - best[:, None]).astype(jnp.float32))
    d2 = jnp.min(dm + (1.0 - not_best) * BIG, axis=1)
    has = is_finite_match(d1) * step01((nn_ratio * d2 - d1) + 0.5)

    # triangulate matches in cam_a frame
    rb_sel = ray_b[best]
    p_a, cosp, z1, z2 = cameras.triangulate_two_view(
        ray_a, rb_sel, jnp.broadcast_to(Rab, (F, 3, 3)),
        jnp.broadcast_to(tab, (F, 3)))
    # reprojection gates in both views
    uv_a = cameras.project(cam_model, cam_params, p_a)
    p_b = jnp.einsum("ij,fj->fi", Rab.T, p_a - tab)
    uv_b = cameras.project(cam_model, cam_params, p_b)
    err_a = jnp.sum((uv_a - m.kf_xy[a]) ** 2, axis=-1)
    err_b = jnp.sum((uv_b - m.kf_xy[b][best]) ** 2, axis=-1)
    sig_a = sf[jnp.clip(m.kf_level[a], 0, n_levels - 1)]
    ok = has
    ok = ok * step01((0.9998 - cosp) * 1e5)          # parallax gate
    ok = ok * step01((z1 - 0.05) * 20.0) * step01((z2 - 0.05) * 20.0)
    ok = ok * step01(5.991 * sig_a ** 2 - err_a + 0.5)
    ok = ok * step01(5.991 * (sig_a[best] ** 2) - err_b + 0.5)
    ok = ok * step01(jnp.linalg.norm(tab) * 1e3)      # degenerate baseline
    # scale consistency (LocalMapping.cc: ratioDist vs ratioOctave*1.5)
    Rwa, ca = lie.se3_inverse(Ra, ta)
    p_w = lie.se3_apply(Rwa, ca, p_a)
    Rwb_, cb = lie.se3_inverse(Rb, tb)
    dist_a = jnp.linalg.norm(p_w - ca, axis=-1)
    dist_b = jnp.linalg.norm(p_w - cb, axis=-1)
    ratio_d = dist_a / jnp.maximum(dist_b, 1e-6)
    ratio_o = sig_a / jnp.maximum(sig_b[best], 1e-6)
    ok = ok * step01((ratio_d - ratio_o / 1.5) * 8.0)
    ok = ok * step01((ratio_o * 1.5 - ratio_d) * 8.0)
    if th_far is not None:
        # thFarPoints depth cut (System.cc:174-184 -> LocalMapping.cc:696
        # "if(mbFarPoints && (dist1>=mThFarPoints||dist2>=mThFarPoints))"):
        # both view distances must be under the threshold; <=0 disables
        far_ok = jnp.where(th_far > 0,
                           step01((th_far - dist_a) * 8.0)
                           * step01((th_far - dist_b) * 8.0), 1.0)
        ok = ok * far_ok
    # neighbor validity gate (covisibility lists pad with -1; self-pairs
    # and culled neighbors are no-ops); integer-exact gates
    ok = ok * step01(kf_b.astype(jnp.float32) + 1.0) \
            * step01(jnp.abs(kf_a - kf_b).astype(jnp.float32)) \
            * m.kf_valid[b].astype(jnp.float32)

    # rotation-consistency histogram (ORBmatcher.cc:36-38, applied by
    # SearchForTriangulation's CheckOrientation)
    from ..tracking.matching import rotation_consistency
    want = rotation_consistency(m.kf_angle[a], m.kf_angle[b][best], ok > 0.5)
    normal = (p_w - ca) / jnp.maximum(dist_a[:, None], 1e-9)
    max_dist = dist_a * sig_a
    min_dist = max_dist / sf[n_levels - 1]
    return want, p_w, best, cosp, normal, min_dist, max_dist


@partial(jax.jit, static_argnames=("cam_model", "n_levels"))
def triangulate_pair(m: ms.MapState, kf_a, kf_b, cam_params,
                     cam_model: int = cameras.PINHOLE, n_levels: int = 8,
                     nn_ratio: float = 0.6, th_desc: float = 50.0,
                     epi_sigma: float = 1.0, th_far=None):
    """Match unassociated features of keyframes a,b and triangulate new
    landmarks; spawn them bound to kf_a's feature slots.

    Reference semantics: LocalMapping::CreateNewMapPoints (LocalMapping.cc:394)
    + ORBmatcher::SearchForTriangulation (ORBmatcher.cc:908) with ratio 0.6,
    epipolar-line gate, cos-parallax < 0.9998, positive depths, chi2 reproj
    gates (5.991 sigma), scale-consistency ratio 1.5 * scaleFactor.
    """
    F = m.n_feat
    a = jnp.clip(kf_a, 0, m.max_kf - 1)
    b = jnp.clip(kf_b, 0, m.max_kf - 1)
    want, p_w, best, cosp, normal, min_dist, max_dist = _tri_pair_candidates(
        m, kf_a, kf_b, cam_params, cam_model, n_levels, nn_ratio, th_desc,
        epi_sigma, th_far)
    m2 = ms.spawn_mappoints(m, a, p_w, m.kf_desc[a], normal, min_dist,
                            max_dist, want, jnp.arange(F))
    # also bind the observation in kf_b (AddObservation second view)
    new_ids = m2.kf_mp[a]
    row_b = m2.kf_mp[b]
    bind_b = want & (row_b[best] < 0)
    tgt = jnp.where(bind_b, best, F)
    row_b2 = row_b.at[tgt].set(jnp.where(bind_b, new_ids, -1), mode="drop")
    m2 = m2._replace(kf_mp=m2.kf_mp.at[b].set(jnp.where(row_b2 >= 0, row_b2, row_b)))
    return m2, jnp.sum(want.astype(jnp.int32))


@partial(jax.jit, static_argnames=("cam_model", "n_levels", "n_nbrs"))
def triangulate_with_neighbors(m: ms.MapState, kf_a, nbrs, cam_params,
                               cam_model: int = cameras.PINHOLE,
                               n_levels: int = 8, n_nbrs: int = 10,
                               nn_ratio: float = 0.6, th_desc: float = 50.0,
                               epi_sigma: float = 1.0, th_far=None):
    """CreateNewMapPoints against ALL covisible neighbors in ONE executable.

    The reference loops its nn=10 neighbors sequentially
    (LocalMapping.cc:394); as 10 separate jit launches the mapper thread
    holds the single device stream for ~10 launch latencies per keyframe,
    stalling the tracker's frame chunks. Here the candidate stage is
    vmapped over the neighbor axis and the spawn happens ONCE: a feature
    slot triangulated by several neighbors keeps the best-conditioned pair
    (smallest cos-parallax) — the reference achieves the same dedup
    sequentially via its first-come spawn + later fuse.

    Returns (new map, n_spawned)."""
    F = m.n_feat
    a = jnp.clip(kf_a, 0, m.max_kf - 1)

    def cand(b):
        return _tri_pair_candidates(m, kf_a, b, cam_params, cam_model,
                                    n_levels, nn_ratio, th_desc, epi_sigma,
                                    th_far)

    want, p_w, best, cosp, normal, min_dist, max_dist = jax.vmap(cand)(nbrs)
    # per-feature best neighbor by parallax conditioning
    score = jnp.where(want, cosp, 2.0)                 # (Nn, F)
    sel = jnp.argmin(score, axis=0)                    # (F,)
    any_want = jnp.any(want, axis=0)
    iF = jnp.arange(F)
    p_sel = p_w[sel, iF]
    n_sel = normal[sel, iF]
    mind_sel = min_dist[sel, iF]
    maxd_sel = max_dist[sel, iF]
    m2 = ms.spawn_mappoints(m, a, p_sel, m.kf_desc[a], n_sel, mind_sel,
                            maxd_sel, any_want, iF)
    # bind the second-view observation in the WINNING neighbor
    new_ids = m2.kf_mp[a]
    kf_mp = m2.kf_mp
    for i in range(n_nbrs):
        b = jnp.clip(nbrs[i], 0, m.max_kf - 1)
        row_b = kf_mp[b]
        bind_b = any_want & (sel == i) & (row_b[best[i]] < 0) & (nbrs[i] >= 0)
        tgt = jnp.where(bind_b, best[i], F)
        row_b2 = row_b.at[tgt].set(jnp.where(bind_b, new_ids, -1),
                                   mode="drop")
        kf_mp = kf_mp.at[b].set(jnp.where(row_b2 >= 0, row_b2, row_b))
    m2 = m2._replace(kf_mp=kf_mp)
    return m2, jnp.sum(any_want.astype(jnp.int32))


@jax.jit
def cull_mappoints(m: ms.MapState, cur_kf_id) -> ms.MapState:
    """MapPointCulling (LocalMapping.cc:352): drop landmarks with
    found/visible < 0.25, or with <=2 observations when 2+ keyframes old;
    landmarks >=3 KFs old become permanent."""
    n_obs = ms.mp_observation_count(m)
    age = cur_kf_id - m.mp_first_kf          # in keyframes
    ratio = m.mp_found / jnp.maximum(m.mp_visible, 1.0)
    bad = (ratio < 0.25) & (age <= 3)
    bad = bad | ((age >= 2) & (age <= 3) & (n_obs <= 2))
    new_valid = m.mp_valid & (~bad)
    # scrub dangling references
    kf_mp = jnp.where(new_valid[jnp.clip(m.kf_mp, 0, m.max_mp - 1)] & (m.kf_mp >= 0),
                      m.kf_mp, -1)
    return m._replace(mp_valid=new_valid, kf_mp=kf_mp,
                      n_mp=jnp.sum(new_valid.astype(jnp.int32)))


@partial(jax.jit, static_argnames=("cam_model", "img_w", "img_h", "n_levels"))
def fuse_into_keyframe(m: ms.MapState, kf_id, mp_candidates_valid, cam_params,
                       cam_model: int = cameras.PINHOLE, img_w: int = 640,
                       img_h: int = 400, n_levels: int = 8,
                       radius: float = 3.0, th_desc: float = 50.0):
    """ORBmatcher::Fuse (ORBmatcher.cc:1155) into one keyframe: project the
    candidate landmarks, match to the KF's features; empty slots gain an
    observation; occupied slots trigger MapPoint::Replace keeping the
    landmark with more observations (the loser's references are rewritten
    via a replace table)."""
    from ..tracking.matching import search_by_projection

    k = jnp.clip(kf_id, 0, m.max_kf - 1)
    cand = m.mp_valid & mp_candidates_valid & (kf_id >= 0) & m.kf_valid[k]
    pm = search_by_projection(
        m.mp_pos, m.mp_desc, cand, m.mp_normal, m.mp_min_dist, m.mp_max_dist,
        m.kf_R[k], m.kf_t[k], cam_params, m.kf_xy[k], m.kf_level[k],
        m.kf_desc[k], m.kf_feat_valid[k], radius, cam_model=cam_model,
        img_w=img_w, img_h=img_h, th_desc=th_desc, n_levels=n_levels)

    F = m.n_feat
    n_obs = ms.mp_observation_count(m)
    row = m.kf_mp[k]
    matched = pm.mp_feat >= 0
    f_idx = jnp.clip(pm.mp_feat, 0, F - 1)
    occupant = row[f_idx]                      # existing landmark or -1

    # case 1: slot empty -> add observation
    add = matched & (occupant < 0)
    tgt = jnp.where(add, f_idx, F)
    row2 = row.at[tgt].set(jnp.arange(m.max_mp, dtype=jnp.int32), mode="drop")

    # case 2: slot occupied by a different landmark -> keep the better one
    clash = matched & (occupant >= 0) & (occupant != jnp.arange(m.max_mp))
    occ_c = jnp.clip(occupant, 0, m.max_mp - 1)
    self_better = n_obs >= n_obs[occ_c]
    # replace table: dead -> winner
    repl = jnp.arange(m.max_mp, dtype=jnp.int32)
    # landmark loses to occupant
    lose_self = clash & (~self_better)
    repl = jnp.where(lose_self, occ_c, repl)
    # occupant loses to landmark: scatter
    win_tgt = jnp.where(clash & self_better, occ_c, m.max_mp)
    repl = repl.at[win_tgt].set(jnp.arange(m.max_mp, dtype=jnp.int32), mode="drop")
    dead = repl != jnp.arange(m.max_mp)

    kf_mp = m.kf_mp.at[k].set(row2)
    kf_mp = jnp.where(kf_mp >= 0, repl[jnp.clip(kf_mp, 0, m.max_mp - 1)], -1)
    mp_valid = m.mp_valid & (~dead)
    return m._replace(kf_mp=kf_mp, mp_valid=mp_valid,
                      n_mp=jnp.sum(mp_valid.astype(jnp.int32))), \
        jnp.sum(add) + jnp.sum(clash)


@partial(jax.jit, static_argnames=("cam_model", "img_w", "img_h", "n_levels",
                                   "n_tri", "n_fuse", "do_cull_kf"))
def mapping_step(m: ms.MapState, kid, cam_params,
                 cam_model: int = cameras.PINHOLE, img_w: int = 640,
                 img_h: int = 400, n_levels: int = 8, n_tri: int = 10,
                 n_fuse: int = 3, do_cull_kf: bool = True, th_far=None):
    """The whole per-keyframe LocalMapping chain as ONE executable:
    MapPointCulling -> CreateNewMapPoints (all neighbors, fused) ->
    SearchInNeighbors fuse both directions -> KeyFrameCulling
    (LocalMapping.cc:64 Run order). Issued as ~7 separate jits, the mapper
    thread would pay one dispatch and sync per stage while holding the map
    lock, serialized against the tracker's frame path. Returns the new
    map."""
    kid = jnp.asarray(kid, jnp.int32)
    m = cull_mappoints(m, kid)
    nbrs = top_covisible(m, kid, n_tri)
    m, _ = triangulate_with_neighbors(
        m, kid, nbrs, cam_params, cam_model=cam_model, n_levels=n_levels,
        n_nbrs=n_tri, th_far=th_far)
    # fuse candidates: neighbor-observed landmarks (the reference's
    # aliasing-guarded set) + recent spawns (pipeline-stale duplicates)
    nbr_self = jnp.concatenate([nbrs, kid.reshape(1)])
    fuse_cand = observed_mp_mask(m, nbr_self) | (m.mp_first_kf >= kid - 8)
    m, _ = fuse_into_keyframe(
        m, kid, fuse_cand, cam_params, cam_model=cam_model, img_w=img_w,
        img_h=img_h, n_levels=n_levels)
    own = observed_mp_mask(m, kid.reshape(1))
    for i in range(n_fuse):
        m, _ = fuse_into_keyframe(
            m, nbrs[i], own, cam_params, cam_model=cam_model, img_w=img_w,
            img_h=img_h, n_levels=n_levels)
    if do_cull_kf:
        protect = jnp.stack([jnp.int32(0), jnp.maximum(kid - 1, 0), kid])
        m = cull_keyframes(m, protect)
    return m


@jax.jit
def cull_keyframes(m: ms.MapState, protect_ids) -> ms.MapState:
    """KeyFrameCulling (LocalMapping.cc:914): a keyframe is redundant if
    >=90% of its landmarks are observed by >=3 other keyframes. protect_ids
    (A,) are never culled (current window / first KF)."""
    n_obs = ms.mp_observation_count(m)
    mp_redundant = n_obs >= 4                 # >= 3 others + self
    has_mp = (m.kf_mp >= 0) & m.kf_feat_valid
    mp_idx = jnp.clip(m.kf_mp, 0, m.max_mp - 1)
    red = has_mp & mp_redundant[mp_idx]
    n_has = jnp.sum(has_mp, axis=1)
    n_red = jnp.sum(red, axis=1)
    redundant_kf = m.kf_valid & (n_has > 10) & (n_red >= 0.9 * n_has)
    prot = jnp.zeros(m.max_kf, bool).at[jnp.clip(protect_ids, 0, m.max_kf - 1)].set(True)
    kill = redundant_kf & (~prot)
    # at most one KF culled per call (keeps covisibility stable, like the
    # incremental reference loop)
    first_kill = jnp.argmax(kill.astype(jnp.int32))
    do = jnp.any(kill)
    kf_valid = m.kf_valid.at[first_kill].set(
        jnp.where(do, False, m.kf_valid[first_kill]))
    # spanning-tree repair (KeyFrame::SetBadFlag, KeyFrame.cc): children of
    # the culled keyframe are re-parented to its own parent — exact because
    # at most one keyframe dies per call
    kf_parent = jnp.where(do & (m.kf_parent == first_kill),
                          m.kf_parent[first_kill], m.kf_parent)
    return m._replace(kf_valid=kf_valid, kf_parent=kf_parent)

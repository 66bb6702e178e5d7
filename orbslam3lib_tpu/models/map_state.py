"""Tensor map model: keyframes + landmarks as fixed-capacity struct-of-arrays.

Re-design of the reference's pointer-heavy map data model
(/root/reference app/src/main/cpp: Map/KeyFrame/MapPoint classes with mutex-
guarded observation dictionaries, covisibility edge maps and spanning trees —
Map.h:40-180, KeyFrame.h, MapPoint.h). Following SURVEY.md §7, the graph
becomes index tensors + validity masks with static capacities:

  * the KeyFrame->MapPoint observation map is ONE int32 matrix
    `kf_mp (K, F)` (feature slot -> landmark id, -1 = none) — this single
    tensor *is* the bipartite BA graph, the covisibility graph (via a
    one-hot matmul, see `covisibility`), and the observation counts;
  * MapPoint bookkeeping (found/visible ratios, scale-invariance distances,
    normals, distinctive descriptor) are flat arrays updated functionally;
  * insertion/culling are pure jitted functions returning a new MapState —
    there is no mMutexMapUpdate (SURVEY.md §5.2: functional state removes
    the tracker-vs-mapper race class by design).

Capacities are static (like the reference's own MAX_POINTS=20000 and
top-16/block budgets) so every consumer compiles once.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Default capacities (round-1 scale; config can override)
MAX_KF = 256
MAX_MP = 16384


class MapState(NamedTuple):
    # --- keyframes ---
    kf_R: jnp.ndarray        # (K, 3, 3) world->cam
    kf_t: jnp.ndarray        # (K, 3)
    kf_valid: jnp.ndarray    # (K,) bool
    kf_ts: jnp.ndarray       # (K,) float64-as-f32 timestamps
    kf_xy: jnp.ndarray       # (K, F, 2) level-0 keypoint coords
    kf_level: jnp.ndarray    # (K, F) int32
    kf_angle: jnp.ndarray    # (K, F) float32 keypoint orientations (rad)
    kf_desc: jnp.ndarray     # (K, F, 256) int8 bits
    kf_feat_valid: jnp.ndarray  # (K, F) bool
    kf_mp: jnp.ndarray       # (K, F) int32 landmark id or -1
    kf_depth: jnp.ndarray    # (K, F) float32 stereo depth (<=0: none)
    # per-KF inertial state (reference KeyFrame.h:206-216: velocity + bias)
    kf_v: jnp.ndarray        # (K, 3) world velocity of the body frame
    kf_bg: jnp.ndarray       # (K, 3) gyro bias
    kf_ba: jnp.ndarray       # (K, 3) accel bias
    # spanning tree (KeyFrame.h:322 mpParent): strongest-covisibility
    # predecessor at insertion; -1 = root. Feeds the essential graph.
    kf_parent: jnp.ndarray   # (K,) int32
    n_kf: jnp.ndarray        # () int32
    # --- landmarks ---
    mp_pos: jnp.ndarray      # (P, 3)
    mp_valid: jnp.ndarray    # (P,) bool
    mp_desc: jnp.ndarray     # (P, 256) int8 distinctive descriptor
    mp_normal: jnp.ndarray   # (P, 3) mean viewing direction
    mp_min_dist: jnp.ndarray  # (P,) scale-invariance range
    mp_max_dist: jnp.ndarray  # (P,)
    mp_first_kf: jnp.ndarray  # (P,) int32
    mp_found: jnp.ndarray    # (P,) f32
    mp_visible: jnp.ndarray  # (P,) f32
    n_mp: jnp.ndarray        # () int32

    @property
    def max_kf(self):
        return self.kf_R.shape[0]

    @property
    def max_mp(self):
        return self.mp_pos.shape[0]

    @property
    def n_feat(self):
        return self.kf_xy.shape[1]


def empty_map(max_kf: int = MAX_KF, max_mp: int = MAX_MP, n_feat: int = 512) -> MapState:
    f32, i32 = jnp.float32, jnp.int32
    return MapState(
        kf_R=jnp.tile(jnp.eye(3, dtype=f32), (max_kf, 1, 1)),
        kf_t=jnp.zeros((max_kf, 3), f32),
        kf_valid=jnp.zeros(max_kf, bool),
        kf_ts=jnp.zeros(max_kf, f32),
        kf_xy=jnp.zeros((max_kf, n_feat, 2), f32),
        kf_level=jnp.zeros((max_kf, n_feat), i32),
        kf_angle=jnp.zeros((max_kf, n_feat), f32),
        kf_desc=jnp.zeros((max_kf, n_feat, 256), jnp.int8),
        kf_feat_valid=jnp.zeros((max_kf, n_feat), bool),
        kf_mp=jnp.full((max_kf, n_feat), -1, i32),
        kf_depth=jnp.zeros((max_kf, n_feat), f32),
        kf_v=jnp.zeros((max_kf, 3), f32),
        kf_bg=jnp.zeros((max_kf, 3), f32),
        kf_ba=jnp.zeros((max_kf, 3), f32),
        kf_parent=jnp.full(max_kf, -1, i32),
        n_kf=jnp.zeros((), i32),
        mp_pos=jnp.zeros((max_mp, 3), f32),
        mp_valid=jnp.zeros(max_mp, bool),
        mp_desc=jnp.zeros((max_mp, 256), jnp.int8),
        mp_normal=jnp.zeros((max_mp, 3), f32),
        mp_min_dist=jnp.zeros(max_mp, f32),
        mp_max_dist=jnp.full(max_mp, 1e9, f32),
        mp_first_kf=jnp.full(max_mp, -1, i32),
        mp_found=jnp.ones(max_mp, f32),
        mp_visible=jnp.ones(max_mp, f32),
        n_mp=jnp.zeros((), i32),
    )


@jax.jit
def insert_keyframe(m: MapState, R, t, ts, xy, level, desc, feat_valid,
                    mp_assoc, depth, v=None, bg=None,
                    ba=None, angle=None) -> tuple[MapState, jnp.ndarray]:
    """Append a keyframe at slot n_kf and register its observations.

    mp_assoc (F,): landmark id already matched to each feature (-1 if none).
    v/bg/ba: optional inertial state recorded with the keyframe.
    Returns (new_map, kf_id). Capacity overflow drops the insert (kf_id = -1).
    Reference behavior: KeyFrame ctor + MapPoint::AddObservation +
    KeyFrame::UpdateConnections (Tracking::CreateNewKeyFrame, Tracking.cc:3277).
    """
    if v is None:
        v = jnp.zeros(3, jnp.float32)
    if bg is None:
        bg = jnp.zeros(3, jnp.float32)
    if ba is None:
        ba = jnp.zeros(3, jnp.float32)
    if angle is None:
        angle = jnp.zeros(m.n_feat, jnp.float32)
    k = m.n_kf
    ok = k < m.max_kf
    kc = jnp.minimum(k, m.max_kf - 1)

    # spanning-tree parent (KeyFrame::UpdateConnections -> ChangeParent,
    # KeyFrame.cc): the existing keyframe sharing the most landmark
    # observations with this one; -1 for the map's first keyframe
    assoc_eff = jnp.where(feat_valid, mp_assoc, -1)
    obs_mask = jnp.zeros(m.max_mp + 1, jnp.float32).at[
        jnp.where(assoc_eff >= 0, assoc_eff, m.max_mp)].set(
        1.0, mode="drop")[:m.max_mp]
    w = observation_matrix(m) @ obs_mask            # (K,) shared counts
    w = w * m.kf_valid * (jnp.arange(m.max_kf) < k)
    parent = jnp.where(jnp.max(w) > 0,
                       jnp.argmax(w).astype(jnp.int32), -1)

    def write(m):
        return m._replace(
            kf_R=m.kf_R.at[kc].set(R),
            kf_t=m.kf_t.at[kc].set(t),
            kf_valid=m.kf_valid.at[kc].set(True),
            kf_ts=m.kf_ts.at[kc].set(ts),
            kf_xy=m.kf_xy.at[kc].set(xy),
            kf_level=m.kf_level.at[kc].set(level),
            kf_angle=m.kf_angle.at[kc].set(angle),
            kf_desc=m.kf_desc.at[kc].set(desc),
            kf_feat_valid=m.kf_feat_valid.at[kc].set(feat_valid),
            kf_mp=m.kf_mp.at[kc].set(jnp.where(feat_valid, mp_assoc, -1)),
            kf_depth=m.kf_depth.at[kc].set(depth),
            kf_v=m.kf_v.at[kc].set(v),
            kf_bg=m.kf_bg.at[kc].set(bg),
            kf_ba=m.kf_ba.at[kc].set(ba),
            kf_parent=m.kf_parent.at[kc].set(parent),
            n_kf=k + 1,
        )

    m = jax.lax.cond(ok, write, lambda m: m, m)
    return m, jnp.where(ok, kc, -1)


@jax.jit
def spawn_mappoints(m: MapState, kf_id, p_world, desc, normal, min_dist,
                    max_dist, want, feat_slot) -> MapState:
    """Allocate new landmarks for the `want`-masked candidates and bind them
    to keyframe `kf_id` feature slots `feat_slot`.

    All (F,)-shaped. Slots are allocated from the FREE pool (lowest invalid
    index first, one ~40 us top_k) rather than an append-only n_mp pointer:
    culled/fused-away slots are recycled in place, so a long-running map no
    longer creeps to capacity and forces a multi-second host-side
    compaction (rebuild of the BoW database + GBA abort) mid-run. Every
    invalidation path scrubs its kf_mp references (cull_mappoints,
    fuse_into_keyframe replace table), so a freed slot is unreferenced by
    the map when it is reused. `n_mp` is the LIVE landmark count.
    Candidates beyond the free capacity are dropped. Reference:
    Tracking::CreateNewKeyFrame close-point spawning (Tracking.cc:3277+) and
    LocalMapping::CreateNewMapPoints insertion (the reference heap-allocates
    and frees MapPoint objects; a fixed-capacity tensor map recycles slots).
    """
    F = want.shape[0]
    free_score = jnp.where(m.mp_valid, -1.0,
                           (m.max_mp - jnp.arange(m.max_mp)).astype(jnp.float32))
    _, slots = jax.lax.top_k(free_score, F)      # lowest free indices first
    slot_free = ~m.mp_valid[slots]
    ranks = jnp.clip(jnp.cumsum(want.astype(jnp.int32)) - 1, 0, F - 1)
    ids = slots[ranks]
    ok = want & slot_free[ranks]
    ids_c = jnp.where(ok, ids, m.max_mp - 1)  # clamped scatter target

    def sc(arr, vals):
        return arr.at[ids_c].set(jnp.where(ok[..., None] if arr.ndim > 1 else ok,
                                           vals, arr[ids_c]))

    new_valid = m.mp_valid.at[ids_c].set(
        jnp.where(ok, True, m.mp_valid[ids_c]))
    m = m._replace(
        mp_pos=sc(m.mp_pos, p_world),
        mp_valid=new_valid,
        mp_desc=sc(m.mp_desc, desc),
        mp_normal=sc(m.mp_normal, normal),
        mp_min_dist=m.mp_min_dist.at[ids_c].set(jnp.where(ok, min_dist, m.mp_min_dist[ids_c])),
        mp_max_dist=m.mp_max_dist.at[ids_c].set(jnp.where(ok, max_dist, m.mp_max_dist[ids_c])),
        mp_first_kf=m.mp_first_kf.at[ids_c].set(jnp.where(ok, kf_id, m.mp_first_kf[ids_c])),
        # recycled slots carry stale statistics: reset to the fresh-landmark
        # state (MapPoint ctor nFound = nVisible = 1)
        mp_found=m.mp_found.at[ids_c].set(jnp.where(ok, 1.0, m.mp_found[ids_c])),
        mp_visible=m.mp_visible.at[ids_c].set(jnp.where(ok, 1.0, m.mp_visible[ids_c])),
        n_mp=jnp.sum(new_valid.astype(jnp.int32)),
    )
    # bind observations into the keyframe row
    row = m.kf_mp[kf_id]
    row = row.at[feat_slot].set(jnp.where(ok, ids_c, row[feat_slot]))
    return m._replace(kf_mp=m.kf_mp.at[kf_id].set(row))


def observation_matrix(m: MapState) -> jnp.ndarray:
    """(K, P) float32 binary observation incidence from kf_mp (one-hot sum).

    This is the tensor form of the reference's MapPoint::mObservations maps.
    """
    K, F = m.kf_mp.shape
    P = m.max_mp
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    kk = jax.lax.broadcasted_iota(jnp.int32, (K, F), 0)
    flat_idx = jnp.where(obs, kk * P + m.kf_mp, K * P)  # invalid -> overflow slot
    O = jnp.zeros(K * P + 1, jnp.float32).at[flat_idx.reshape(-1)].add(1.0)
    return O[: K * P].reshape(K, P).clip(0.0, 1.0)


@jax.jit
def covisibility(m: MapState) -> jnp.ndarray:
    """(K, K) shared-observation counts — KeyFrame::UpdateConnections'
    covisibility weights as one matmul: C = O @ O^T."""
    O = observation_matrix(m)
    return O @ O.T


@jax.jit
def mp_observation_count(m: MapState) -> jnp.ndarray:
    """(P,) number of keyframes observing each landmark."""
    return jnp.sum(observation_matrix(m), axis=0).astype(jnp.int32)


@jax.jit
def compact_map(m: MapState):
    """Recycle culled keyframe/landmark slots by stable compaction.

    The reference never reuses slots (its maps grow unbounded on the heap,
    KeyFrame/MapPoint objects freed by SetBadFlag); a fixed-capacity tensor
    map must reclaim them or keyframe insertion stops at max_kf. Compaction
    (vs a free-list) preserves the id==temporal-order invariant that the
    essential-graph chain, covisibility windows and VI gap bookkeeping rely
    on: valid keyframes/landmarks slide down to the low slots in their
    original order; every cross-reference (kf_mp) is rewritten through the
    landmark permutation.

    Returns (new_map, kf_new (K,) old->new kf id or -1,
    mp_new (P,) old->new landmark id or -1) so host-side bookkeeping
    (last_kf_id, BoW database rows, loop edges) can be remapped.
    """
    K, P = m.max_kf, m.max_mp
    kf_rank = jnp.cumsum(m.kf_valid.astype(jnp.int32)) - 1
    kf_new = jnp.where(m.kf_valid, kf_rank, -1)          # old -> new
    n_kf2 = jnp.sum(m.kf_valid.astype(jnp.int32))
    kf_old = jnp.zeros(K, jnp.int32).at[
        jnp.where(m.kf_valid, kf_rank, K)].set(
        jnp.arange(K, dtype=jnp.int32), mode="drop")     # new -> old

    # landmarks must be observed by >=1 valid KF to survive compaction
    obs_alive = jnp.zeros(P + 1, bool).at[
        jnp.where((m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None],
                  m.kf_mp, P).reshape(-1)].set(True, mode="drop")[:P]
    mp_live = m.mp_valid & obs_alive
    mp_rank = jnp.cumsum(mp_live.astype(jnp.int32)) - 1
    mp_new = jnp.where(mp_live, mp_rank, -1)
    n_mp2 = jnp.sum(mp_live.astype(jnp.int32))
    mp_old = jnp.zeros(P, jnp.int32).at[
        jnp.where(mp_live, mp_rank, P)].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop")

    live_kf = jnp.arange(K) < n_kf2
    live_mp = jnp.arange(P) < n_mp2

    def gk(arr):                                         # gather kf rows
        out = arr[kf_old]
        shape = (K,) + (1,) * (arr.ndim - 1)
        return jnp.where(live_kf.reshape(shape), out, jnp.zeros_like(out))

    def gp(arr):                                         # gather mp rows
        out = arr[mp_old]
        shape = (P,) + (1,) * (arr.ndim - 1)
        return jnp.where(live_mp.reshape(shape), out, jnp.zeros_like(out))

    # kf_mp: gather rows by kf_old, rewrite values through mp_new
    kf_mp_rows = m.kf_mp[kf_old]
    kf_mp2 = jnp.where(kf_mp_rows >= 0,
                       mp_new[jnp.clip(kf_mp_rows, 0, P - 1)], -1)
    kf_mp2 = jnp.where(live_kf[:, None], kf_mp2, -1)

    m2 = m._replace(
        kf_R=jnp.where(live_kf[:, None, None], m.kf_R[kf_old],
                       jnp.eye(3, dtype=jnp.float32)),
        kf_t=gk(m.kf_t),
        kf_valid=live_kf,
        kf_ts=gk(m.kf_ts),
        kf_xy=gk(m.kf_xy),
        kf_level=gk(m.kf_level),
        kf_angle=gk(m.kf_angle),
        kf_desc=gk(m.kf_desc),
        kf_feat_valid=gk(m.kf_feat_valid) & live_kf[:, None],
        kf_mp=kf_mp2,
        kf_depth=gk(m.kf_depth),
        kf_v=gk(m.kf_v),
        kf_bg=gk(m.kf_bg),
        kf_ba=gk(m.kf_ba),
        kf_parent=jnp.where(
            live_kf,
            jnp.where(m.kf_parent[kf_old] >= 0,
                      kf_new[jnp.clip(m.kf_parent[kf_old], 0, K - 1)], -1),
            -1),
        n_kf=n_kf2,
        mp_pos=gp(m.mp_pos),
        mp_valid=live_mp,
        mp_desc=gp(m.mp_desc),
        mp_normal=gp(m.mp_normal),
        mp_min_dist=gp(m.mp_min_dist),
        mp_max_dist=jnp.where(live_mp, m.mp_max_dist[mp_old], 1e9),
        mp_first_kf=jnp.where(
            live_mp,
            jnp.where(m.mp_first_kf[mp_old] >= 0,
                      kf_new[jnp.clip(m.mp_first_kf[mp_old], 0, K - 1)],
                      -1),
            -1),
        mp_found=jnp.where(live_mp, m.mp_found[mp_old], 1.0),
        mp_visible=jnp.where(live_mp, m.mp_visible[mp_old], 1.0),
        n_mp=n_mp2,
    )
    return m2, kf_new, mp_new

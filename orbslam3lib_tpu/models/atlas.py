"""Atlas: multi-map container with new-map spawning and Sim3 merge.

Re-design of the reference's Atlas
(/root/reference app/src/main/cpp/src/Atlas.cc: CreateNewMap/ChangeMap/
GetCurrentMap/SetMapBad — the multi-session & elastic-recovery backbone,
SURVEY.md §5.3: on unrecoverable tracking loss a NEW map is spawned
(Tracking::CreateMapInAtlas) and later re-merged by LoopClosing's merge
detection (MergeLocal/MergeLocal2)).

Maps are immutable-capacity MapStates; merge copies the source map's valid
keyframes/landmarks into the free slots of the target after transforming
them through the connecting Sim3 (the welding transform of MergeLocal).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import lie
from . import map_state as ms


@jax.jit
def transform_map(m: ms.MapState, R12, t12, s12) -> ms.MapState:
    """Apply a world-frame Sim3 (target <- source) to every pose/landmark:
    landmarks p' = s R p + t; camera poses Tcw' = Tcw o S^-1 (SE3 with t/s).
    Reference: Map::ApplyScaledRotation (Map.h:91) / merge welding."""
    p_new = s12 * (m.mp_pos @ R12.T) + t12
    Ri, ti, si = lie.sim3_inverse(R12, t12, s12)
    # Tcw' = Tcw_se3 applied after S^-1: R' = R Ri, t' = (R ti)*si... derive:
    # x_cam = R_cw (S^-1 x_new) + t = R Ri^T? Work in composition form:
    # S_cw' = S_cw o S^-1  with S_cw = (R, t, 1):
    Rn, tn, sn = jax.vmap(
        lambda R, t: lie.sim3_compose(R, t, jnp.float32(1.0), Ri, ti, si)
    )(m.kf_R, m.kf_t)
    kf_t = tn / jnp.maximum(sn[:, None], 1e-9)
    valid = m.mp_valid.astype(jnp.float32)[:, None]
    # world velocities transform as v' = s R v (Map::ApplyScaledRotation
    # scales velocities too, Map.cc)
    kf_v = s12 * (m.kf_v @ R12.T)
    return m._replace(kf_R=Rn, kf_t=kf_t, kf_v=kf_v,
                      mp_pos=valid * p_new + (1 - valid) * m.mp_pos)


@jax.jit
def merge_into(dst: ms.MapState, src: ms.MapState) -> ms.MapState:
    """Copy src's valid keyframes + landmarks into dst's free slots (src must
    already be in dst's world frame via transform_map). Keyframes append at
    kf_off (preserving temporal id order, which the essential graph and
    covisibility windows rely on); landmarks allocate from dst's FREE slot
    pool (slot-recycling map — see spawn_mappoints). Overflow entries are
    dropped."""
    kf_off = dst.n_kf
    K, F = src.kf_mp.shape

    kf_rank = jnp.cumsum(src.kf_valid.astype(jnp.int32)) - 1
    kf_new = jnp.where(src.kf_valid, kf_off + kf_rank, dst.max_kf)
    kf_ok = src.kf_valid & (kf_new < dst.max_kf)
    kf_tgt = jnp.where(kf_ok, kf_new, dst.max_kf)

    free_score = jnp.where(dst.mp_valid, -1.0,
                           (dst.max_mp - jnp.arange(dst.max_mp)
                            ).astype(jnp.float32))
    _, fslots = jax.lax.top_k(free_score, min(src.max_mp, dst.max_mp))
    fslot_free = ~dst.mp_valid[fslots]
    mp_rank = jnp.clip(jnp.cumsum(src.mp_valid.astype(jnp.int32)) - 1,
                       0, fslots.shape[0] - 1)
    mp_new = fslots[mp_rank]
    mp_ok = src.mp_valid & fslot_free[mp_rank]
    mp_new = jnp.where(mp_ok, mp_new, dst.max_mp)
    mp_tgt = mp_new

    # remap src kf_mp landmark ids, then scatter rows
    remap = jnp.full(src.max_mp + 1, -1, jnp.int32).at[
        jnp.where(mp_ok, jnp.arange(src.max_mp), src.max_mp)].set(
        jnp.where(mp_ok, mp_new, -1).astype(jnp.int32), mode="drop")
    src_kf_mp = jnp.where(src.kf_mp >= 0,
                          remap[jnp.clip(src.kf_mp, 0, src.max_mp - 1)], -1)
    kf_first_remap = jnp.where(
        src.mp_first_kf >= 0,
        kf_off + kf_rank[jnp.clip(src.mp_first_kf, 0, K - 1)], -1)
    kf_parent_remap = jnp.where(
        src.kf_parent >= 0,
        kf_off + kf_rank[jnp.clip(src.kf_parent, 0, K - 1)], -1)

    def sc(dst_arr, src_arr, tgt, ok):
        vals = jnp.where(ok.reshape(ok.shape + (1,) * (src_arr.ndim - 1)),
                         src_arr, jnp.zeros_like(src_arr))
        return dst_arr.at[tgt].set(vals, mode="drop")

    out = dst._replace(
        kf_R=sc(dst.kf_R, src.kf_R, kf_tgt, kf_ok),
        kf_t=sc(dst.kf_t, src.kf_t, kf_tgt, kf_ok),
        kf_valid=dst.kf_valid.at[kf_tgt].set(kf_ok, mode="drop"),
        kf_ts=sc(dst.kf_ts, src.kf_ts, kf_tgt, kf_ok),
        kf_xy=sc(dst.kf_xy, src.kf_xy, kf_tgt, kf_ok),
        kf_level=sc(dst.kf_level, src.kf_level, kf_tgt, kf_ok),
        kf_angle=sc(dst.kf_angle, src.kf_angle, kf_tgt, kf_ok),
        kf_desc=sc(dst.kf_desc, src.kf_desc, kf_tgt, kf_ok),
        kf_feat_valid=sc(dst.kf_feat_valid, src.kf_feat_valid, kf_tgt, kf_ok),
        kf_mp=dst.kf_mp.at[kf_tgt].set(
            jnp.where(kf_ok[:, None], src_kf_mp, -1), mode="drop"),
        kf_depth=sc(dst.kf_depth, src.kf_depth, kf_tgt, kf_ok),
        kf_v=sc(dst.kf_v, src.kf_v, kf_tgt, kf_ok),
        kf_bg=sc(dst.kf_bg, src.kf_bg, kf_tgt, kf_ok),
        kf_ba=sc(dst.kf_ba, src.kf_ba, kf_tgt, kf_ok),
        kf_parent=dst.kf_parent.at[kf_tgt].set(
            jnp.where(kf_ok, kf_parent_remap, -1), mode="drop"),
        n_kf=dst.n_kf + jnp.sum(kf_ok.astype(jnp.int32)),
        mp_pos=sc(dst.mp_pos, src.mp_pos, mp_tgt, mp_ok),
        mp_valid=dst.mp_valid.at[mp_tgt].set(mp_ok, mode="drop"),
        mp_desc=sc(dst.mp_desc, src.mp_desc, mp_tgt, mp_ok),
        mp_normal=sc(dst.mp_normal, src.mp_normal, mp_tgt, mp_ok),
        mp_min_dist=sc(dst.mp_min_dist, src.mp_min_dist, mp_tgt, mp_ok),
        mp_max_dist=sc(dst.mp_max_dist, src.mp_max_dist, mp_tgt, mp_ok),
        mp_first_kf=dst.mp_first_kf.at[mp_tgt].set(
            jnp.where(mp_ok, kf_first_remap, -1), mode="drop"),
        mp_found=sc(dst.mp_found, src.mp_found, mp_tgt, mp_ok),
        mp_visible=sc(dst.mp_visible, src.mp_visible, mp_tgt, mp_ok),
        n_mp=jnp.sum(dst.mp_valid.at[mp_tgt].set(
            mp_ok, mode="drop").astype(jnp.int32)),
    )
    return out


class Atlas:
    """Host-side multi-map manager (Atlas.h:45-141 API surface)."""

    def __init__(self, max_kf: int = ms.MAX_KF, max_mp: int = ms.MAX_MP,
                 n_feat: int = 512):
        self._dims = (max_kf, max_mp, n_feat)
        self.maps: List[ms.MapState] = [ms.empty_map(max_kf, max_mp, n_feat)]
        self.bad: List[bool] = [False]
        self.current = 0

    @property
    def current_map(self) -> ms.MapState:
        return self.maps[self.current]

    @current_map.setter
    def current_map(self, m: ms.MapState):
        self.maps[self.current] = m

    def create_new_map(self) -> int:
        """Tracking::CreateMapInAtlas — spawn a fresh map and make it
        current (elastic recovery on unrecoverable loss)."""
        self.maps.append(ms.empty_map(*self._dims))
        self.bad.append(False)
        self.current = len(self.maps) - 1
        return self.current

    def set_map_bad(self, idx: int):
        self.bad[idx] = True

    def remove_bad_maps(self):
        keep = [i for i in range(len(self.maps)) if not self.bad[i]]
        cur = self.maps[self.current]
        self.maps = [self.maps[i] for i in keep]
        self.bad = [False] * len(self.maps)
        self.current = self.maps.index(cur)

    def count_maps(self) -> int:
        return len(self.maps)

    def merge(self, src_idx: int, R12, t12, s12):
        """Merge map src_idx into the current map through Sim3 (current <-
        src): LoopClosing::MergeLocal's map-fusion step. The source map is
        discarded afterwards."""
        src = transform_map(self.maps[src_idx], R12, t12, s12)
        self.maps[self.current] = merge_into(self.maps[self.current], src)
        self.set_map_bad(src_idx)
        self.remove_bad_maps()

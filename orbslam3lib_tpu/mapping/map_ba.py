"""Map-level bundle adjustment: window gather/scatter + interruptible
global BA.

Equivalent of the reference's map-wide optimizations
(/root/reference app/src/main/cpp/src/Optimizer.cc:
GlobalBundleAdjustemnt:53 / BundleAdjustment:61, spawned from
LoopClosing::RunGlobalBundleAdjustment:2268 with the mbStopGBA abort flag
checked between iterations). The pointer-graph edge construction becomes a
fixed-shape gather of the MapState's (K, F) observation rows; the abort flag
becomes a host-side callable checked between jitted LM chunks — the same
interruptibility contract with none of the thread races the reference's
README warns about.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..models import map_state as ms
from ..ops.pyramid import scale_factors
from ..utils import cameras
from .local_ba import (CHI2_GATE_AFTER, BAProblem, bundle_adjust,
                       gate_outliers)


def inv_sigma2(level, n_levels: int = 8):
    """Per-observation information weight 1/scale^2 (the reference's
    mvInvLevelSigma2, Frame.cc)."""
    sf = jnp.asarray(scale_factors(n_levels))
    s = sf[jnp.clip(level, 0, n_levels - 1)]
    return 1.0 / (s * s)


def _gather_window_problem(m: ms.MapState, window_ids, fixed_mask,
                           bf: float, n_ba_points: int):
    """Gather the fixed-shape BA problem over a keyframe window. Returns
    (prob, ids, sel_ids, cam_ok, pt_ok) — the latter four drive the scatter.
    Shared by the single-device and the distributed (landmark-sharded)
    solvers."""
    C = window_ids.shape[0]
    F = m.n_feat
    ids = jnp.clip(window_ids, 0, m.max_kf - 1)
    cam_ok = (window_ids >= 0) & m.kf_valid[ids]

    kf_mp_w = jnp.where((cam_ok[:, None]) & m.kf_feat_valid[ids],
                        m.kf_mp[ids], -1)                     # (C,F)
    # select up to n_ba_points observed landmarks
    flag = jnp.zeros(m.max_mp, jnp.float32).at[
        jnp.clip(kf_mp_w.reshape(-1), 0, m.max_mp - 1)].max(
        (kf_mp_w.reshape(-1) >= 0).astype(jnp.float32), mode="drop")
    flag = flag * m.mp_valid.astype(jnp.float32)
    sel_flag, sel_ids = jax.lax.top_k(flag, n_ba_points)
    pt_ok = sel_flag > 0
    inv = jnp.full(m.max_mp, -1, jnp.int32).at[sel_ids].set(
        jnp.arange(n_ba_points, dtype=jnp.int32))

    cc = jax.lax.broadcasted_iota(jnp.int32, (C, F), 0)
    e_pt_g = kf_mp_w.reshape(-1)
    e_pt = inv[jnp.clip(e_pt_g, 0, m.max_mp - 1)]
    e_valid = (e_pt_g >= 0) & (e_pt >= 0)
    e_cam = cc.reshape(-1)
    e_uv = m.kf_xy[ids].reshape(-1, 2)
    e_level = m.kf_level[ids].reshape(-1)
    e_depth = m.kf_depth[ids].reshape(-1)
    e_stereo = e_depth > 0.05
    z_safe = jnp.maximum(e_depth, 0.05)
    e_u_right = jnp.where(e_stereo, e_uv[:, 0] - bf / z_safe, 0.0)

    prob = BAProblem(
        cam_R=m.kf_R[ids], cam_t=m.kf_t[ids],
        cam_fixed=fixed_mask | (~cam_ok), cam_valid=cam_ok,
        points=m.mp_pos[sel_ids], pt_valid=pt_ok,
        e_cam=e_cam, e_pt=jnp.where(e_valid, e_pt, 0),
        e_uv=e_uv, e_inv_sigma2=inv_sigma2(e_level, 8),
        e_u_right=e_u_right, e_stereo=e_stereo, e_valid=e_valid,
    )
    return prob, ids, sel_ids, cam_ok, pt_ok


def _scatter_window_result(m: ms.MapState, cam_R, cam_t, points,
                           ids, sel_ids, cam_ok, pt_ok, fixed_mask):
    """Write optimized cameras/points back (valid, non-fixed only)."""
    upd_cam = cam_ok & (~fixed_mask)
    return m._replace(
        kf_R=m.kf_R.at[ids].set(jnp.where(upd_cam[:, None, None], cam_R, m.kf_R[ids])),
        kf_t=m.kf_t.at[ids].set(jnp.where(upd_cam[:, None], cam_t, m.kf_t[ids])),
        mp_pos=m.mp_pos.at[sel_ids].set(jnp.where(pt_ok[:, None], points,
                                                  m.mp_pos[sel_ids])),
    )


@partial(jax.jit, static_argnames=("bf", "cam_model", "n_ba_points", "n_iters",
                                   "gate_first"))
def map_window_ba(m: ms.MapState, window_ids, fixed_mask, cam_params,
                  bf: float, cam_model: int, n_ba_points: int, n_iters: int,
                  gate_first: bool = False):
    """Gather a fixed-shape BA problem over a keyframe window, solve, scatter.

    window_ids (C,) int32 (-1 = empty slot), fixed_mask (C,) bool. With
    `gate_first`, chi2 outliers at the current estimate are pruned before
    the first iteration (a chunked schedule past its pruning point).
    Reference: LocalBundleAdjustment (Optimizer.cc:1124) — window KFs
    optimizable, anchors fixed, all their landmarks optimizable. With the
    window = all KFs this is GlobalBundleAdjustemnt (Optimizer.cc:53).
    """
    prob, ids, sel_ids, cam_ok, pt_ok = _gather_window_problem(
        m, window_ids, fixed_mask, bf, n_ba_points)
    if gate_first:
        prob = gate_outliers(prob, cam_params, cam_model, bf)
    cam_R, cam_t, points, e_inlier = bundle_adjust(
        prob, cam_params, cam_model=cam_model, bf=bf, n_iters=n_iters)
    return _scatter_window_result(m, cam_R, cam_t, points, ids, sel_ids,
                                  cam_ok, pt_ok, fixed_mask)


def global_bundle_adjust(m: ms.MapState, cam_params, bf: float,
                         cam_model: int = cameras.PINHOLE,
                         n_iters: int = 10, chunk: int = 5,
                         n_ba_points: Optional[int] = None,
                         should_abort: Optional[Callable[[], bool]] = None
                         ) -> ms.MapState:
    """Full-map BA with host-checkable abort between LM chunks.

    Reference: RunGlobalBundleAdjustment (LoopClosing.cc:2268) spawns
    GlobalBundleAdjustemnt on a thread and polls mbStopGBA between
    iterations; here the LM schedule is split into jitted chunks with the
    abort callable polled in between (P2 in SURVEY.md §2.4). The first valid
    keyframe is the gauge anchor.
    """
    K = m.max_kf
    window_ids = jnp.where(m.kf_valid, jnp.arange(K, dtype=jnp.int32), -1)
    first = int(jnp.argmax(m.kf_valid.astype(jnp.int32)))
    fixed = jnp.zeros(K, bool).at[first].set(True)
    if n_ba_points is None:
        n_ba_points = int(m.max_mp)

    done = 0
    while done < n_iters:
        it = min(chunk, n_iters - done)
        m = map_window_ba(m, window_ids, fixed, cam_params, bf,
                          cam_model, n_ba_points, it,
                          gate_first=done >= CHI2_GATE_AFTER)
        done += it
        if should_abort is not None and should_abort():
            break
    return m


def global_bundle_adjust_auto(m: ms.MapState, cam_params, bf: float,
                              cam_model: int = cameras.PINHOLE,
                              n_iters: int = 10, chunk: int = 5,
                              n_ba_points: Optional[int] = None,
                              should_abort: Optional[Callable[[], bool]] = None
                              ) -> ms.MapState:
    """Global BA on whatever the process has: a multi-device mesh routes to
    the landmark-sharded distributed solver (psum-Schur over the mesh), a
    single device to the plain chunked solver."""
    devs = jax.devices()
    if len(devs) > 1:
        import numpy as np
        from jax.sharding import Mesh
        mesh = Mesh(np.array(devs), ("mp",))
        return global_bundle_adjust_dist(
            m, cam_params, mesh, bf, cam_model=cam_model, n_iters=n_iters,
            chunk=chunk, n_ba_points=n_ba_points, should_abort=should_abort)
    return global_bundle_adjust(
        m, cam_params, bf, cam_model=cam_model, n_iters=n_iters, chunk=chunk,
        n_ba_points=n_ba_points, should_abort=should_abort)


def global_bundle_adjust_dist(m: ms.MapState, cam_params, mesh, bf: float,
                              cam_model: int = cameras.PINHOLE,
                              n_iters: int = 10, chunk: int = 5,
                              n_ba_points: Optional[int] = None,
                              should_abort: Optional[Callable[[], bool]] = None,
                              axis: str = "mp") -> ms.MapState:
    """Full-map BA sharded over a device mesh (landmarks + their edges on
    mesh axis `axis`, cameras replicated, Schur camera system psum-reduced
    over the mesh — parallel/dist_ba.py). Same abort contract as the
    single-device global_bundle_adjust: the LM schedule runs in jitted
    chunks with the abort callable polled in between; the gathered problem
    is re-partitioned once, and only camera/point values are swapped
    between chunks.
    """
    from ..parallel.dist_ba import dist_bundle_adjust, partition_problem
    K = m.max_kf
    window_ids = jnp.where(m.kf_valid, jnp.arange(K, dtype=jnp.int32), -1)
    first = int(jnp.argmax(m.kf_valid.astype(jnp.int32)))
    fixed = jnp.zeros(K, bool).at[first].set(True)
    if n_ba_points is None:
        n_ba_points = int(m.max_mp)

    prob, ids, sel_ids, cam_ok, pt_ok = _gather_window_problem(
        m, window_ids, fixed, bf, n_ba_points)
    n_dev = mesh.shape[axis]
    probd = partition_problem(prob, n_dev)
    e_valid = probd.e_valid

    done = 0
    while done < n_iters:
        it = min(chunk, n_iters - done)
        if done >= CHI2_GATE_AFTER:
            probd = gate_outliers(probd._replace(e_valid=e_valid),
                                  cam_params, cam_model, bf)
        cam_R, cam_t, points, _ = dist_bundle_adjust(
            probd, cam_params, mesh, cam_model=cam_model, bf=bf, n_iters=it)
        probd = probd._replace(cam_R=cam_R, cam_t=cam_t, points=points)
        done += it
        if should_abort is not None and should_abort():
            break
    # drop the landmark padding partition_problem added
    points = probd.points[:n_ba_points]
    return _scatter_window_result(m, probd.cam_R, probd.cam_t, points,
                                  ids, sel_ids, cam_ok, pt_ok, fixed)


@jax.jit
def merge_gba_result(m_now: ms.MapState, gba_R, gba_t, gba_mp_pos,
                     n_kf0, mp_valid0, mp_first_kf0) -> ms.MapState:
    """Fold an asynchronously-computed global-BA result into a map that kept
    advancing while the GBA ran on its own thread.

    Reference: the tail of RunGlobalBundleAdjustment (LoopClosing.cc:1240+)
    — keyframes included in the GBA take their optimized pose (mTcwGBA);
    keyframes created during the GBA are corrected by walking the spanning
    tree from the root, composing each child's relative pose onto its
    parent's corrected pose (mTcwBefGBA bookkeeping); map points included in
    the GBA take mPosGBA, the rest re-anchor through their reference
    keyframe's (before, after) pose pair.

    Here: n_kf0 is the keyframe count at GBA launch (keyframe ids are
    appended, never recycled while a GBA runs), and mp_valid0/mp_first_kf0
    are the landmark slots' validity and first-observing keyframe at launch.
    Landmark slots ARE recycled, so a slot counts as GBA'd only if it is
    still held by the same landmark: valid then and now, with the same first
    keyframe (a landmark born during the GBA has a newer one). The spanning
    tree walk is a fori_loop in keyframe-id order — a parent always has a
    smaller id than its child (map_state.insert_keyframe picks the parent
    among existing keyframes), so each child sees its parent already
    corrected.
    """
    from ..utils import lie
    K = m_now.max_kf
    ii = jnp.arange(K)
    in_gba = (ii < n_kf0) & m_now.kf_valid
    R_new = jnp.where(in_gba[:, None, None], gba_R, m_now.kf_R)
    t_new = jnp.where(in_gba[:, None], gba_t, m_now.kf_t)

    def body(k, carry):
        R_n, t_n = carry
        par = m_now.kf_parent[k]
        parc = jnp.clip(par, 0, K - 1)
        # Tcw_new(child) = Tcw_now(child) o Twc_now(parent) o Tcw_new(parent)
        Rpi, tpi = lie.se3_inverse(m_now.kf_R[parc], m_now.kf_t[parc])
        Rd, td = lie.se3_compose(m_now.kf_R[k], m_now.kf_t[k], Rpi, tpi)
        Rc, tc = lie.se3_compose(Rd, td, R_n[parc], t_n[parc])
        do = (k >= n_kf0) & m_now.kf_valid[k] & (par >= 0)
        R_n = R_n.at[k].set(jnp.where(do, Rc, R_n[k]))
        t_n = t_n.at[k].set(jnp.where(do, tc, t_n[k]))
        return R_n, t_n

    R_new, t_new = jax.lax.fori_loop(0, K, body, (R_new, t_new))

    # landmarks: GBA'd ones take the optimized position; the rest re-anchor
    # through their first-observing keyframe's (before, after) pose pair
    in_gba_mp = (mp_valid0 & m_now.mp_valid
                 & (m_now.mp_first_kf == mp_first_kf0))
    ref = jnp.clip(m_now.mp_first_kf, 0, K - 1)
    has_ref = (m_now.mp_first_kf >= 0) & m_now.mp_valid
    p_cam = lie.se3_apply(m_now.kf_R[ref], m_now.kf_t[ref], m_now.mp_pos)
    Rwc = jnp.swapaxes(R_new[ref], -1, -2)
    p_re = jnp.einsum("pij,pj->pi", Rwc, p_cam - t_new[ref])
    g = in_gba_mp.astype(jnp.float32)[:, None]
    h = (has_ref & ~in_gba_mp).astype(jnp.float32)[:, None]
    mp_pos = g * gba_mp_pos + h * p_re + (1.0 - g - h) * m_now.mp_pos
    return m_now._replace(kf_R=R_new, kf_t=t_new, mp_pos=mp_pos)

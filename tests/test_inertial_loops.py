"""Inertial-aware loop closing: 4-DoF essential graph + gates + async GBA.

Reference behaviors under test:
  * OptimizeEssentialGraph4DoF (Optimizer.cc:5338) — on an IMU-initialized
    map the loop correction only adjusts yaw + translation; pitch/roll (pinned
    by gravity) and scale (pinned by the IMU) must come through unchanged.
  * inertial sanity gates (LoopClosing.cc:144-163) — scale outside [0.9, 1.1]
    or a pitch/roll-heavy correction rejects the loop hypothesis.
  * RunGlobalBundleAdjustment tail (LoopClosing.cc:1240+) — keyframes and
    landmarks created while an async GBA ran are folded in through
    spanning-tree propagation / reference-KF re-anchoring.
"""
import pytest

import time

import numpy as np
import jax.numpy as jnp

from orbslam3lib_tpu.config import SlamConfig
from orbslam3lib_tpu.mapping.loop_closing import LoopCloser
from orbslam3lib_tpu.mapping.map_ba import merge_gba_result
from orbslam3lib_tpu.models import map_state as ms
from orbslam3lib_tpu.models import vocabulary as vb
from orbslam3lib_tpu.tracking.reloc import PlaceRecognition
from orbslam3lib_tpu.utils import cameras, lie

pytestmark = pytest.mark.slow  # e2e tier: excluded from the smoke run

RNG = np.random.default_rng(97)
CAM = jnp.asarray([300.0, 300.0, 320.0, 200.0], dtype=jnp.float32)
F = 160
N_PTS = 360


def build_ring_world():
    ang = np.linspace(0, 2 * np.pi, N_PTS, endpoint=False)
    r_wall = 6.0
    pts = np.stack([r_wall * np.cos(ang),
                    RNG.uniform(-1.5, 1.5, N_PTS),
                    r_wall * np.sin(ang)], axis=1).astype(np.float32)
    descs = RNG.integers(0, 2, size=(N_PTS, 256)).astype(np.int8)
    return pts, descs


def kf_pose(theta, radius=2.0):
    c = np.array([radius * np.cos(theta), 0.0, radius * np.sin(theta)],
                 dtype=np.float32)
    fwd = np.array([np.cos(theta), 0.0, np.sin(theta)], dtype=np.float32)
    up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    right = np.cross(up, fwd); right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_cw = np.stack([right, down, fwd], axis=1).astype(np.float32)
    R = R_cw.T
    return R, -R @ c


def visible_subset(R, t, pts):
    p_c = pts @ R.T + t
    uv = np.array(cameras.pinhole_project(CAM, jnp.asarray(p_c)))
    ok = (p_c[:, 2] > 1.0) & (uv[:, 0] > 5) & (uv[:, 0] < 635) & \
         (uv[:, 1] > 5) & (uv[:, 1] < 395)
    return ok, uv


def build_drifted_ring(n_kf=12, drift_per_kf=0.012,
                       rot_drift_mask=(0.0, 0.3, 0.0)):
    """Drifted circular trajectory; the default rotation-drift mask is
    yaw-only — the inertial scenario, where gravity pins pitch/roll."""
    pts, descs = build_ring_world()
    m = ms.empty_map(max_kf=32, max_mp=1024, n_feat=F)
    thetas = np.linspace(0, 2 * np.pi, n_kf, endpoint=False)
    thetas = np.concatenate([thetas, [0.02]])

    true_poses, est_poses = [], []
    drift = np.zeros(6, np.float32)
    mask = np.array([1, 1, 1, *rot_drift_mask], np.float32)
    first = np.full(N_PTS, -1, np.int32)
    dup_ids = {}
    last = len(thetas) - 1
    for i, th in enumerate(thetas):
        R, t = kf_pose(th)
        true_poses.append((R, t))
        if i > 0:
            drift += (RNG.normal(size=6) * drift_per_kf).astype(np.float32) * mask
        dR, dt = lie.se3_exp(jnp.asarray(drift))
        Re, te = lie.se3_compose(dR, dt, jnp.asarray(R), jnp.asarray(t))
        est_poses.append((np.asarray(Re), np.asarray(te)))

        ok, uv = visible_subset(R, t, pts)
        sel = np.nonzero(ok)[0][:F]
        xy = np.zeros((F, 2), np.float32)
        desc = np.zeros((F, 256), np.int8)
        fv = np.zeros(F, bool)
        assoc = np.full(F, -1, np.int32)
        xy[:len(sel)] = uv[sel]
        desc[:len(sel)] = descs[sel]
        fv[:len(sel)] = True
        if i < last:
            assoc[:len(sel)] = sel
            first[sel[first[sel] < 0]] = i
        else:
            ids = 500 + np.arange(len(sel), dtype=np.int32)
            assoc[:len(sel)] = ids
            dup_ids = {int(d): int(p) for d, p in zip(ids, sel)}
        m, _ = ms.insert_keyframe(
            m, jnp.asarray(est_poses[-1][0]), jnp.asarray(est_poses[-1][1]),
            jnp.float32(i), jnp.asarray(xy), jnp.zeros(F, jnp.int32),
            jnp.asarray(desc), jnp.asarray(fv), jnp.asarray(assoc),
            jnp.zeros(F, jnp.float32))

    mp_pos = np.zeros((1024, 3), np.float32)
    mp_valid = np.zeros(1024, bool)
    mp_desc = np.zeros((1024, 256), np.int8)
    mp_first = np.full(1024, -1, np.int32)
    for p in range(N_PTS):
        if first[p] < 0:
            continue
        R_true, t_true = true_poses[first[p]]
        Re, te = est_poses[first[p]]
        p_cam = R_true @ pts[p] + t_true
        mp_pos[p] = np.asarray(Re).T @ (p_cam - te)
        mp_valid[p] = True
        mp_desc[p] = descs[p]
        mp_first[p] = first[p]
    for d, p in dup_ids.items():
        R_true, t_true = true_poses[last]
        Re, te = est_poses[last]
        p_cam = R_true @ pts[p] + t_true
        mp_pos[d] = np.asarray(Re).T @ (p_cam - te)
        mp_valid[d] = True
        mp_desc[d] = descs[p]
        mp_first[d] = last
    m = m._replace(mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
                   mp_desc=jnp.asarray(mp_desc),
                   mp_first_kf=jnp.asarray(mp_first), n_mp=jnp.int32(700))
    return m, true_poses, est_poses, descs


def make_closer(m, descs, inertial, **kw):
    n_kf = int(m.n_kf)
    voc = vb.train_vocabulary(descs, k=4, depth=3)
    pr = PlaceRecognition(voc, max_kf=32)
    for i in range(n_kf):
        pr.add(i, m.kf_desc[i], m.kf_feat_valid[i])
    lc = LoopCloser(SlamConfig(), pr, consistency_needed=1, **kw)
    lc.inertial = inertial
    lc.last_loop_kf = -999
    return lc


def pose_err(mm, true_poses):
    errs = []
    for i in range(len(true_poses)):
        R_true, t_true = true_poses[i]
        c_true = -R_true.T @ t_true
        R = np.asarray(mm.kf_R[i]); t = np.asarray(mm.kf_t[i])
        errs.append(np.linalg.norm(-R.T @ t - c_true))
    return np.asarray(errs)


class TestInertialLoopClosing:
    def test_4dof_correction_is_yaw_only_and_reduces_error(self):
        m, true_poses, est_poses, descs = build_drifted_ring()
        n_kf = int(m.n_kf)
        lc = make_closer(m, descs, inertial=True, gba_iters=0)
        m2 = lc.on_keyframe(m, n_kf - 1, CAM)
        assert lc.n_loops == 1, "inertial loop not detected"

        err_before = pose_err(m, true_poses)
        err_after = pose_err(m2, true_poses)
        assert err_after[-1] < err_before[-1] * 0.5
        assert err_after.mean() < err_before.mean()

        # every keyframe's correction must be pure yaw: pitch/roll (pinned by
        # gravity in an IMU-initialized map) unchanged by the 4-DoF graph
        for i in range(n_kf):
            dR = np.asarray(m2.kf_R[i]) @ np.asarray(m.kf_R[i]).T
            phi = np.asarray(lie.so3_log(jnp.asarray(dR)))
            assert abs(phi[0]) < 1e-4 and abs(phi[2]) < 1e-4, (i, phi)

    def test_pitch_heavy_loop_rejected_by_inertial_gate(self):
        # pitch/roll drift: a visual map would close this loop; the inertial
        # gate must reject the hypothesis (gravity says the correction is
        # inconsistent) — LoopClosing.cc:144-163
        m, true_poses, est_poses, descs = build_drifted_ring(
            rot_drift_mask=(0.6, 0.0, 0.6))
        n_kf = int(m.n_kf)
        lc = make_closer(m, descs, inertial=True, gba_iters=0)
        m2 = lc.on_keyframe(m, n_kf - 1, CAM)
        assert lc.n_loops == 0, "pitch-heavy loop should be gated"
        # the same map closes fine in visual mode
        lc_v = make_closer(m, descs, inertial=False, gba_iters=0)
        lc_v.on_keyframe(m, n_kf - 1, CAM)
        assert lc_v.n_loops == 1

    def test_sim3_mode_bends_pitch_4dof_does_not(self):
        m, true_poses, est_poses, descs = build_drifted_ring()
        n_kf = int(m.n_kf)
        lc_v = make_closer(m, descs, inertial=False, gba_iters=0)
        m_sim3 = lc_v.on_keyframe(m, n_kf - 1, CAM)
        assert lc_v.n_loops == 1
        # the 7-DoF graph redistributes the correction over ALL axes: some
        # mid-chain keyframe picks up pitch/roll (fine visually, wrong for a
        # gravity-aligned map)
        max_pr = 0.0
        for i in range(n_kf):
            dR = np.asarray(m_sim3.kf_R[i]) @ np.asarray(m.kf_R[i]).T
            phi = np.asarray(lie.so3_log(jnp.asarray(dR)))
            max_pr = max(max_pr, abs(float(phi[0])), abs(float(phi[2])))
        assert max_pr > 1e-4, "sim3 run produced no off-yaw motion; test moot"


class TestAsyncGBAMerge:
    def test_merge_propagates_new_keyframes_through_tree(self):
        m, true_poses, est_poses, descs = build_drifted_ring()
        n_kf0 = int(m.n_kf)

        # "GBA result": shift every snapshot keyframe by a known world delta
        dR, dt = lie.se3_exp(jnp.asarray(
            np.array([0.3, -0.2, 0.1, 0.0, 0.05, 0.0], np.float32)))
        gba_R = jnp.einsum("kij,jl->kil", m.kf_R, jnp.swapaxes(dR, -1, -2))
        gba_t = m.kf_t - jnp.einsum("kij,j->ki", gba_R, dt)
        gba_pos = jnp.einsum("ij,pj->pi", dR, m.mp_pos) + dt

        # two keyframes arrive while the GBA runs, children of KF n_kf0-1
        m2 = m
        for j in range(2):
            xy = np.asarray(m.kf_xy[n_kf0 - 1])
            assoc = np.asarray(m.kf_mp[n_kf0 - 1])
            fv = np.asarray(m.kf_feat_valid[n_kf0 - 1])
            R_new = np.asarray(m.kf_R[n_kf0 - 1])
            t_new = np.asarray(m.kf_t[n_kf0 - 1]) + np.float32(0.1 * (j + 1))
            m2, kid = ms.insert_keyframe(
                m2, jnp.asarray(R_new), jnp.asarray(t_new), jnp.float32(99 + j),
                jnp.asarray(xy), jnp.zeros(F, jnp.int32),
                m.kf_desc[n_kf0 - 1], jnp.asarray(fv), jnp.asarray(assoc),
                jnp.zeros(F, jnp.float32))
            assert int(kid) == n_kf0 + j
            assert int(m2.kf_parent[int(kid)]) >= 0

        # a landmark born during the GBA in a recycled slot (the slot held
        # another landmark at launch): it must re-anchor through its own
        # first keyframe, not take the dead occupant's GBA position
        s = int(np.flatnonzero(np.asarray(m.mp_valid))[0])
        p_born = np.asarray(m.mp_pos[s]) + np.float32(0.5)
        m2 = m2._replace(mp_pos=m2.mp_pos.at[s].set(jnp.asarray(p_born)),
                         mp_first_kf=m2.mp_first_kf.at[s].set(n_kf0))

        m3 = merge_gba_result(m2, gba_R, gba_t, gba_pos, jnp.int32(n_kf0),
                              m.mp_valid, m.mp_first_kf)
        Rb, tb = np.asarray(m2.kf_R[n_kf0]), np.asarray(m2.kf_t[n_kf0])
        Ra, ta = np.asarray(m3.kf_R[n_kf0]), np.asarray(m3.kf_t[n_kf0])
        np.testing.assert_allclose(np.asarray(m3.mp_pos[s]),
                                   Ra.T @ (Rb @ p_born + tb - ta), atol=1e-4)
        # snapshot keyframes take the GBA pose exactly
        np.testing.assert_allclose(np.asarray(m3.kf_R[:n_kf0]),
                                   np.asarray(gba_R[:n_kf0]), atol=1e-5)
        # new keyframes moved rigidly with their parent: relative pose to the
        # parent is preserved
        for j in range(2):
            kid = n_kf0 + j
            par = int(m2.kf_parent[kid])
            Rr_b, tr_b = lie.se3_compose(
                m2.kf_R[kid], m2.kf_t[kid],
                *lie.se3_inverse(m2.kf_R[par], m2.kf_t[par]))
            Rr_a, tr_a = lie.se3_compose(
                m3.kf_R[kid], m3.kf_t[kid],
                *lie.se3_inverse(m3.kf_R[par], m3.kf_t[par]))
            np.testing.assert_allclose(np.asarray(Rr_a), np.asarray(Rr_b),
                                       atol=1e-5)
            np.testing.assert_allclose(np.asarray(tr_a), np.asarray(tr_b),
                                       atol=1e-4)
        # snapshot landmarks take the GBA position exactly
        mp_old = np.array(m.mp_valid)
        mp_old[s] = False
        np.testing.assert_allclose(np.asarray(m3.mp_pos)[mp_old],
                                   np.asarray(gba_pos)[mp_old], atol=1e-5)

    def test_async_gba_thread_runs_and_merges(self):
        from orbslam3lib_tpu.tracking.tracker import Tracker
        m, true_poses, est_poses, descs = build_drifted_ring()
        n_kf = int(m.n_kf)
        cfg = SlamConfig()
        cfg.map.max_kf = 32
        cfg.map.max_mp = 1024
        cfg.orb.max_kp = F
        cfg.mapping.async_gba = True
        tr = Tracker(cfg, sensor="stereo", enable_loop_closing=False)
        tr.map = m
        tr.loop_closer = make_closer(m, descs, inertial=False, gba_iters=4)
        tr.loop_closer.async_gba = True

        # loop correction, then the GBA spawns on its own thread
        with tr._map_lock:
            n0 = tr.loop_closer.n_loops
            tr.map = tr.loop_closer.on_keyframe(tr.map, n_kf - 1, CAM)
            assert tr.loop_closer.n_loops > n0
            tr._maybe_start_gba()
        assert tr._gba_thread is not None and tr._gba_thread.is_alive()
        err_pre = pose_err(tr.map, true_poses).mean()

        # the tracker keeps working while the GBA runs
        with tr._map_lock:
            xy = np.asarray(m.kf_xy[n_kf - 1])
            assoc = np.asarray(m.kf_mp[n_kf - 1])
            tr.map, kid = ms.insert_keyframe(
                tr.map, tr.map.kf_R[n_kf - 1], tr.map.kf_t[n_kf - 1],
                jnp.float32(99.0), jnp.asarray(xy), jnp.zeros(F, jnp.int32),
                m.kf_desc[n_kf - 1], m.kf_feat_valid[n_kf - 1],
                jnp.asarray(assoc), jnp.zeros(F, jnp.float32))
        tr.wait_gba()
        assert int(tr.map.n_kf) == n_kf + 1          # new KF survived merge
        err_post = pose_err(tr.map, true_poses).mean()
        assert err_post <= err_pre * 1.2 + 1e-3      # GBA did not corrupt

    def test_abort_discards_inflight_gba(self):
        from orbslam3lib_tpu.tracking.tracker import Tracker
        m, true_poses, est_poses, descs = build_drifted_ring()
        cfg = SlamConfig()
        cfg.map.max_kf = 32
        cfg.map.max_mp = 1024
        cfg.orb.max_kp = F
        cfg.mapping.async_gba = True
        tr = Tracker(cfg, sensor="stereo", enable_loop_closing=False)
        tr.map = m
        tr.loop_closer = make_closer(m, descs, inertial=False, gba_iters=50)
        tr.loop_closer.async_gba = True
        with tr._map_lock:
            tr._maybe_start_gba()
        before = np.asarray(tr.map.kf_t)
        time.sleep(0.05)
        tr._abort_gba_and_join()
        assert tr._gba_thread is None
        # aborted GBA never mutates the live map
        np.testing.assert_array_equal(before, np.asarray(tr.map.kf_t))

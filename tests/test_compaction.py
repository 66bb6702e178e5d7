"""Slot recycling: map compaction unit tests + a long-sequence e2e run with
a small keyframe capacity (the reference's maps grow unbounded on the heap;
the fixed-capacity tensor map reclaims culled slots instead).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3lib_tpu.models import map_state as ms


def _toy_map(n_kf=6, n_mp=10, max_kf=8, max_mp=16, n_feat=8):
    m = ms.empty_map(max_kf=max_kf, max_mp=max_mp, n_feat=n_feat)
    rng = np.random.default_rng(0)
    for k in range(n_kf):
        xy = rng.uniform(0, 100, (n_feat, 2)).astype(np.float32)
        desc = rng.integers(0, 2, (n_feat, 256)).astype(np.int8)
        # each KF observes landmarks k..k+4 in its first feature slots
        # (covers all 10 landmarks across the 6 KFs; mp 9 only by KF 5)
        assoc = np.full(n_feat, -1, np.int32)
        for s in range(5):
            mp = k + s
            if mp < n_mp:
                assoc[s] = mp
        m, kid = ms.insert_keyframe(
            m, jnp.eye(3), jnp.asarray([0.0, 0.0, float(k)]),
            jnp.float32(k * 0.5), jnp.asarray(xy),
            jnp.zeros(n_feat, jnp.int32), jnp.asarray(desc),
            jnp.ones(n_feat, bool), jnp.asarray(assoc),
            jnp.zeros(n_feat, jnp.float32))
        assert int(kid) == k
    pos = rng.uniform(-5, 5, (n_mp, 3)).astype(np.float32)
    m = m._replace(
        mp_pos=m.mp_pos.at[:n_mp].set(jnp.asarray(pos)),
        mp_valid=m.mp_valid.at[:n_mp].set(True),
        mp_first_kf=m.mp_first_kf.at[:n_mp].set(
            jnp.arange(n_mp, dtype=jnp.int32) % 6),
        n_mp=jnp.int32(n_mp),
    )
    return m


class TestCompactMap:
    def test_noop_when_nothing_culled(self):
        m = _toy_map()
        m2, kf_new, mp_new = ms.compact_map(m)
        assert int(m2.n_kf) == int(m.n_kf)
        assert int(m2.n_mp) == int(m.n_mp)
        np.testing.assert_array_equal(np.asarray(kf_new)[:6], np.arange(6))
        np.testing.assert_allclose(np.asarray(m2.kf_t)[:6],
                                   np.asarray(m.kf_t)[:6])

    def test_culled_kf_slots_reclaimed_in_order(self):
        m = _toy_map()
        m = m._replace(kf_valid=m.kf_valid.at[1].set(False).at[3].set(False))
        m2, kf_new, mp_new = ms.compact_map(m)
        kf_new = np.asarray(kf_new)
        assert int(m2.n_kf) == 4
        # order preserved: 0,2,4,5 -> 0,1,2,3
        np.testing.assert_array_equal(kf_new[:6], [0, -1, 1, -1, 2, 3])
        # timestamps moved with the keyframes
        np.testing.assert_allclose(np.asarray(m2.kf_ts)[:4],
                                   [0.0, 1.0, 2.0, 2.5])
        # observations rewritten through the landmark permutation
        mp_new = np.asarray(mp_new)
        old_row = np.asarray(m.kf_mp)[4]
        new_row = np.asarray(m2.kf_mp)[2]
        for s in range(8):
            if old_row[s] >= 0 and mp_new[old_row[s]] >= 0:
                assert new_row[s] == mp_new[old_row[s]]

    def test_orphan_and_culled_landmarks_dropped(self):
        m = _toy_map()
        # cull landmark 2 explicitly; landmark 9 observed only by KF 5 ->
        # culling KF 5 orphans it
        m = m._replace(mp_valid=m.mp_valid.at[2].set(False),
                       kf_valid=m.kf_valid.at[5].set(False))
        # landmark 9 is observed by KFs 5 (9-3..9): with n_kf=6 assoc built
        # k..k+3, mp 9 seen by KF 5 only (assoc slots: k=5 -> 5,6,7,8... )
        m2, kf_new, mp_new = ms.compact_map(m)
        mp_new = np.asarray(mp_new)
        assert mp_new[2] == -1
        # every surviving landmark is observed by >=1 surviving keyframe
        obs = np.asarray(ms.mp_observation_count(m2))
        n_mp2 = int(m2.n_mp)
        assert (obs[:n_mp2] >= 1).all()
        # positions moved with the permutation
        for old in range(10):
            if mp_new[old] >= 0:
                np.testing.assert_allclose(
                    np.asarray(m2.mp_pos)[mp_new[old]],
                    np.asarray(m.mp_pos)[old])

    def test_mp_first_kf_remapped(self):
        m = _toy_map()
        m = m._replace(kf_valid=m.kf_valid.at[0].set(False))
        m2, kf_new, mp_new = ms.compact_map(m)
        kf_new, mp_new = np.asarray(kf_new), np.asarray(mp_new)
        first_old = np.asarray(m.mp_first_kf)
        first_new = np.asarray(m2.mp_first_kf)
        for old in range(10):
            if mp_new[old] >= 0 and first_old[old] >= 0:
                expect = kf_new[first_old[old]]
                assert first_new[mp_new[old]] == expect


@pytest.mark.slow
def test_long_sequence_with_recycling():
    """Long run with a small keyframe capacity: culling + compaction must
    keep keyframe insertion alive (without recycling the tracker hits the
    max_kf wall and stops inserting -> tracking degrades on new terrain)."""
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.io.synthetic import render_stereo_sequence
    from orbslam3lib_tpu.tracking.tracker import OK, Tracker

    frames, rig, world = render_stereo_sequence(n_frames=150, dt=1.0 / 15.0,
                                                seed=7)
    cfg = SlamConfig()
    cfg.map.max_kf = 24
    cfg.map.max_mp = 2048
    cfg.orb.max_kp = 384
    cfg.orb.target_features = 300
    cfg.orb.fast_threshold = 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points = 1024
    cfg.ba.window_size = 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    cfg.tracker.min_frames_between_kf = 1
    cfg.tracker.kf_ref_ratio = 10.0   # force dense keyframing -> hits cap

    tracker = Tracker(cfg, sensor="stereo", enable_loop_closing=True,
                      pipeline=8, chunk=4)
    for img_pair, _, ts in frames:
        tracker.process_frame(img_pair, ts)
    tracker.finish()
    assert tracker.state == OK
    assert tracker.stats["track_fail"] == 0
    # keyframes kept flowing long past the nominal capacity
    assert tracker.stats["n_kf"] > cfg.map.max_kf * 1.5
    assert int(tracker.map.n_kf) <= cfg.map.max_kf

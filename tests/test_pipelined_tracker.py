"""Pipelined tracker fast path (SURVEY.md §2.4 P1): the fused frame step +
burst-fetched scalar packs must reproduce the synchronous path's tracking
quality, and loss inside a burst must drain cleanly back to the sync path."""
import numpy as np
import pytest

from orbslam3lib_tpu.config import SlamConfig
from orbslam3lib_tpu.evaluation import ate_rmse
from orbslam3lib_tpu.io.synthetic import render_stereo_sequence
from orbslam3lib_tpu.tracking.tracker import OK, RECENTLY_LOST, Tracker

pytestmark = pytest.mark.slow  # e2e tier: excluded from the smoke run


def small_config(rig) -> SlamConfig:
    cfg = SlamConfig()
    cfg.map.max_kf = 64
    cfg.map.max_mp = 4096
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
    return cfg


@pytest.fixture(scope="module")
def sequence():
    return render_stereo_sequence(n_frames=40, dt=1.0 / 15.0, seed=5)


class TestPipelinedTracker:
    def test_matches_sync_quality(self, sequence):
        frames, rig, _ = sequence
        tr = Tracker(small_config(rig), sensor="stereo",
                     enable_loop_closing=False, pipeline=6, chunk=2)
        for img_pair, _, ts in frames:
            tr.process_frame(img_pair, ts)
        tr.finish()
        assert tr.state == OK
        assert tr.stats["track_fail"] == 0
        assert tr.stats["n_kf"] >= 2
        est = tr.trajectory_centers()
        assert len(est) == len(frames)
        gt = np.stack([-R.T @ t for _, (R, t), _ in frames[-len(est):]])
        assert ate_rmse(est, gt) < 0.05

    def test_gba_merge_mid_stream_keeps_tracking(self, sequence):
        """A global BA that finishes while frames are in flight moves the
        whole map; the tracker must follow it (here: a known rigid shift of
        the map) without losing a frame."""
        import jax.numpy as jnp
        from orbslam3lib_tpu.utils import lie
        frames, rig, _ = sequence
        tr = Tracker(small_config(rig), sensor="stereo",
                     enable_loop_closing=False, pipeline=6, chunk=2)
        for img_pair, _, ts in frames[:20]:
            tr.process_frame(img_pair, ts)
        assert tr._pending, "no frames in flight: test moot"
        m = tr.map
        dR, dt = lie.se3_exp(jnp.asarray([0.02, -0.15, 0.05, 0.3, 0.0, -0.1],
                                         jnp.float32))
        gba_R = jnp.einsum("kij,jl->kil", m.kf_R, dR.T)
        tr._gba_result = (gba_R, m.kf_t - jnp.einsum("kij,j->ki", gba_R, dt),
                          m.mp_pos @ dR.T + dt, jnp.int32(int(m.n_kf)),
                          m.mp_valid, m.mp_first_kf)
        for img_pair, _, ts in frames[20:]:
            tr.process_frame(img_pair, ts)
        tr.finish()
        assert tr.stats["n_gba_merged"] == 1
        assert tr.state == OK and tr.stats["track_fail"] == 0
        # after the merge the trajectory lives in the shifted world
        est = tr.trajectory_centers()[-15:]
        gt = np.stack([np.asarray(dR) @ (-R.T @ t) + np.asarray(dt)
                       for _, (R, t), _ in frames[-15:]])
        assert ate_rmse(est, gt) < 0.05

    def test_loss_in_burst_drains_to_sync(self, sequence):
        frames, rig, _ = sequence
        tr = Tracker(small_config(rig), sensor="stereo",
                     enable_loop_closing=False, pipeline=6, chunk=2)
        rng = np.random.default_rng(0)
        for i, (img_pair, _, ts) in enumerate(frames[:24]):
            if 12 <= i < 18:  # blind the camera mid-burst
                img_pair = rng.uniform(0, 255, img_pair.shape).astype(np.float32)
            tr.process_frame(img_pair, ts)
        tr.finish()
        assert tr.stats["track_fail"] >= 1
        # after the blind window the sync path recovers or stays recently-lost
        assert tr.state in (OK, RECENTLY_LOST)
        assert not tr._pending

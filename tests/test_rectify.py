"""Pinhole radial-tangential distortion model + stereo rectification.

Covers the reference's raw-input geometry path: Settings.cc:485
precomputeRectificationMaps (cv::stereoRectify + initUndistortRectifyMap)
and Frame.cc:156 UndistortKeyPoints (subsumed here by the PINHOLE_RADTAN
camera model used natively by every projection)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orbslam3lib_tpu.utils import cameras
from orbslam3lib_tpu.utils.rectify import remap_bilinear, stereo_rectify

DIST = (-0.28, 0.07, 1e-4, 1.8e-5, 0.0)   # EuRoC cam0-like distortion
PARAMS = np.asarray([458.0, 457.0, 367.0, 248.0, *DIST], np.float32)


class TestRadtanModel:
    def test_project_unproject_roundtrip(self):
        rng = np.random.default_rng(3)
        p = rng.uniform([-2, -1.5, 2], [2, 1.5, 10], size=(256, 3)).astype(np.float32)
        uv = cameras.radtan_project(jnp.asarray(PARAMS), jnp.asarray(p))
        ray = cameras.radtan_unproject(jnp.asarray(PARAMS), uv)
        # rays are z=1; compare directions against the input points
        d = np.asarray(ray) * p[:, 2:3]
        np.testing.assert_allclose(d, p, rtol=0, atol=2e-3)

    def test_jacobian_matches_autodiff(self):
        rng = np.random.default_rng(4)
        p = rng.uniform([-1, -1, 3], [1, 1, 8], size=(32, 3)).astype(np.float32)
        J = np.asarray(cameras.radtan_project_jac(jnp.asarray(PARAMS),
                                                  jnp.asarray(p)))
        Jad = np.asarray(jax.vmap(jax.jacfwd(
            lambda q: cameras.radtan_project(jnp.asarray(PARAMS), q)))(
                jnp.asarray(p)))
        np.testing.assert_allclose(J, Jad, rtol=1e-3, atol=1e-3)

    def test_zero_dist_matches_pinhole(self):
        prm = np.asarray([300.0, 300.0, 320.0, 200.0, 0, 0, 0, 0, 0],
                         np.float32)
        p = np.asarray([[0.3, -0.2, 4.0]], np.float32)
        uv_r = cameras.radtan_project(jnp.asarray(prm), jnp.asarray(p))
        uv_p = cameras.pinhole_project(jnp.asarray(prm[:4]), jnp.asarray(p))
        np.testing.assert_allclose(np.asarray(uv_r), np.asarray(uv_p),
                                   atol=1e-4)


class TestStereoRectify:
    def test_identity_rig_is_identity_map(self):
        """An already-rectified undistorted rig rectifies to ~identity."""
        prm = np.asarray([300.0, 300.0, 320.0, 200.0], np.float32)
        rr = stereo_rectify(prm, prm, cameras.PINHOLE, cameras.PINHOLE,
                            np.eye(3), np.asarray([0.11, 0, 0]), 640, 400)
        assert abs(rr.baseline - 0.11) < 1e-6
        u, v = np.meshgrid(np.arange(640, dtype=np.float32),
                           np.arange(400, dtype=np.float32))
        np.testing.assert_allclose(rr.maps[0, ..., 0], u, atol=0.51)
        np.testing.assert_allclose(rr.maps[0, ..., 1], v, atol=0.51)
        np.testing.assert_allclose(rr.maps[1, ..., 0], u, atol=0.51)

    def test_remap_bilinear_identity(self):
        rng = np.random.default_rng(6)
        img = rng.uniform(0, 255, size=(40, 60)).astype(np.float32)
        u, v = np.meshgrid(np.arange(60, dtype=np.float32),
                           np.arange(40, dtype=np.float32))
        mp = jnp.asarray(np.stack([u, v], axis=-1))
        out = np.asarray(remap_bilinear(jnp.asarray(img), mp))
        np.testing.assert_allclose(out[1:-1, 1:-1], img[1:-1, 1:-1],
                                   atol=1e-3)


def _small_rot(ax, ay, az):
    from orbslam3lib_tpu.utils import lie
    R, _ = lie.se3_exp(jnp.asarray([0, 0, 0, ax, ay, az], jnp.float32))
    return np.asarray(R)


class TestRectifyGeometry:
    def test_epipolar_rows_align(self):
        """Project world points through the raw rig into both eyes, pull the
        pixels through the rectification maps' inverse relationship: the
        rectified projections must share rows and have disparity = bf/z."""
        prm_l = PARAMS
        prm_r = np.asarray([455.0, 454.0, 379.0, 255.0, -0.28, 0.07,
                            -1e-4, 2e-5, 0.0], np.float32)
        R_lr = _small_rot(0.01, -0.02, 0.015)
        t_lr = np.asarray([0.11, 0.002, -0.001], np.float32)
        rr = stereo_rectify(prm_l, prm_r, cameras.PINHOLE_RADTAN,
                            cameras.PINHOLE_RADTAN, R_lr, t_lr, 640, 400)
        rng = np.random.default_rng(7)
        p_l = rng.uniform([-1.5, -1, 3], [1.5, 1, 12], size=(128, 3)).astype(np.float32)
        # rectified-left camera frame: x_new = Ra x_l
        p_rect_l = p_l @ rr.R_rect[0].T
        uv_l = np.asarray(cameras.pinhole_project(
            jnp.asarray(rr.new_params), jnp.asarray(p_rect_l)))
        # right cam: x_r = R_lr^T (x_l - t_lr); rectified right: Rb x_r
        p_r = (p_l - t_lr) @ R_lr
        p_rect_r = p_r @ rr.R_rect[1].T
        uv_r = np.asarray(cameras.pinhole_project(
            jnp.asarray(rr.new_params), jnp.asarray(p_rect_r)))
        inb = (np.abs(uv_l[:, 0] - 320) < 300) & (np.abs(uv_l[:, 1] - 200) < 180)
        assert inb.sum() > 50
        # same row in both eyes
        np.testing.assert_allclose(uv_l[inb, 1], uv_r[inb, 1], atol=0.2)
        # disparity = f*b/z of the rectified-left point
        disp = uv_l[inb, 0] - uv_r[inb, 0]
        z = p_rect_l[inb, 2]
        np.testing.assert_allclose(
            disp, rr.new_params[0] * rr.baseline / z, rtol=2e-3, atol=0.2)


@pytest.mark.slow
class TestRectifiedTrackerE2E:
    def test_distorted_stereo_tracks(self):
        """Raw distorted, unrectified stereo input end-to-end: the tracker
        rectifies on device and must initialize + track with low ATE."""
        from orbslam3lib_tpu.config import CameraConfig, SlamConfig
        from orbslam3lib_tpu.io.synthetic import (CorridorWorld, StereoRig,
                                                  corridor_trajectory)
        from orbslam3lib_tpu.tracking.tracker import Tracker

        dist = (-0.12, 0.03, 5e-4, -4e-4, 0.0)
        rig = StereoRig(dist=dist)
        R_lr = _small_rot(0.004, -0.008, 0.006)
        t_lr = np.asarray([rig.baseline, 0.001, -0.0015], np.float32)
        world = CorridorWorld(z1=120.0)
        n_frames = 30
        R_l, c_l, ts = corridor_trajectory(n_frames, dt=1 / 15, speed=0.6)
        rng = np.random.default_rng(0)
        imgs = np.zeros((n_frames, 2, rig.height, rig.width), np.uint8)
        for i in range(n_frames):
            # right camera pose from the raw (unrectified) extrinsic
            R_cw_r = R_l[i] @ R_lr
            c_r = c_l[i] + R_l[i] @ t_lr
            imgs[i, 0] = world.render(R_l[i], c_l[i], rig, rng=rng).astype(np.uint8)
            imgs[i, 1] = world.render(R_cw_r, c_r, rig, rng=rng).astype(np.uint8)

        cfg = SlamConfig()
        cfg.camera = CameraConfig(fx=rig.fx, fy=rig.fy, cx=rig.cx, cy=rig.cy,
                                  dist=dist, width=rig.width,
                                  height=rig.height)
        cfg.camera2 = CameraConfig(fx=rig.fx, fy=rig.fy, cx=rig.cx,
                                   cy=rig.cy, dist=dist, width=rig.width,
                                   height=rig.height)
        cfg.stereo.R_lr = tuple(R_lr.reshape(-1).tolist())
        cfg.stereo.t_lr = tuple(t_lr.tolist())
        cfg.stereo.rectify = True
        cfg.orb.max_kp = 512
        tracker = Tracker(cfg, sensor="stereo", enable_loop_closing=False)
        assert tracker._rect_maps is not None
        assert cfg.camera.model_id == cameras.PINHOLE  # effective rig
        for i in range(n_frames):
            tracker.process_frame(imgs[i], float(ts[i]))
        tracker.finish()
        assert tracker.state == 1, "tracking lost on rectified input"
        assert tracker.stats["track_fail"] == 0
        # ATE of camera centers vs ground truth. The SLAM world is the
        # FIRST RECTIFIED left-camera frame: orientation R_l[0] @ Ra^T,
        # origin at the first camera center (rotation preserves the center).
        rr = stereo_rectify(rig.params, rig.params,
                            cameras.PINHOLE_RADTAN, cameras.PINHOLE_RADTAN,
                            R_lr, t_lr, rig.width, rig.height)
        centers = tracker.trajectory_centers()
        R0 = R_l[0] @ rr.R_rect[0].T        # world-from-rect-cam0
        c_w_est = centers @ R0.T + c_l[0]
        gt = c_l[-len(centers):]
        err = np.linalg.norm(c_w_est - gt, axis=1)
        assert err.mean() < 0.05, err.mean()


class TestRemapShifts:
    """The shift-accumulate two-pass remap (the tracker's path) against the
    exact gather-based bilinear oracle on real rectification maps."""

    def test_matches_exact_on_rectify_maps(self):
        import numpy as np
        from orbslam3lib_tpu.utils.rectify import (remap_bilinear,
                                                   remap_bilinear_shifts,
                                                   remap_bounds,
                                                   twopass_maps)
        W, H = 160, 100
        params = np.array([80.0, 80.0, 80.0, 50.0,
                           -0.2834, 0.0739, 0.0002, 0.0, 0.0], np.float32)
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.1, 0.0, 0.0], np.float32)
        rr = stereo_rectify(params, params, 1, 1, R, t, W, H)
        mp2 = twopass_maps(rr.maps)
        b = remap_bounds(mp2)
        rng = np.random.default_rng(0)
        # smooth image: two-pass vs direct bilinear are both valid filters;
        # they agree tightly away from high-frequency content
        base = rng.uniform(0, 255, (2, H // 10, W // 10)).astype(np.float32)
        img = np.kron(base, np.ones((10, 10), np.float32))
        from scipy.ndimage import gaussian_filter
        img = gaussian_filter(img, sigma=(0, 2, 2)).astype(np.float32)
        exact = np.asarray(remap_bilinear(jnp.asarray(img),
                                          jnp.asarray(rr.maps)))
        fast = np.asarray(remap_bilinear_shifts(jnp.asarray(img),
                                                jnp.asarray(mp2), *b))
        nz = exact > 1e-3
        diff = np.abs(exact - fast)[nz]
        assert diff.mean() < 1.0, diff.mean()
        assert np.quantile(diff, 0.99) < 5.0

    def test_identity_map_is_exact(self):
        import numpy as np
        from orbslam3lib_tpu.utils.rectify import (remap_bilinear_shifts,
                                                   remap_bounds,
                                                   twopass_maps)
        H, W = 40, 60
        u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32))
        mp = np.stack([u, v], axis=-1)[None]
        mp2 = twopass_maps(mp)
        b = remap_bounds(mp2)
        rng = np.random.default_rng(1)
        img = rng.uniform(0, 255, (1, H, W)).astype(np.float32)
        out = np.asarray(remap_bilinear_shifts(jnp.asarray(img),
                                               jnp.asarray(mp2), *b))
        np.testing.assert_allclose(out[:, : H - 1, : W - 1],
                                   img[:, : H - 1, : W - 1], atol=1e-3)

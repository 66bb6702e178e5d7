"""Global bundle adjustment over the whole MapState with abort support
(RunGlobalBundleAdjustment / GlobalBundleAdjustemnt equivalents)."""
import numpy as np
import jax.numpy as jnp

from orbslam3lib_tpu.mapping.map_ba import global_bundle_adjust
from orbslam3lib_tpu.models import map_state as ms
from orbslam3lib_tpu.utils import cameras

RNG = np.random.default_rng(9)
CAM = jnp.asarray([300.0, 300.0, 320.0, 200.0], dtype=jnp.float32)
F = 128
N_PTS = 300


def noisy_map(pose_noise=0.05, pt_noise=0.05):
    pts = RNG.uniform([-4, -2, 6], [4, 2, 14], size=(N_PTS, 3)).astype(np.float32)
    descs = RNG.integers(0, 2, size=(N_PTS, 256)).astype(np.int8)
    m = ms.empty_map(max_kf=16, max_mp=512, n_feat=F)
    true_poses = []
    for i in range(6):
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.5 * i, 0.02 * i, 0.0], np.float32)
        true_poses.append((R, t))
        p_c = pts @ R.T + t
        uv = np.asarray(cameras.pinhole_project(CAM, jnp.asarray(p_c)))
        ok = (p_c[:, 2] > 0.5) & (uv[:, 0] > 2) & (uv[:, 0] < 638) & \
             (uv[:, 1] > 2) & (uv[:, 1] < 398)
        sel = np.nonzero(ok)[0][:F]
        xy = np.zeros((F, 2), np.float32); xy[:len(sel)] = uv[sel]
        desc = np.zeros((F, 256), np.int8); desc[:len(sel)] = descs[sel]
        fv = np.zeros(F, bool); fv[:len(sel)] = True
        assoc = np.full(F, -1, np.int32); assoc[:len(sel)] = sel
        # perturb all poses but the first (gauge)
        Rn, tn = R, t
        if i > 0:
            tn = t + RNG.normal(0, pose_noise, 3).astype(np.float32)
        m, _ = ms.insert_keyframe(
            m, jnp.asarray(Rn), jnp.asarray(tn), jnp.float32(i),
            jnp.asarray(xy), jnp.zeros(F, jnp.int32), jnp.asarray(desc),
            jnp.asarray(fv), jnp.asarray(assoc), jnp.zeros(F, jnp.float32))
    mp_pos = np.zeros((512, 3), np.float32)
    mp_pos[:N_PTS] = pts + RNG.normal(0, pt_noise, pts.shape).astype(np.float32)
    mp_valid = np.zeros(512, bool); mp_valid[:N_PTS] = True
    m = m._replace(mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
                   n_mp=jnp.int32(N_PTS))
    return m, true_poses, pts


def cam_err(m, true_poses):
    errs = []
    for i, (R, t) in enumerate(true_poses):
        errs.append(np.linalg.norm(np.asarray(m.kf_t[i]) - t))
    return float(np.mean(errs))


class TestGlobalBA:
    def test_converges_to_truth(self):
        m, true_poses, pts = noisy_map()
        e0 = cam_err(m, true_poses)
        m2 = global_bundle_adjust(m, CAM, bf=33.0, n_iters=15, chunk=5,
                                  n_ba_points=512)
        e1 = cam_err(m2, true_poses)
        assert e1 < 0.2 * e0, (e0, e1)
        # only landmarks observed by >= 2 keyframes are constrained by BA
        kf_mp = np.asarray(m2.kf_mp[:6])
        n_obs = np.zeros(N_PTS, np.int32)
        for row in kf_mp:
            ids = row[row >= 0]
            n_obs[ids[ids < N_PTS]] += 1
        well = n_obs >= 2
        assert well.sum() > 100
        pt_err = np.linalg.norm(
            np.asarray(m2.mp_pos[:N_PTS])[well] - pts[well], axis=1).mean()
        assert pt_err < 0.02

    def test_abort_stops_after_chunk(self):
        m, true_poses, _ = noisy_map()
        calls = {"n": 0}

        def abort():
            calls["n"] += 1
            return True  # abort after the first chunk

        m2 = global_bundle_adjust(m, CAM, bf=33.0, n_iters=100, chunk=2,
                                  n_ba_points=512, should_abort=abort)
        assert calls["n"] == 1  # polled once, honored immediately
        # one chunk of LM still improves the map
        assert cam_err(m2, true_poses) <= cam_err(m, true_poses)

    def test_chunked_schedule_prunes_outliers(self):
        """A 1-iteration chunking restarts bundle_adjust every iteration; the
        chi2 pruning must still happen once the first chunks are done, so the
        result matches the one-call schedule instead of being dragged by
        the outliers."""
        m, true_poses, _ = noisy_map()
        xy = np.asarray(m.kf_xy).copy()
        rng = np.random.default_rng(4)
        for k in range(1, 6):
            bad = rng.choice(F, F // 8, replace=False)
            xy[k, bad] += rng.choice([-1, 1], (len(bad), 2)) * 25.0
        m = m._replace(kf_xy=jnp.asarray(xy))
        one = global_bundle_adjust(m, CAM, bf=33.0, n_iters=10, chunk=10,
                                   n_ba_points=512)
        chunked = global_bundle_adjust(m, CAM, bf=33.0, n_iters=10, chunk=1,
                                       n_ba_points=512)
        e_one = cam_err(one, true_poses)
        e_chunked = cam_err(chunked, true_poses)
        assert e_chunked < 1.5 * e_one + 1e-3, (e_one, e_chunked)

"""Sliding-window visual-inertial BA (LocalInertialBA equivalent) on the
synthetic analytic trajectory."""
import numpy as np
import jax
import jax.numpy as jnp

from orbslam3lib_tpu.io.synthetic import synth_imu
from orbslam3lib_tpu.mapping.vi_ba import (VIWindowResult, apply_vi_window,
                                           local_inertial_ba)
from orbslam3lib_tpu.models import map_state as ms
from orbslam3lib_tpu.tracking import imu
from orbslam3lib_tpu.utils import cameras, lie
from tests.test_imu import gt_state

RNG = np.random.default_rng(17)
CAM = jnp.asarray([300.0, 300.0, 320.0, 200.0], dtype=jnp.float32)
F = 128
N_PTS = 256
C = 6


def build_window(pose_noise=0.03, t0=1.0, gap=0.1):
    """Map with C keyframes on the analytic trajectory (poses perturbed),
    exact landmarks + observations, exact per-gap preintegrations."""
    # world points in front of the trajectory segment
    ts = [t0 + i * gap for i in range(C)]
    centers = np.stack([gt_state(t)[2] for t in ts])
    pts = (centers.mean(0) +
           RNG.uniform([-3, -2, -3], [3, 2, 3], size=(N_PTS, 3)) +
           np.array([0, 0, 6.0])).astype(np.float32)
    descs = RNG.integers(0, 2, size=(N_PTS, 256)).astype(np.int8)

    m = ms.empty_map(max_kf=16, max_mp=512, n_feat=F)
    true_R, true_t, true_v = [], [], []
    for i, t in enumerate(ts):
        R_wb, v, p = gt_state(t)
        R = R_wb.T.astype(np.float32)
        tt = (-R @ p).astype(np.float32)
        true_R.append(R); true_t.append(tt); true_v.append(v)
        p_c = pts @ R.T + tt
        uv = np.asarray(cameras.pinhole_project(CAM, jnp.asarray(p_c)))
        ok = (p_c[:, 2] > 0.5) & (np.abs(uv[:, 0] - 320) < 315) & \
             (np.abs(uv[:, 1] - 200) < 195)
        sel = np.nonzero(ok)[0][:F]
        xy = np.zeros((F, 2), np.float32); xy[:len(sel)] = uv[sel]
        desc = np.zeros((F, 256), np.int8); desc[:len(sel)] = descs[sel]
        fv = np.zeros(F, bool); fv[:len(sel)] = True
        assoc = np.full(F, -1, np.int32); assoc[:len(sel)] = sel
        Rn, tn = R, tt
        if i > 0:  # anchor stays exact
            dxi = (RNG.normal(size=6) * pose_noise).astype(np.float32)
            dR, dt = lie.se3_exp(jnp.asarray(dxi))
            Rn2, tn2 = lie.se3_compose(dR, dt, jnp.asarray(R), jnp.asarray(tt))
            Rn, tn = np.asarray(Rn2), np.asarray(tn2)
        m, _ = ms.insert_keyframe(
            m, jnp.asarray(Rn), jnp.asarray(tn), jnp.float32(t),
            jnp.asarray(xy), jnp.zeros(F, jnp.int32), jnp.asarray(desc),
            jnp.asarray(fv), jnp.asarray(assoc), jnp.zeros(F, jnp.float32))

    mp_pos = np.zeros((512, 3), np.float32); mp_pos[:N_PTS] = pts
    mp_valid = np.zeros(512, bool); mp_valid[:N_PTS] = True
    m = m._replace(mp_pos=jnp.asarray(mp_pos), mp_valid=jnp.asarray(mp_valid),
                   n_mp=jnp.int32(N_PTS))

    pres = []
    for i in range(C - 1):
        gyro, acc, dts = synth_imu(ts[i], ts[i + 1], freq=200.0)
        pres.append(imu.integrate(
            imu.empty_preintegrated(), jnp.asarray(gyro), jnp.asarray(acc),
            jnp.asarray(dts), jnp.ones(len(dts), bool),
            jnp.float32(1e-3), jnp.float32(1e-2)))
    pres_stack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pres)
    return m, pres_stack, true_R, true_t, np.stack(true_v)


class TestLocalInertialBA:
    def test_window_converges(self):
        m, pres, true_R, true_t, true_v = build_window()
        window_ids = jnp.arange(C, dtype=jnp.int32)
        fixed = jnp.zeros(C, bool).at[0].set(True)

        def err(mm):
            return np.mean([np.linalg.norm(np.asarray(mm.kf_t[i]) - true_t[i])
                            for i in range(C)])

        e0 = err(m)
        res = local_inertial_ba(m, window_ids, fixed, pres,
                                jnp.ones(C - 1, bool), jnp.zeros(3),
                                jnp.zeros(3), CAM, bf=0.0, n_iters=8)
        m2 = apply_vi_window(m, window_ids, fixed, res)
        e1 = err(m2)
        assert e1 < 0.25 * e0, (e0, e1)
        # velocities near the analytic ground truth
        v_err = np.linalg.norm(np.asarray(res.v) - true_v, axis=1).mean()
        assert v_err < 0.08, v_err
        # biases stay near zero (unbiased synthetic IMU)
        assert np.linalg.norm(np.asarray(res.bg)) < 0.02
        assert np.linalg.norm(np.asarray(res.ba)) < 0.2

    def test_fixed_anchor_untouched(self):
        m, pres, true_R, true_t, _ = build_window()
        window_ids = jnp.arange(C, dtype=jnp.int32)
        fixed = jnp.zeros(C, bool).at[0].set(True)
        res = local_inertial_ba(m, window_ids, fixed, pres,
                                jnp.ones(C - 1, bool), jnp.zeros(3),
                                jnp.zeros(3), CAM, bf=0.0, n_iters=4)
        m2 = apply_vi_window(m, window_ids, fixed, res)
        np.testing.assert_allclose(np.asarray(m2.kf_t[0]),
                                   np.asarray(m.kf_t[0]), atol=1e-7)
        np.testing.assert_allclose(np.asarray(m2.kf_R[0]),
                                   np.asarray(m.kf_R[0]), atol=1e-7)


class TestPerKFBias:
    """Quantify the shared-window-bias approximation vs the
    reference's per-KF bias vertices (Optimizer.cc:2405) on a ground-truthed
    window, in the regime where sharing should lose: a gyro bias that RAMPS
    across the window (random walk much faster than the walk prior)."""

    def _ramped_window(self, bg_slope=np.array([0.06, -0.04, 0.08])):
        m, _, true_R, true_t, true_v = build_window()
        ts = [1.0 + i * 0.1 for i in range(C)]
        pres = []
        for i in range(C - 1):
            bg_i = (bg_slope * i / max(C - 2, 1)).astype(np.float32)
            gyro, acc, dts = synth_imu(ts[i], ts[i + 1], freq=200.0, bg=bg_i)
            pres.append(imu.integrate(
                imu.empty_preintegrated(), jnp.asarray(gyro),
                jnp.asarray(acc), jnp.asarray(dts),
                jnp.ones(len(dts), bool), jnp.float32(1e-3),
                jnp.float32(1e-2), jnp.float32(1e-3), jnp.float32(1e-2)))
        pres_stack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *pres)
        return m, pres_stack, true_t

    def test_per_kf_bias_at_least_as_good_under_bias_ramp(self):
        m, pres, true_t = self._ramped_window()
        window_ids = jnp.arange(C, dtype=jnp.int32)
        fixed = jnp.zeros(C, bool).at[0].set(True)

        def err(res):
            return np.mean([np.linalg.norm(np.asarray(res.kf_t[i]) - true_t[i])
                            for i in range(1, C)])

        res_sh = local_inertial_ba(m, window_ids, fixed, pres,
                                   jnp.ones(C - 1, bool), jnp.zeros(3),
                                   jnp.zeros(3), CAM, bf=0.0, n_iters=8)
        res_pk = local_inertial_ba(m, window_ids, fixed, pres,
                                   jnp.ones(C - 1, bool), jnp.zeros(3),
                                   jnp.zeros(3), CAM, bf=0.0, n_iters=8,
                                   per_kf_bias=True)
        e_sh, e_pk = err(res_sh), err(res_pk)
        # record the measured approximation gap (quoted in the README)
        print(f"[viba-bias-gap] shared={e_sh:.5f} per_kf={e_pk:.5f} "
              f"ratio={e_pk / max(e_sh, 1e-9):.3f}")
        # per-KF structure must not be worse (tolerate 5% solver noise)
        assert e_pk <= e_sh * 1.05, (e_sh, e_pk)
        # per-KF bias shape + the ramp direction is picked up
        assert res_pk.bg.shape == (C, 3)
        bg_new, ba_new = res_pk.last_bias
        assert bg_new.shape == (3,)

"""Async global-BA hand-off: a finished GBA is merged on the tracking thread,
and the last frame pose moves with its reference keyframe (UpdateLastFrame,
Tracking.cc) so the next motion-model prediction lands on the corrected map.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3lib_tpu.config import SlamConfig
from orbslam3lib_tpu.models import map_state as ms
from orbslam3lib_tpu.tracking.tracker import Tracker
from orbslam3lib_tpu.utils import lie

F = 16


def _tracker_on_small_map(n_kf=3):
    cfg = SlamConfig()
    cfg.map.max_kf = 8
    cfg.map.max_mp = 64
    cfg.orb.max_kp = F
    tr = Tracker(cfg, sensor="stereo", enable_loop_closing=False)
    m = ms.empty_map(max_kf=8, max_mp=64, n_feat=F)
    for k in range(n_kf):
        R, t = lie.se3_exp(jnp.asarray([0.0, 0.0, 0.2 * k, 0.0, 0.05 * k, 0.0],
                                       jnp.float32))
        m, _ = ms.insert_keyframe(
            m, R, t, jnp.float32(k), jnp.zeros((F, 2), jnp.float32),
            jnp.zeros(F, jnp.int32), jnp.zeros((F, 256), jnp.int8),
            jnp.zeros(F, bool), jnp.full(F, -1, jnp.int32),
            jnp.zeros(F, jnp.float32))
    tr.map = m
    tr.last_kf_id = n_kf - 1
    return tr


def _shifted_gba_result(m, world):
    """A GBA result that moves the whole map by the rigid world transform
    `world` = (dR, dt): Tcw_new = Tcw_old o world^-1."""
    dR, dt = world
    gba_R = jnp.einsum("kij,jl->kil", m.kf_R, dR.T)
    gba_t = m.kf_t - jnp.einsum("kij,j->ki", gba_R, dt)
    gba_pos = m.mp_pos @ dR.T + dt
    return (gba_R, gba_t, gba_pos, jnp.int32(int(m.n_kf)), m.mp_valid,
            m.mp_first_kf)


@pytest.mark.parametrize("twist", [
    (0.0, 0.0, 0.0, 0.3, -0.1, 0.05),
    (0.05, -0.2, 0.1, 0.0, 0.02, 0.0),
])
def test_merge_moves_last_frame_with_its_keyframe(twist):
    tr = _tracker_on_small_map()
    kid = tr.last_kf_id
    # the last frame sits a little ahead of its reference keyframe
    Rr, tr_ = lie.se3_exp(jnp.asarray([0.01, 0.0, 0.02, 0.1, 0.0, 0.0],
                                      jnp.float32))
    R_f, t_f = lie.se3_compose(Rr, tr_, tr.map.kf_R[kid], tr.map.kf_t[kid])
    tr.pose = (np.asarray(R_f), np.asarray(t_f))
    tr._chain = ("pose chain of the pre-GBA world",)
    world = lie.se3_exp(jnp.asarray(twist, jnp.float32))
    gba = _shifted_gba_result(tr.map, world)
    tr._gba_result = gba

    tr._merge_gba_result()

    assert tr._gba_result is None and tr._chain is None
    assert tr.stats["n_gba_merged"] == 1
    # keyframes took the GBA pose; the frame kept its pose relative to KF kid
    np.testing.assert_allclose(np.asarray(tr.map.kf_t[:kid + 1]),
                               np.asarray(gba[1][:kid + 1]), atol=1e-5)
    R_rel, t_rel = lie.se3_compose(
        jnp.asarray(tr.pose[0]), jnp.asarray(tr.pose[1]),
        *lie.se3_inverse(tr.map.kf_R[kid], tr.map.kf_t[kid]))
    np.testing.assert_allclose(np.asarray(R_rel), np.asarray(Rr), atol=1e-5)
    np.testing.assert_allclose(np.asarray(t_rel), np.asarray(tr_), atol=1e-5)


def test_abort_discards_finished_unmerged_gba():
    tr = _tracker_on_small_map()
    before = np.asarray(tr.map.kf_t)
    tr._gba_result = _shifted_gba_result(
        tr.map, lie.se3_exp(jnp.asarray([0, 0, 0, 0.5, 0, 0], jnp.float32)))
    tr._abort_gba_and_join()      # a newer loop / merge / reset supersedes it
    tr._merge_gba_result()
    assert tr.stats["n_gba_merged"] == 0
    np.testing.assert_array_equal(before, np.asarray(tr.map.kf_t))

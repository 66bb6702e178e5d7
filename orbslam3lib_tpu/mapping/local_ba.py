"""Bundle adjustment: batched Levenberg-Marquardt with dense Schur complement.

Replacement for the reference's g2o BA family
(/root/reference app/src/main/cpp/src/Optimizer.cc: LocalBundleAdjustment:1124
— covisible-window KFs optimizable, their other observers fixed, mono+stereo
edges with Huber; BundleAdjustment/GlobalBundleAdjustemnt:53,61; the Schur
trick g2o applies via BlockSolver_6_3 and the hand-rolled Marginalize at
Optimizer.cc:2986).

Design (SURVEY.md §7 "Sparse BA structure"):
  * the edge list is a fixed-capacity masked SoA: (cam_idx, pt_idx, uv,
    inv_sigma2, is_stereo, u_right, valid);
  * per-iteration, residuals + Jacobians for all edges are computed in one
    batched elementwise pass, then scattered with segment_sum into
      - camera diagonal blocks   H_cc  (C, 6, 6)
      - landmark diagonal blocks H_pp  (P, 3, 3)
      - coupling blocks          W     (P, C, 6, 3)   [dense over (P, C)]
    and the reduced camera system S = H_cc - sum_p W_p Hpp_p^-1 W_p^T is one
    einsum followed by a tiny dense Cholesky solve; back-substitution
    for landmarks is batched 3x3 solves.
  * The dense (P, C) coupling layout is the key choice: C (cameras in
    the window) is small (<=32, reference window 10-25 KFs,
    Optimizer.cc:2409), so dense beats sparse bookkeeping and makes the
    Schur reduction a pure matmul — and it shards cleanly over P for the
    distributed version (parallel/dist_ba.py: psum the (C6, C6) S blocks).
  * Fixed cameras (the reference's "fixed observers") simply get their
    columns/rows zeroed via a mask — no special casing in the edge pass.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import cameras, lie
from ..utils.robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    cam_R     (C, 3, 3)  world->cam rotations
    cam_t     (C, 3)
    cam_fixed (C,)       bool — pose held constant (gauge / fixed observers)
    cam_valid (C,)       bool
    points    (P, 3)     world landmarks
    pt_valid  (P,)       bool
    e_cam     (E,)       int32 edge -> camera index
    e_pt      (E,)       int32 edge -> point index
    e_uv      (E, 2)
    e_inv_sigma2 (E,)
    e_u_right (E,)
    e_stereo  (E,)       bool
    e_valid   (E,)       bool
    """
    cam_R: jnp.ndarray
    cam_t: jnp.ndarray
    cam_fixed: jnp.ndarray
    cam_valid: jnp.ndarray
    points: jnp.ndarray
    pt_valid: jnp.ndarray
    e_cam: jnp.ndarray
    e_pt: jnp.ndarray
    e_uv: jnp.ndarray
    e_inv_sigma2: jnp.ndarray
    e_u_right: jnp.ndarray
    e_stereo: jnp.ndarray
    e_valid: jnp.ndarray


def _edge_terms(prob: BAProblem, cam_model: int, cam_params, bf):
    """Residuals r (E,3), Jacobians Jc (E,3,6), Jp (E,3,3), chi2, behind."""
    R = prob.cam_R[prob.e_cam]
    t = prob.cam_t[prob.e_cam]
    p_w = prob.points[prob.e_pt]
    p_c = lie.se3_apply(R, t, p_w)
    uv_hat = cameras.project(cam_model, cam_params, p_c)
    z = p_c[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)

    r2 = uv_hat - prob.e_uv
    u_r_hat = uv_hat[..., 0] - bf / z_safe
    r3 = jnp.where(prob.e_stereo, u_r_hat - prob.e_u_right, 0.0)
    r = jnp.concatenate([r2, r3[..., None]], axis=-1)

    Jproj = cameras.project_jac(cam_model, cam_params, p_c)  # (E,2,3)
    dz = jnp.zeros_like(p_c).at[..., 2].set(1.0)
    Jur = Jproj[..., 0, :] + (bf / (z_safe * z_safe))[..., None] * dz
    Jur = jnp.where(prob.e_stereo[..., None], Jur, 0.0)
    Jfull = jnp.concatenate([Jproj, Jur[..., None, :]], axis=-2)  # (E,3,3) d r/d p_c

    I = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), p_c.shape[:-1] + (3, 3))
    Dp_xi = jnp.concatenate([I, -lie.hat(p_c)], axis=-1)  # (E,3,6)
    Jc = Jfull @ Dp_xi                                    # (E,3,6)
    Jp = Jfull @ R                                        # d p_c/d p_w = R

    behind = z <= 0.05
    chi2 = jnp.sum(r * r, axis=-1) * prob.e_inv_sigma2
    return r, Jc, Jp, chi2, behind


def _build_normal_eq(prob: BAProblem, r, Jc, Jp, w):
    """Scatter edge terms into (H_cc, H_pp, W, b_c, b_p)."""
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    Hcc_e = jnp.einsum("eri,erj->eij", wJc, Jc)  # (E,6,6)
    Hpp_e = jnp.einsum("eri,erj->eij", wJp, Jp)  # (E,3,3)
    W_e = jnp.einsum("eri,erj->eij", wJc, Jp)    # (E,6,3)
    bc_e = jnp.einsum("eri,er->ei", wJc, r)      # (E,6)
    bp_e = jnp.einsum("eri,er->ei", wJp, r)      # (E,3)

    Hcc = jax.ops.segment_sum(Hcc_e, prob.e_cam, num_segments=C)
    Hpp = jax.ops.segment_sum(Hpp_e, prob.e_pt, num_segments=P)
    b_c = jax.ops.segment_sum(bc_e, prob.e_cam, num_segments=C)
    b_p = jax.ops.segment_sum(bp_e, prob.e_pt, num_segments=P)
    # dense (P, C, 6, 3) coupling via combined segment id
    pc_id = prob.e_pt * C + prob.e_cam
    W = jax.ops.segment_sum(W_e, pc_id, num_segments=P * C).reshape(P, C, 6, 3)
    return Hcc, Hpp, W, b_c, b_p


def _schur_solve(Hcc, Hpp, W, b_c, b_p, free_cam, free_pt, lm_lambda):
    """Solve the damped normal equations by Schur complement.

    free_cam (C,), free_pt (P,) float masks (1 = optimize). Fixed/invalid
    entities get identity blocks and zero couplings so the dense solve stays
    well-posed and their deltas are exactly zero.
    """
    C = Hcc.shape[0]
    P = Hpp.shape[0]
    I6 = jnp.eye(6, dtype=Hcc.dtype)
    I3 = jnp.eye(3, dtype=Hcc.dtype)

    fc = free_cam[:, None, None]
    fp = free_pt[:, None, None]
    Hcc = fc * Hcc + (1 - fc) * I6
    Hpp = fp * Hpp + (1 - fp) * I3
    W = W * free_cam[None, :, None, None] * free_pt[:, None, None, None]
    b_c = b_c * free_cam[:, None]
    b_p = b_p * free_pt[:, None]

    # LM damping: H + lambda * diag(H) (elementwise-with-identity keeps only
    # the diagonal), plus a small absolute floor
    Hcc = Hcc + lm_lambda * Hcc * I6 + 1e-8 * I6
    Hpp = Hpp + lm_lambda * Hpp * I3 + 1e-8 * I3

    # closed-form batched 3x3 inverses (utils/smallmat.py): jnp.linalg.inv
    # on (4096,3,3) costs 4.4 ms on-device vs 1.3 ms arithmetic — this is
    # inside every LM iteration of every local BA
    from ..utils.smallmat import inv3
    Hpp_inv = inv3(Hpp)

    # S = Hcc_diag - sum_p W_p Hpp_inv W_p^T   ->  (C,6,C,6)
    WHinv = jnp.einsum("pcia,pab->pcib", W, Hpp_inv)          # (P,C,6,3)
    S_off = jnp.einsum("pcia,pdja->cidj", WHinv, W)           # (C,6,C,6)
    S = -S_off
    iiC = jnp.arange(C)
    S = S.at[iiC, :, iiC, :].add(Hcc)
    S = S.reshape(C * 6, C * 6)

    b_schur = b_c - jnp.einsum("pcia,pa->ci", WHinv, b_p)     # (C,6)
    dx_c = -jnp.linalg.solve(S, b_schur.reshape(-1)).reshape(C, 6)

    # back-substitute: dx_p = -Hpp_inv (b_p + W^T dx_c)
    Wt_dxc = jnp.einsum("pcia,ci->pa", W, dx_c)
    dx_p = -jnp.einsum("pab,pb->pa", Hpp_inv, b_p + Wt_dxc)

    dx_c = dx_c * free_cam[:, None]
    dx_p = dx_p * free_pt[:, None]
    return dx_c, dx_p


# iterations before the first chi2 outlier pruning (Optimizer.cc:1350+)
CHI2_GATE_AFTER = 5


@partial(jax.jit, static_argnames=("cam_model", "bf"))
def gate_outliers(prob: BAProblem, cam_params, cam_model: int, bf: float):
    """Drop the edges that fail the chi2 gate at the problem's current
    estimate. A schedule run as several bundle_adjust calls (the chunked
    global BA) prunes with this once CHI2_GATE_AFTER iterations are done:
    each call starts with every edge an inlier again, so without it a
    1-iteration chunking never prunes an outlier."""
    chi2_th = jnp.where(prob.e_stereo, CHI2_STEREO, CHI2_MONO)
    _, _, _, chi2, behind = _edge_terms(prob, cam_model, cam_params, bf)
    return prob._replace(e_valid=prob.e_valid & (chi2 <= chi2_th) & ~behind)


@partial(jax.jit, static_argnames=("cam_model", "bf", "n_iters",
                                   "lm_lambda", "chi2_gate_after"))
def bundle_adjust(prob: BAProblem, cam_params,
                  cam_model: int = cameras.PINHOLE, bf: float = 0.0,
                  n_iters: int = 10, lm_lambda: float = 1e-4,
                  chi2_gate_after: int = CHI2_GATE_AFTER):
    """Run LM BA. Returns (cam_R, cam_t, points, edge_inlier_mask).

    Mirrors LocalBundleAdjustment's two-phase schedule (Optimizer.cc:1350+:
    5 iterations, outlier pruning by chi2, then 10 more): edges failing the
    chi2 gate after `chi2_gate_after` iterations are excluded from later
    iterations.
    """
    chi2_th = jnp.where(prob.e_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.where(prob.e_stereo, DELTA_STEREO, DELTA_MONO)
    free_cam = (prob.cam_valid & (~prob.cam_fixed)).astype(prob.cam_R.dtype)
    free_pt = prob.pt_valid.astype(prob.cam_R.dtype)
    e_base_valid = (prob.e_valid & prob.cam_valid[prob.e_cam]
                    & prob.pt_valid[prob.e_pt])

    def iteration(carry, it):
        cam_R, cam_t, points, inlier = carry
        p = prob._replace(cam_R=cam_R, cam_t=cam_t, points=points)
        r, Jc, Jp, chi2, behind = _edge_terms(p, cam_model, cam_params, bf)
        w_h = huber_weight(chi2, delta)
        w = prob.e_inv_sigma2 * w_h * inlier * e_base_valid * (~behind)
        Hcc, Hpp, W, b_c, b_p = _build_normal_eq(p, r, Jc, Jp, w)
        dx_c, dx_p = _schur_solve(Hcc, Hpp, W, b_c, b_p, free_cam, free_pt,
                                  lm_lambda)
        dR, dt = lie.se3_exp(dx_c)
        cam_R2, cam_t2 = lie.se3_compose(dR, dt, cam_R, cam_t)
        cam_R2 = lie.normalize_rotation(cam_R2)
        points2 = points + dx_p
        # chi2 gate (recomputed on the updated state)
        p2 = prob._replace(cam_R=cam_R2, cam_t=cam_t2, points=points2)
        _, _, _, chi2n, behindn = _edge_terms(p2, cam_model, cam_params, bf)
        gated = ((chi2n <= chi2_th) & (~behindn)).astype(cam_R.dtype)
        inlier = jnp.where(it >= chi2_gate_after, gated, inlier)
        return (cam_R2, cam_t2, points2, inlier), None

    inlier0 = jnp.ones(prob.e_valid.shape, dtype=prob.cam_R.dtype)
    (cam_R, cam_t, points, inlier), _ = jax.lax.scan(
        iteration, (prob.cam_R, prob.cam_t, prob.points, inlier0),
        jnp.arange(n_iters))
    return cam_R, cam_t, points, (inlier > 0) & e_base_valid

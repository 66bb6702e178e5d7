"""Pose-graph (essential-graph) optimization over Sim(3)/SE(3)/4-DoF.

Replacement for the reference's essential-graph solves
(/root/reference app/src/main/cpp/src/Optimizer.cc: OptimizeEssentialGraph
6/7-DoF :1511/:1799 over VertexSim3Expmap with relative Sim3 edges from the
spanning tree, covisibility (weight>=100) and loop/merge edges;
OptimizeEssentialGraph4DoF :5338 for inertial maps — yaw+translation only).

Structure: per-edge residual r_e = log_sim3(S_meas_ij * S_j * S_i^-1) with
per-edge Jacobian blocks from vmapped jacfwd over only the two incident pose
deltas (7+7 parameters) — cheap and exact — scattered into a dense
(K*7, K*7) normal matrix solved by Cholesky. K<=few hundred keyframes makes
the dense solve a non-issue on the accelerator (the sparsity bookkeeping
g2o needs on CPU buys nothing here).

Modes: "sim3" (7-DoF, loop closing with scale drift), "se3" (6-DoF, scale
fixed), "4dof" (yaw + translation, inertial). Gauge/masking is handled by
zeroing fixed/invalid blocks with identity fill.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import lie

_DOF_MASKS = {
    # parameter mask over [rho(3), phi(3), sigma]
    "sim3": jnp.ones(7, jnp.float32),
    "se3": jnp.asarray([1, 1, 1, 1, 1, 1, 0], jnp.float32),
    # 4dof: translation + rotation about gravity (+y here): phi_x=phi_z=0
    "4dof": jnp.asarray([1, 1, 1, 0, 1, 0, 0], jnp.float32),
}


def _compose_delta(dx, R, t, s):
    dR, dt, ds = lie.sim3_exp(dx)
    R2, t2, s2 = lie.sim3_compose(dR, dt, ds, R, t, s)
    return lie.normalize_rotation(R2), t2, s2


@partial(jax.jit, static_argnames=("mode", "n_iters"))
def optimize_pose_graph(kf_R, kf_t, kf_s, kf_valid, kf_fixed,
                        e_i, e_j, e_R, e_t, e_s, e_valid,
                        mode: str = "sim3", n_iters: int = 20,
                        lm_lambda: float = 1e-4):
    """Optimize world->cam Sim3 poses S_k = (R, t, s) against relative
    constraints S_ij (measuring S_i * S_j^-1).

    Returns (kf_R, kf_t, kf_s) optimized.
    """
    K = kf_R.shape[0]
    dof = _DOF_MASKS[mode]
    free = (kf_valid & (~kf_fixed)).astype(jnp.float32)  # (K,)

    def edge_residual(dxi, dxj, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        Ri2, ti2, si2 = _compose_delta(dxi * dof, Ri, ti, si)
        Rj2, tj2, sj2 = _compose_delta(dxj * dof, Rj, tj, sj)
        # S_err = S_meas_ij * S_j * S_i^-1  (should be identity)
        Rji, tji, sji = lie.sim3_inverse(Ri2, ti2, si2)
        Rw, tw, sw = lie.sim3_compose(Rj2, tj2, sj2, Rji, tji, sji)
        Re, te, se = lie.sim3_compose(Rm, tm, sm,
                                      *lie.sim3_inverse(Rw, tw, sw))
        return lie.sim3_log(Re, te, se)

    def iteration(carry, _):
        kfR, kft, kfs = carry
        Ri, ti, si = kfR[e_i], kft[e_i], kfs[e_i]
        Rj, tj, sj = kfR[e_j], kft[e_j], kfs[e_j]

        def per_edge(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, ev):
            z = jnp.zeros(7, jnp.float32)
            r = edge_residual(z, z, Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
            Ji = jax.jacfwd(lambda d: edge_residual(d, z, Ri, ti, si,
                                                    Rj, tj, sj, Rm, tm, sm))(z)
            Jj = jax.jacfwd(lambda d: edge_residual(z, d, Ri, ti, si,
                                                    Rj, tj, sj, Rm, tm, sm))(z)
            return r * ev, Ji * ev, Jj * ev

        r, Ji, Jj = jax.vmap(per_edge)(Ri, ti, si, Rj, tj, sj,
                                       e_R, e_t, e_s,
                                       e_valid.astype(jnp.float32))
        # assemble dense H (K,7,K,7) and b (K,7)
        Hii = jnp.einsum("eri,erj->eij", Ji, Ji)
        Hjj = jnp.einsum("eri,erj->eij", Jj, Jj)
        Hij = jnp.einsum("eri,erj->eij", Ji, Jj)
        bi = jnp.einsum("eri,er->ei", Ji, r)
        bj = jnp.einsum("eri,er->ei", Jj, r)

        H = jnp.zeros((K * K, 7, 7), jnp.float32)
        H = H.at[e_i * K + e_i].add(Hii)
        H = H.at[e_j * K + e_j].add(Hjj)
        H = H.at[e_i * K + e_j].add(Hij)
        H = H.at[e_j * K + e_i].add(jnp.swapaxes(Hij, -1, -2))
        H = H.reshape(K, K, 7, 7).transpose(0, 2, 1, 3)
        b = jnp.zeros((K, 7), jnp.float32)
        b = b.at[e_i].add(bi)
        b = b.at[e_j].add(bj)

        # gauge: zero rows/cols of fixed or invalid KFs + fixed dof, fill diag
        mask = free[:, None] * dof[None, :]                  # (K,7)
        H = H * mask[:, :, None, None] * mask[None, None, :, :]
        b = b * mask
        Hf = H.reshape(K * 7, K * 7)
        dmask = mask.reshape(-1)
        Hf = Hf + jnp.diag(1.0 - dmask) + lm_lambda * jnp.diag(jnp.diag(Hf)) \
            + 1e-8 * jnp.eye(K * 7)
        dx = -jnp.linalg.solve(Hf, b.reshape(-1)).reshape(K, 7)
        dx = dx * mask

        R2, t2, s2 = jax.vmap(_compose_delta)(dx, kfR, kft, kfs)
        return (R2, t2, s2), None

    (Rf, tf, sf), _ = jax.lax.scan(iteration, (kf_R, kf_t, kf_s), None,
                                   length=n_iters)
    return Rf, tf, sf


def relative_sim3(Ri, ti, si, Rj, tj, sj):
    """Measurement S_ij = S_i * S_j^-1 from two absolute poses (the edge
    constraint the reference builds from pre-correction poses)."""
    return lie.sim3_compose(Ri, ti, si, *lie.sim3_inverse(Rj, tj, sj))

"""Robust kernels for the optimizers (reference: g2o RobustKernelHuber used in
every Optimizer.cc BA entry point, e.g. Optimizer.cc:962-967 chi2/Huber gates).

All return (rho_weight, valid) pairs usable in IRLS: the weight multiplies the
residual block's contribution to H and b.
"""
from __future__ import annotations

import math

import jax.numpy as jnp

# chi2 gates from the reference (Optimizer.cc:984-998 and SURVEY.md §8).
# NOTE: Python floats, NOT jnp scalars — captured f32[] array constants in
# large elementwise ops hit the compile problem documented in ops/masks.py.
CHI2_MONO = 5.991    # 2-dof 95%
CHI2_STEREO = 7.815  # 3-dof 95%
DELTA_MONO = math.sqrt(CHI2_MONO)
DELTA_STEREO = math.sqrt(CHI2_STEREO)


def huber_weight(chi2: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weight for the Huber kernel evaluated at squared error chi2.

    w = 1 for |e| <= delta, delta/|e| beyond. (d rho / d chi2 form.)"""
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(e <= delta, jnp.ones_like(e), delta / e)


def huber_cost(chi2: jnp.ndarray, delta: float) -> jnp.ndarray:
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(e <= delta, chi2, 2.0 * delta * e - delta * delta)

"""Arithmetic (pred-free) gating masks for the hot paths.

Gates over matmul-derived 2-D matrices are expressed with min/max/clip
arithmetic instead of 2-D boolean tensors fed through select/convert into a
reduction. The style was adopted for a compiler that handled the boolean
form badly; whether the plain compare is as fast on the GPU is not measured
yet (ROADMAP queue 3), and where it is, the exact compares can return.

Rules used across the hot paths:
  * gates are float32 in [0, 1], combined by multiplication (AND);
  * exact {0,1} semantics for integer-valued operands via the +1 offset;
  * continuous operands get a ~1-unit soft edge (irrelevant at SLAM gating
    tolerances) or a sharpness factor;
  * scalars entering 2-D ops MUST be inline Python-float literals / static
    args — a captured f32[] scalar *array* operand (e.g. jnp.float32(...)
    or a traced scalar) in a f32[N,N] op hit the same compile problem.
    Hence BIG is a Python float and the matcher / search functions take
    their thresholds as static floats.
"""
from __future__ import annotations

import jax.numpy as jnp

BIG = 4096.0  # penalty for masked-out entries (>> max Hamming distance 256)


def step01(x):
    """clip(x, 0, 1) — the building block: 1 where x >= 1, 0 where x <= 0."""
    return jnp.clip(x, 0.0, 1.0)


def leq_int(x, th):
    """Exact gate x <= th for integer-valued float x."""
    return step01(th - x + 1.0)


def geq_int(x, th):
    return step01(x - th + 1.0)


def leq_soft(x, th, sharp: float = 1.0):
    """Soft gate x <= th with ~1/sharp transition width."""
    return step01((th - x) * sharp + 1.0)


def geq_soft(x, th, sharp: float = 1.0):
    return step01((x - th) * sharp + 1.0)


def in_range_soft(x, lo, hi, sharp: float = 1.0):
    return geq_soft(x, lo, sharp) * leq_soft(x, hi, sharp)


def penalize(d, gate):
    """Masked distances: keep d where gate ~ 1, push to >= BIG where ~ 0."""
    return d + (1.0 - gate) * BIG


def is_finite_match(best_d):
    """Gate 'best distance came from a real candidate' (< BIG/2 margin —
    penalties can stack, so anything touched by one is way above this)."""
    return step01((2048.0 - best_d) * (1.0 / 1024.0))

"""Front-end kernels against their NumPy oracles (SURVEY.md §4: every
kernel keeps a plain reference in-tree for A/B comparison)."""
import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3lib_tpu.ops import fast
from orbslam3lib_tpu.ops.matcher import knn2_oracle, knn_match


@pytest.mark.parametrize("margin", [21, 3])
@pytest.mark.parametrize("h,w", [(100, 161), (64, 128), (80, 128)])
def test_fast_nms_matches_numpy_oracle(h, w, margin):
    rng = np.random.default_rng(h * 7 + w + margin)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    got = np.asarray(fast.nms3x3(fast.fast_scores(jnp.asarray(img), margin)))
    np.testing.assert_array_equal(got, fast.fast_nms_oracle(img, margin))
    assert (got > 0).sum() > 50


def test_fast_nms_oracle_matches_scalar_oracle():
    """The vectorized oracle against the scalar per-pixel FAST oracle plus a
    scalar 3x3 NMS loop."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (24, 40)).astype(np.float32)
    s = fast.fast_scores_oracle(img, 3)
    p = np.pad(s, 1, constant_values=-np.inf)
    want = np.array([[s[y, x] if s[y, x] >= p[y:y + 3, x:x + 3].max() else 0.0
                      for x in range(40)] for y in range(24)], np.float32)
    np.testing.assert_array_equal(fast.fast_nms_oracle(img, 3), want)


@pytest.mark.parametrize("na,nb,masked", [
    (64, 64, True), (300, 450, True), (512, 1024, True), (512, 1024, False)])
def test_knn_match_matches_numpy_oracle(na, nb, masked):
    rng = np.random.default_rng(na * 1000 + nb)
    a = (rng.random((na, 256)) < 0.5).astype(np.int8)
    b = (rng.random((nb, 256)) < 0.5).astype(np.int8)
    # planted exact ties: the lowest index must win d1, and d2 == d1
    b[nb // 2:nb // 2 + 8] = b[:8]
    a[:8] = b[:8]
    av = bv = None
    if masked:
        av, bv = rng.random(na) < 0.9, rng.random(nb) < 0.9
        av[:8] = bv[:8] = bv[nb // 2:nb // 2 + 8] = True
    got = knn_match(jnp.asarray(a), jnp.asarray(b),
                    None if av is None else jnp.asarray(av),
                    None if bv is None else jnp.asarray(bv))
    want = knn2_oracle(a, b, av, bv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
    np.testing.assert_array_equal(np.asarray(got[0])[:8], np.arange(8))
    np.testing.assert_array_equal(np.asarray(got[1])[:8], 0.0)

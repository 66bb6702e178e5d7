"""Data-parallel front end: a batch of stereo frames sharded over the mesh.

The reference's throughput story is one frame at a time through one DSP
(SURVEY.md §3.2); its multi-session capability (Atlas) processes sequences
strictly serially. On several devices the natural extension is frame-level
data parallelism for offline/multi-session mapping: shard a batch of frames
over the mesh's data axis, run the full extraction + rectified stereo matching
graph per frame on its owning device, and return device-sharded Features
that downstream per-sequence trackers consume locally. Zero collectives —
the batch axis is embarrassingly parallel; XLA just partitions the whole
jitted graph under the in/out shardings.

Use cases: multi-session map building (each device ingests one session's
frames), dataset preprocessing across devices, and the multi-device dry run
(`__graft_entry__.dryrun_multichip`).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.extractor import Features, extract_orb_stereo
from ..tracking.matching import match_rectified_stereo


def _frontend_one(img_pair, threshold, bf, min_z, max_kp, n_levels):
    feats = extract_orb_stereo(img_pair, threshold, max_kp=max_kp,
                               n_levels=n_levels)
    u_r, depth = match_rectified_stereo(
        feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
        feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
        bf, min_z, n_levels=n_levels)
    return feats, u_r, depth


def make_sharded_frontend(mesh: Mesh, axis: str = "dp", bf: float = 33.0,
                          min_z: float = 0.3, max_kp: int = 512,
                          n_levels: int = 8):
    """Compile a frame-batched front end sharded over `axis` of `mesh`.

    Returns fn(imgs (N,2,H,W) f32, threshold (N,) f32) ->
    (Features with leading dim N, u_r (N,F), depth (N,F)), all sharded over
    the frame axis. N must be a multiple of the axis size.
    """
    dp = NamedSharding(mesh, P(axis))

    @partial(jax.jit,
             in_shardings=(dp, dp),
             out_shardings=(Features(dp, dp, dp, dp, dp, dp), dp, dp))
    def frontend(imgs, thresholds):
        return jax.vmap(
            lambda im, th: _frontend_one(im, th, bf, min_z, max_kp, n_levels)
        )(imgs, thresholds)

    return frontend

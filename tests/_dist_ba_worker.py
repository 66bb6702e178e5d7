"""Worker for the 2-process distributed-BA test (run by
test_multiprocess_dist.py, one instance per process).

Each process owns 4 virtual CPU devices; jax.distributed stitches them into
one 8-device global mesh whose psum crosses the process boundary over Gloo —
the same SPMD program shape as a multi-host cluster
(SURVEY.md §4 "multi-process CPU meshes").
"""
import os
import sys

port, pid = sys.argv[1], int(sys.argv[2])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orbslam3lib_tpu.mapping.local_ba import BAProblem  # noqa: E402
from orbslam3lib_tpu.parallel.dist_ba import (dist_bundle_adjust,  # noqa: E402
                                              partition_problem)
from orbslam3lib_tpu.utils import lie  # noqa: E402
from orbslam3lib_tpu.utils.cameras import pinhole_project  # noqa: E402

N_CAMS, N_PTS, OBS = 8, 256, 96
rng = np.random.default_rng(7)  # SAME seed in both processes: identical data
cam_params_np = np.asarray([300.0, 300.0, 320.0, 200.0], np.float32)
pts = rng.uniform([-4, -2, 4], [4, 2, 20], size=(N_PTS, 3)).astype(np.float32)
cam_R = np.tile(np.eye(3, dtype=np.float32), (N_CAMS, 1, 1))
cam_t_true = np.stack([[0.2 * i, 0.0, 0.0] for i in range(N_CAMS)]).astype(np.float32)
e_cam = np.repeat(np.arange(N_CAMS), OBS).astype(np.int32)
e_pt = rng.integers(0, N_PTS, size=N_CAMS * OBS).astype(np.int32)
p_c = pts[e_pt] + cam_t_true[e_cam]
uv = np.stack([300.0 * p_c[:, 0] / p_c[:, 2] + 320.0,
               300.0 * p_c[:, 1] / p_c[:, 2] + 200.0], -1).astype(np.float32)
# perturb the free cameras; BA must pull them back
cam_t0 = cam_t_true.copy()
cam_t0[2:] += rng.normal(0, 0.05, cam_t0[2:].shape).astype(np.float32)

prob = BAProblem(
    cam_R=jnp.asarray(cam_R), cam_t=jnp.asarray(cam_t0),
    cam_fixed=jnp.asarray([True, True] + [False] * (N_CAMS - 2)),
    cam_valid=jnp.ones(N_CAMS, bool),
    points=jnp.asarray(pts), pt_valid=jnp.ones(N_PTS, bool),
    e_cam=jnp.asarray(e_cam), e_pt=jnp.asarray(e_pt),
    e_uv=jnp.asarray(uv),
    e_inv_sigma2=jnp.ones(len(e_cam), jnp.float32),
    e_u_right=jnp.zeros(len(e_cam), jnp.float32),
    e_stereo=jnp.zeros(len(e_cam), bool),
    e_valid=jnp.ones(len(e_cam), bool),
)
prob = partition_problem(prob, 8)

devs = jax.devices()
assert len(devs) == 8, devs
mesh = Mesh(np.array(devs).reshape(8), ("mp",))
pt_sh = NamedSharding(mesh, P("mp"))
rep_sh = NamedSharding(mesh, P())


def put(x, sh):
    return jax.device_put(np.asarray(x), sh)


probg = BAProblem(
    cam_R=put(prob.cam_R, rep_sh), cam_t=put(prob.cam_t, rep_sh),
    cam_fixed=put(prob.cam_fixed, rep_sh), cam_valid=put(prob.cam_valid, rep_sh),
    points=put(prob.points, pt_sh), pt_valid=put(prob.pt_valid, pt_sh),
    e_cam=put(prob.e_cam, pt_sh), e_pt=put(prob.e_pt, pt_sh),
    e_uv=put(prob.e_uv, pt_sh), e_inv_sigma2=put(prob.e_inv_sigma2, pt_sh),
    e_u_right=put(prob.e_u_right, pt_sh), e_stereo=put(prob.e_stereo, pt_sh),
    e_valid=put(prob.e_valid, pt_sh),
)
cam_params = put(cam_params_np, rep_sh)

t_err0 = float(np.linalg.norm(np.asarray(prob.cam_t)[2:] - cam_t_true[2:],
                              axis=-1).mean())
out_R, out_t, out_pts, _ = dist_bundle_adjust(
    probg, cam_params, mesh, cam_model=0, bf=0.0, n_iters=8)
jax.block_until_ready(out_t)
t_err = float(np.linalg.norm(np.asarray(out_t)[2:] - cam_t_true[2:],
                             axis=-1).mean())
print(f"[p{pid}] cam-t error {t_err0:.4f} -> {t_err:.4f}", flush=True)
assert t_err < 0.3 * t_err0, (t_err0, t_err)
print(f"[p{pid}] CONVERGED", flush=True)

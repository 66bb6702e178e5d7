"""Smoke run of the SLAM main path on one GPU, through the user entry points.

    python chip_smoke.py              # one GPU: phases (a)-(d) below
    python chip_smoke.py --four-gpus  # four GPUs: only the multi-card path

Phases (one GPU):
  (a) device and setup: JAX version and devices, the compile-cache
      directory, the card's name and power limit (nvidia-smi), the BoW
      backend;
  (b) parity of every front-end computation at real widths against the
      plain references, with the tolerance and its reason beside each;
  (c) the main path: the headline stereo deployment as `bench.py full_slam`
      drives it (pipelined tracker, async mapping, live loop closing and
      async GBA through the revisit), ~30 frames through the public `System`
      facade, and the monocular oracle run (two-view init, Sim3);
  (d) every cold graph a loop closure or tracking failure can demand,
      compiled and run once, plus the compiled memory of the per-frame chunk
      step and the fused mapper step, and the peak device memory.

With --four-gpus only the path that exists across cards runs: the
landmark-sharded distributed BA over a 4-card mesh against `bundle_adjust`
on one card, and the frame-sharded front end against per-frame extraction.

Every check raises on failure; nothing is caught. The last line of stdout is
the JSON result, printed only when every phase passed. Without a GPU the
script exits non-zero before any phase.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# --- tolerances, each with its reason -------------------------------------
# FAST score + NMS is f32 subtract/min/max only: bit-exact on any device.
# kNN-2: 0/1 operands in bf16, f32 accumulation of <= 256 terms: exact.
# Pyramid: separable bilinear resize as f32 matmuls at HIGHEST precision;
#   chained over 8 levels the error stays far below a grey level.
PYRAMID_TOL_GREY = 1e-3
# Full extraction GPU vs CPU: the pyramid's summation order differs, so a
#   FAST score sitting exactly at a tie or the threshold can move one
#   keypoint; BRIEF compares are a bf16 matmul whose near-zero values may
#   flip a bit under another summation order.
EXTRACT_MIN_KP_AGREE = 0.98
EXTRACT_KP_RADIUS_PX = 0.5
EXTRACT_MAX_BIT_FLIPS = 0.01
# Geometry (pose LM, Schur BA) in f32 at HIGHEST: other summation orders
#   and float atomics in the scatter-adds move the last bits only.
GEOMETRY_REL_TOL = 1e-4
# Main-path gates (the verify recipes' bars).
ATE_TRAJ_MAX_M = 0.10
MONO_ATE_MAX = 0.10


def _log(msg):
    print(msg, flush=True)


def _require_gpus(n):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {devs}")
    if len(devs) < n:
        sys.exit(f"chip_smoke: needs {n} GPUs; JAX found {devs}")
    return devs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _on(dev, fn, *args):
    """Run `fn` with its array arguments committed to `dev`."""
    import jax
    return jax.tree_util.tree_map(
        np.asarray, fn(*jax.device_put(args, dev)))


# --- phase (b): parity checks (also run by tests/test_gpu_parity.py) ------

def bench_frame():
    """Frame 0 of the bench orbit, (2, 400, 640) uint8."""
    import bench
    return bench._render_frames(1, False)[0][0]


def pyramid_f64(img, n_levels=8):
    """Float64 NumPy reference of the chained bilinear pyramid."""
    from orbslam3lib_tpu.ops import pyramid
    shapes = pyramid.level_shapes(img.shape[-2], img.shape[-1], n_levels)
    cur = np.asarray(img, np.float64)
    levels = [cur]
    for h, w in shapes[1:]:
        cur = (pyramid._resize_matrix(cur.shape[0], h).astype(np.float64)
               @ cur
               @ pyramid._resize_matrix(cur.shape[1], w).astype(np.float64).T)
        levels.append(cur)
    return levels


def check_fast(gpu, cpu, frame):
    """FAST score + NMS at the 8 level shapes of 640x400: GPU against the
    XLA path on the CPU (all levels) and the NumPy oracle (level 0)."""
    import jax
    from orbslam3lib_tpu.ops import fast
    from orbslam3lib_tpu.ops.extractor import DETECT_MARGIN
    f = jax.jit(lambda x: fast.nms3x3(fast.fast_scores(x, DETECT_MARGIN)))
    out = {}
    for lvl, img in enumerate(pyramid_f64(frame[0])):
        img = img.astype(np.float32)
        g, c = _on(gpu, f, img), _on(cpu, f, img)
        name = f"L{lvl}_{img.shape[0]}x{img.shape[1]}"
        assert np.array_equal(g, c), f"FAST+NMS {name}: GPU != CPU"
        if lvl == 0:
            o = fast.fast_nms_oracle(img, DETECT_MARGIN)
            assert np.array_equal(g, o), f"FAST+NMS {name}: GPU != oracle"
        out[f"{name}_maxima"] = int((g > 0).sum())
    return out


def check_knn(gpu):
    """kNN-2 at 512x512 and 1024x1024 with validity masks and planted
    duplicate rows (lowest index wins ties), against the NumPy oracle."""
    import jax
    from orbslam3lib_tpu.ops.matcher import knn2_oracle, knn_match
    f = jax.jit(knn_match)
    out = {}
    for n in (512, 1024):
        rng = np.random.default_rng(n)
        a = (rng.random((n, 256)) < 0.5).astype(np.int8)
        b = (rng.random((n, 256)) < 0.5).astype(np.int8)
        b[n // 2:n // 2 + 16] = b[:16]            # exact ties in d1 and d2
        a[:16] = b[:16]
        av, bv = rng.random(n) < 0.9, rng.random(n) < 0.9
        av[:16] = bv[:16] = bv[n // 2:n // 2 + 16] = True
        got = _on(gpu, f, a, b, av, bv)
        want = knn2_oracle(a, b, av, bv)
        for name, g, w in zip(("idx", "d1", "d2"), got, want):
            assert np.array_equal(g, w), f"kNN-2 {n}x{n}: {name} differs"
        out[f"{n}x{n}"] = "bit-exact"
    return out


def check_pyramid(gpu, frame):
    """Max abs error per level of the on-device pyramid against float64."""
    import jax
    from orbslam3lib_tpu.ops import pyramid
    got = _on(gpu, jax.jit(lambda x: pyramid.build_pyramid(x, 8)), frame[0])
    errs = [float(np.max(np.abs(g - r)))
            for g, r in zip(got, pyramid_f64(frame[0]))]
    assert max(errs) <= PYRAMID_TOL_GREY, f"pyramid error {errs} grey"
    return {"max_abs_err_grey_per_level": errs}


def extract_agreement(fa, fb):
    """Share of keypoints of `fa` with a keypoint of `fb` at the same level
    within EXTRACT_KP_RADIUS_PX, and the share of BRIEF bits that differ on
    those matched pairs. fa, fb: Features as NumPy, leading eye axis."""
    n_kp = n_agree = n_bits = n_flip = 0
    for e in range(fa.xy.shape[0]):
        va, vb = fa.valid[e], fb.valid[e]
        xa, la, da = fa.xy[e][va], fa.level[e][va], fa.desc[e][va]
        xb, lb, db = fb.xy[e][vb], fb.level[e][vb], fb.desc[e][vb]
        d = np.linalg.norm(xa[:, None] - xb[None], axis=-1)
        d = np.where(la[:, None] == lb[None], d, np.inf)
        j = np.argmin(d, axis=1) if len(xb) else np.zeros(len(xa), int)
        ok = d[np.arange(len(xa)), j] <= EXTRACT_KP_RADIUS_PX if len(xb) \
            else np.zeros(len(xa), bool)
        n_kp += len(xa)
        n_agree += int(ok.sum())
        n_bits += int(ok.sum()) * 256
        n_flip += int((da[ok] != db[j[ok]]).sum())
    return n_agree / max(n_kp, 1), n_flip / max(n_bits, 1), n_kp


def check_extract(gpu, cpu, frame):
    """Full extract_orb_stereo (512 kp, 8 levels) GPU against CPU."""
    from orbslam3lib_tpu.ops.extractor import extract_orb_stereo

    def f(x):
        return extract_orb_stereo(x.astype(np.float32), np.float32(17.0),
                                  max_kp=512, n_levels=8)
    g, c = _on(gpu, f, frame), _on(cpu, f, frame)
    agree, flips, n_kp = extract_agreement(g, c)
    assert n_kp > 100, f"only {n_kp} keypoints extracted"
    assert agree >= EXTRACT_MIN_KP_AGREE, f"keypoint agreement {agree}"
    assert flips <= EXTRACT_MAX_BIT_FLIPS, f"BRIEF bit flips {flips}"
    return {"n_kp": n_kp, "kp_agreement": agree, "brief_bit_flips": flips}


def _test_module(name):
    """A module of tests/ (the synthetic problems the CPU tests use)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_dist_ba_problem(n_cams, n_pts, obs_per_cam, seed=0):
    """Cameras along a line viewing a random cloud, `obs_per_cam` random
    observations each, 0.5 px noise; points perturbed by 5 cm."""
    import jax.numpy as jnp
    from orbslam3lib_tpu.mapping.local_ba import BAProblem
    rng = np.random.default_rng(seed)
    cam = np.asarray([300.0, 300.0, 320.0, 200.0], np.float32)
    pts = rng.uniform([-8, -4, 4], [8, 4, 40], size=(n_pts, 3))
    cam_t = np.stack([[0.15 * i, 0.0, 0.0] for i in range(n_cams)])
    e_cam = np.repeat(np.arange(n_cams), obs_per_cam).astype(np.int32)
    e_pt = rng.integers(0, n_pts, size=n_cams * obs_per_cam).astype(np.int32)
    p_c = pts[e_pt] + cam_t[e_cam]
    uv = cam[:2] * p_c[:, :2] / p_c[:, 2:] + cam[2:]
    uv = uv + rng.normal(0, 0.5, uv.shape)
    E = len(e_cam)
    prob = BAProblem(
        cam_R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (n_cams, 1, 1)),
        cam_t=jnp.asarray(cam_t, jnp.float32),
        cam_fixed=jnp.asarray([True, True] + [False] * (n_cams - 2)),
        cam_valid=jnp.ones(n_cams, bool),
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape), jnp.float32),
        pt_valid=jnp.ones(n_pts, bool),
        e_cam=jnp.asarray(e_cam), e_pt=jnp.asarray(e_pt),
        e_uv=jnp.asarray(uv, jnp.float32),
        e_inv_sigma2=jnp.ones(E, jnp.float32),
        e_u_right=jnp.zeros(E, jnp.float32),
        e_stereo=jnp.zeros(E, bool), e_valid=jnp.ones(E, bool))
    return prob, cam


def check_geometry(gpu, cpu):
    """pose_optimization and bundle_adjust on the synthetic problems of
    tests/test_pose_opt.py and tests/test_local_ba.py, GPU against CPU."""
    import jax
    import jax.numpy as jnp
    from orbslam3lib_tpu.mapping.local_ba import bundle_adjust
    from orbslam3lib_tpu.tracking.pose_opt import pose_optimization
    from orbslam3lib_tpu.utils import lie
    tp = _test_module("test_pose_opt")
    (R, t), obs = tp.make_problem(stereo=True, noise_px=0.3)
    dR, dt = lie.se3_exp(jnp.asarray(np.random.default_rng(11).normal(
        size=6) * 0.05, jnp.float32))
    R0, t0 = lie.se3_compose(dR, dt, R, t)
    args = jax.tree_util.tree_map(np.asarray, (R0, t0, obs, tp.CAM))
    f = jax.jit(lambda R, t, o, c: pose_optimization(R, t, o, c, bf=45.0)[:2])
    g, c = _on(gpu, f, *args), _on(cpu, f, *args)
    out = {"pose_R": _rel(g[0], c[0]), "pose_t": _rel(g[1], c[1])}
    tb = _test_module("test_local_ba")
    prob, _ = tb.make_ba_problem(pose_noise=0.03)
    args = jax.tree_util.tree_map(np.asarray, (prob, tb.CAM))
    f = jax.jit(lambda p, c: bundle_adjust(p, c)[:3])
    g, c = _on(gpu, f, *args), _on(cpu, f, *args)
    out.update(ba_R=_rel(g[0], c[0]), ba_t=_rel(g[1], c[1]),
               ba_points=_rel(g[2], c[2]))
    worst = max(out.values())
    assert worst <= GEOMETRY_REL_TOL, f"geometry GPU vs CPU {out}"
    return out


def phase_b(gpu, cpu):
    frame = bench_frame()
    for name, fn in (("fast_nms", lambda: check_fast(gpu, cpu, frame)),
                     ("knn2", lambda: check_knn(gpu)),
                     ("pyramid", lambda: check_pyramid(gpu, frame)),
                     ("extract", lambda: check_extract(gpu, cpu, frame)),
                     ("geometry", lambda: check_geometry(gpu, cpu))):
        t0 = time.time()
        _log(f"(b) parity {name}: {fn()} [{time.time() - t0:.1f}s]")


# --- phase (c): main path --------------------------------------------------

def bench_config(rig):
    """The bench deployment's configuration (640x400 stereo, 512 kp)."""
    from orbslam3lib_tpu.config import SlamConfig
    cfg = SlamConfig()
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    cfg.orb.max_kp = 512
    cfg.orb.n_levels = 8
    return cfg


def run_stereo_main_path():
    import bench
    from orbslam3lib_tpu.tracking.tracker import OK
    t0 = time.time()
    tracker, imgs, out = bench.run_full_slam()
    gates = {"state_ok": tracker.state == OK,
             "fails_after_populate": out["fails_after_populate"],
             "n_kf": out["n_kf"], "n_loops": out["n_loops"],
             "n_gba": out["n_gba"], "n_gba_merged": out["n_gba_merged"],
             "ate_traj_m": out["ate_traj_m"],
             "ate_kf_m": out["ate_kf_m"],
             "place_recognition": type(tracker.place_rec).__name__}
    _log(f"(c) stereo main path gates: {gates} "
         f"[{time.time() - t0:.1f}s, best window {out['value']} frames/s "
         f"wall clock]")
    assert gates["state_ok"], "stereo tracking not OK at the end"
    assert gates["fails_after_populate"] == 0, gates
    assert gates["n_loops"] >= 1, "no live loop closed"
    # a GBA that a newer keyframe aborts is not merged (mbStopGBA), so the
    # gate is that one was launched after the loop
    assert gates["n_gba"] >= 1, "no global BA launched after the loop"
    assert gates["ate_traj_m"] <= ATE_TRAJ_MAX_M, gates
    return tracker, imgs


def run_system_facade(n_frames=30):
    import bench
    from orbslam3lib_tpu.system import System
    from orbslam3lib_tpu.tracking.tracker import OK
    t0 = time.time()
    imgs, ts, rig = bench._load_frames(n_frames)
    slam = System(bench_config(rig), sensor="stereo", background_mapping=True)
    for i in range(n_frames):
        slam.track_stereo(imgs[i], float(ts[i]))
    state = slam.get_tracking_state()
    info = slam.map_info()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "traj_tum.txt")
        slam.save_trajectory_tum(path)
        with open(path) as f:
            rows = [ln.split() for ln in f if ln.strip()]
    slam.shutdown()
    _log(f"(c) System facade: {n_frames} frames, state {state}, {info}, "
         f"TUM rows {len(rows)} [{time.time() - t0:.1f}s]")
    assert state == OK, f"System tracking state {state}"
    assert len(rows) >= n_frames - 2 and all(len(r) == 8 for r in rows)


def run_mono_oracle():
    """The verify recipe: 40-frame corridor, monocular, ATE(sim3)."""
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.evaluation import ate_rmse
    from orbslam3lib_tpu.io.synthetic import render_stereo_sequence
    from orbslam3lib_tpu.tracking.tracker import OK, Tracker
    t0 = time.time()
    frames, rig, _ = render_stereo_sequence(n_frames=40, dt=1.0 / 15.0,
                                            seed=5)
    cfg = SlamConfig()
    cfg.map.max_kf = 64
    cfg.map.max_mp = 4096
    cfg.orb.max_kp = 384
    cfg.orb.target_features = 300
    cfg.orb.fast_threshold = 12.0
    cfg.tracker.min_init_features = 150
    cfg.ba.max_points = 1024
    cfg.ba.window_size = 6
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    tracker = Tracker(cfg, sensor="mono", enable_loop_closing=False)
    for img_pair, _, ts in frames:
        tracker.process_frame(img_pair[0], ts)
    est = tracker.trajectory_centers()
    gt = np.stack([-R.T @ t for _, (R, t), _ in frames[-len(est):]])
    ate = ate_rmse(est, gt, with_scale=True)
    _log(f"(c) mono oracle: state OK {tracker.state == OK}, "
         f"{len(est)} poses, ATE(sim3) {ate:.4f} m [{time.time() - t0:.1f}s]")
    assert tracker.state == OK and len(est) >= 30, "mono tracking lost"
    assert ate <= MONO_ATE_MAX, f"mono ATE(sim3) {ate}"


# --- phase (d): cold graphs and memory -------------------------------------

def _mem(stats):
    return {k: getattr(stats, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def phase_d(tracker, imgs, gpu):
    import jax.numpy as jnp
    import bench
    from orbslam3lib_tpu.mapping.loop_closing import mapper_step_fused
    from orbslam3lib_tpu.tracking.tracker import _frame_step_chunk
    names = bench.warm_cold_graphs(tracker)
    _log(f"(d) cold graphs compiled and ran: {names}")
    frames = jnp.asarray(np.stack([imgs[-1]] * tracker.chunk))
    a, k = bench.chunk_step_call(tracker, frames)
    stats = _frame_step_chunk.lower(*a, **k).compile().memory_analysis()
    _log(f"(d) chunk step memory: {_mem(stats)}")
    a, k = bench.mapper_step_call(tracker, max(int(tracker.last_kf_id), 1))
    stats = mapper_step_fused.lower(*a, **k).compile().memory_analysis()
    _log(f"(d) fused mapper step memory: {_mem(stats)}")
    _log(f"(d) peak_bytes_in_use {gpu.memory_stats()['peak_bytes_in_use']}")


# --- four cards --------------------------------------------------------------

def run_four_gpus(devs):
    """Distributed BA over a 4-card mesh against bundle_adjust on one card,
    and the frame-sharded front end against per-frame extraction."""
    import jax
    from jax.sharding import Mesh
    from orbslam3lib_tpu.mapping.local_ba import bundle_adjust
    from orbslam3lib_tpu.ops.extractor import extract_orb_stereo
    from orbslam3lib_tpu.parallel.dist_ba import (dist_bundle_adjust,
                                                  partition_problem)
    from orbslam3lib_tpu.parallel.dist_frontend import make_sharded_frontend
    devs = devs[:4]
    t0 = time.time()
    prob, cam = make_dist_ba_problem(64, 16384, 3072)
    n_pts = prob.points.shape[0]
    one = _on(devs[0], jax.jit(lambda p, c: bundle_adjust(p, c)[:3]),
              prob, cam)
    mesh = Mesh(np.array(devs), ("mp",))
    dist = [np.asarray(x) for x in dist_bundle_adjust(
        partition_problem(prob, 4), cam, mesh)[:3]]
    rel = {"R": _rel(dist[0], one[0]), "t": _rel(dist[1], one[1]),
           "points": _rel(dist[2][:n_pts], one[2])}
    _log(f"(4) dist BA 64 cams / 16384 points / {prob.e_cam.shape[0]} obs, "
         f"4 cards vs 1: rel diff {rel} [{time.time() - t0:.1f}s]")
    assert max(rel.values()) <= GEOMETRY_REL_TOL, rel

    t0 = time.time()
    import bench
    imgs, _, _ = bench._load_frames(4)
    imgs = imgs.astype(np.float32)
    ths = np.full(4, 17.0, np.float32)
    frontend = make_sharded_frontend(Mesh(np.array(devs), ("dp",)))
    feats = jax.tree_util.tree_map(np.asarray, frontend(imgs, ths)[0])
    worst = (1.0, 0.0)
    for i in range(4):
        ref = _on(devs[0], lambda x: extract_orb_stereo(
            x, np.float32(17.0), max_kp=512, n_levels=8), imgs[i])
        mine = jax.tree_util.tree_map(lambda a: a[i], feats)
        agree, flips, _ = extract_agreement(mine, ref)
        worst = (min(worst[0], agree), max(worst[1], flips))
    _log(f"(4) sharded front end, 4 frames on 4 cards vs per-frame: worst "
         f"keypoint agreement {worst[0]}, BRIEF bit flips {worst[1]} "
         f"[{time.time() - t0:.1f}s]")
    assert worst[0] >= EXTRACT_MIN_KP_AGREE and \
        worst[1] <= EXTRACT_MAX_BIT_FLIPS, worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card path (distributed BA, sharded "
                         "front end) and what it is compared with")
    args = ap.parse_args()
    devs = _require_gpus(4 if args.four_gpus else 1)
    import jax
    import bench
    from orbslam3lib_tpu import native

    t_start = time.time()
    _log(f"(a) jax {jax.__version__}, devices {devs}")
    _log(f"(a) compile cache: {jax.config.jax_compilation_cache_dir}")
    _log(f"(a) nvidia-smi name, power.limit: {bench.nvidia_smi_name_power()}")
    if args.four_gpus:
        run_four_gpus(devs)
    else:
        lib = native.load_library()
        _log(f"(a) native BoW library: "
             f"{'built and loaded' if lib is not None else 'unavailable'}; "
             f"the live place-recognition DB is the JAX one")
        gpu, cpu = devs[0], jax.devices("cpu")[0]
        phase_b(gpu, cpu)
        tracker, imgs = run_stereo_main_path()
        run_system_facade()
        run_mono_oracle()
        phase_d(tracker, imgs, gpu)
        tracker.shutdown_mapping()
    _log(f"all phases passed in {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()

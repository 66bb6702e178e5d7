"""Benchmarks on the attached GPU. Prints ONE JSON line
{"metric", "value", "unit", "vs_baseline", ...} on stdout (breakdowns on
stderr); every result names its device (platform, device_kind, device
count, and the card's name and power limit from nvidia-smi). Exits with an
error when JAX finds no GPU.

Modes (argv[1], default `full_slam`):

  full_slam  — the headline: steady-state FULL SLAM throughput on a scene
               WITH a revisit. The camera orbits a textured room (360 deg /
               24 s): the first 240 deg populate a >=100-KF map, the
               measured steady-state windows carry the camera through the
               revisit of its starting views, so loop detection, Sim3
               verification, the essential-graph correction and the async
               GBA all run live inside the measured interval
               (LoopClosing.cc:90-309 run continuously in the reference's
               production path too). Reports throughput, loop count,
               detection-to-correction latency, frame-trajectory ATE (drifted
               odometry, never retro-corrected) vs keyframe ATE (loop-
               corrected map) and device-only timings.
               Baseline: the reference's end-to-end 90 FPS on the Lynx-R1
               DSP (BASELINE.md).
  distorted  — full_slam on radtan-distorted raw stereo input (EuRoC-like
               coefficients) driven through the on-device rectification path
               (Settings.cc:177/485); gate: ATE within ~10% of the clean
               run (sidecar .bench_last_clean.json).
  frontend   — front-end-only device throughput (extraction + rectified
               stereo matching), the reference's DSP hot loops 1-3.

Frames are cached in .bench_cache_<variant>.npz after the first run
(rendering is host-side NumPy and not part of any measured interval).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

N_POPULATE = 240          # frames 0..240 = 240 deg of the orbit
N_STEADY = 136            # 16 warmup + 3x40 measured (through the revisit)
N_WARM = 16
N_REPS = 3                # measurement windows (best-of)
DT = 1.0 / 15.0
PERIOD = 24.0             # seconds per 360-deg revolution
ROOT = os.path.dirname(os.path.abspath(__file__))
# EuRoC-like radial-tangential distortion (cf. tests/test_rectify.py)
DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)


def nvidia_smi_name_power() -> str:
    """The card's `name, power.limit` line as nvidia-smi reports it (a child
    process that stays off JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0].strip()


def require_gpu() -> dict:
    """Fail unless JAX's default device is a GPU; return the device fields
    every result line carries."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {devs}")
    name, power = [x.strip() for x in nvidia_smi_name_power().split(",", 1)]
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "gpu_name": name,
            "power_limit": power}


def _make_rig(distorted: bool):
    from orbslam3lib_tpu.io.synthetic import StereoRig
    return StereoRig(dist=DIST) if distorted else StereoRig()


def _make_world():
    from orbslam3lib_tpu.io.synthetic import CorridorWorld
    return CorridorWorld(half_w=4.0, half_h=1.5, z0=-4.0, z1=4.0,
                         back_wall=True)


def _render_frames(n_frames, distorted: bool):
    """Render the orbit. Each frame has its own noise stream (seeded by its
    index), so frames render in parallel threads (NumPy releases the GIL)
    and the result does not depend on the thread count."""
    from concurrent.futures import ThreadPoolExecutor
    from orbslam3lib_tpu.io.synthetic import orbit_trajectory
    rig = _make_rig(distorted)
    world = _make_world()
    R_l, c_l, ts = orbit_trajectory(n_frames, dt=DT, period=PERIOD,
                                    radius=0.5)

    def render(i):
        rng = np.random.default_rng([0, i])
        c_r = c_l[i] + R_l[i] @ np.array([rig.baseline, 0, 0], np.float32)
        return np.stack([world.render(R_l[i], c_l[i], rig, rng=rng),
                         world.render(R_l[i], c_r, rig, rng=rng)]
                        ).astype(np.uint8)

    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as ex:
        imgs = np.stack(list(ex.map(render, range(n_frames))))
    return imgs, ts.astype(np.float64), rig


def _render_params_key(distorted: bool):
    """Hash of everything that shapes the rendered frames; a cache rendered
    under different parameters must be invalidated."""
    import dataclasses
    import hashlib
    parts = [repr(dataclasses.asdict(_make_rig(distorted))),
             repr(dataclasses.asdict(_make_world())),
             f"orbit dt={DT!r} period={PERIOD!r} radius=0.5 "
             f"per-frame seeds [0, i]"]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _load_frames(n_frames, distorted: bool = False):
    cache = os.path.join(ROOT, ".bench_cache_dist.npz" if distorted
                         else ".bench_cache.npz")
    key = _render_params_key(distorted)
    if os.path.exists(cache):
        d = np.load(cache)
        if (d["imgs"].shape[0] >= n_frames
                and "params_key" in d and str(d["params_key"]) == key):
            return d["imgs"][:n_frames], d["ts"][:n_frames], _make_rig(distorted)
    imgs, ts, rig = _render_frames(n_frames, distorted)
    np.savez_compressed(cache, imgs=imgs, ts=ts, params_key=key)
    return imgs, ts, rig


def _gt_centers(ts):
    from orbslam3lib_tpu.io.synthetic import orbit_pose_at
    _, c = orbit_pose_at(np.asarray(ts, np.float64), period=PERIOD,
                         radius=0.5)
    return c


def chunk_step_call(tracker, imgs_dev):
    """(args, kwargs) of the steady-state chunk executable
    (`tracker._frame_step_chunk`) on the frames `imgs_dev` (C, 2, H, W)
    against the live map, from an identity pose."""
    import jax.numpy as jnp
    cfg = tracker.cfg
    cam2 = cfg.camera2 or cfg.camera
    R_lr, t_lr = cfg.stereo_extrinsics
    F = cfg.orb.max_kp
    kw = dict(
        bf=float(cfg.bf), min_z=float(cfg.stereo.min_z),
        close_depth=float(cfg.stereo.depth_factor * cfg.stereo.baseline),
        r_coarse=float(cfg.tracker.match_radius_coarse),
        r_fine=float(cfg.tracker.match_radius_fine),
        cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
        img_h=cfg.camera.height, n_levels=cfg.orb.n_levels,
        pose_rounds=cfg.tracker.pose_rounds,
        pose_iters=cfg.tracker.pose_iters, max_kp=F,
        fisheye=bool(cfg.stereo.fisheye),
        sad_refine=bool(cfg.stereo.sad_refine),
        local_only=bool(cfg.tracker.local_map_tracking),
        ref_kf=jnp.int32(max(int(tracker.last_kf_id), 0)))
    args = (tracker.map, jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3),
            jnp.full(F, -1, jnp.int32), jnp.zeros(F, jnp.float32),
            imgs_dev, jnp.float32(tracker.threshold.t), tracker.cam_params,
            jnp.asarray(cam2.params), jnp.asarray(R_lr), jnp.asarray(t_lr))
    return args, kw


def mapper_step_call(tracker, kid):
    """(args, kwargs) of the fused per-keyframe mapper executable
    (`loop_closing.mapper_step_fused`) for keyframe `kid` of the live map,
    with keyframe culling and the loop probe on."""
    import jax.numpy as jnp
    cfg = tracker.cfg
    pr, voc = tracker.place_rec, tracker.place_rec.voc
    args = (tracker.map, pr.bow_db, pr.active, voc.centroids, voc.idf,
            jnp.asarray(kid, jnp.int32), tracker.cam_params)
    kw = dict(k=voc.k, depth=voc.depth, cam_model=cfg.camera.model_id,
              img_w=cfg.camera.width, img_h=cfg.camera.height,
              n_levels=cfg.orb.n_levels, n_tri=cfg.mapping.n_tri_neighbors,
              n_fuse=cfg.mapping.n_fuse_neighbors, do_cull_kf=True,
              with_probe=True, th_far=tracker._th_far,
              prev_cand=jnp.int32(-1))
    return args, kw


def _device_metrics(tracker, imgs):
    """Device-only timings on the LIVE (already compiled) executables: many
    queued dispatches, one block, so the host's launch cost overlaps the
    device work."""
    import jax
    import jax.numpy as jnp
    from orbslam3lib_tpu.ops.extractor import extract_orb_stereo

    cfg = tracker.cfg
    out = {}

    def timed(fn, n, per=1):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        return round((time.perf_counter() - t0) / n / per * 1e3, 3)

    img0 = jnp.asarray(np.asarray(imgs[-1]))
    ex = lambda: extract_orb_stereo(img0.astype(jnp.float32),
                                    jnp.float32(tracker.threshold.t),
                                    max_kp=cfg.orb.max_kp,
                                    n_levels=cfg.orb.n_levels,
                                    return_canvas=True)[0].xy
    out["device_extract_ms"] = timed(ex, 30)

    # the steady-state chunk executable against the live map
    from orbslam3lib_tpu.tracking.tracker import _frame_step_chunk
    C = tracker.chunk
    imgs_dev = jnp.asarray(np.stack([np.asarray(imgs[-1])] * C))
    if tracker._rect_maps is not None:
        from orbslam3lib_tpu.utils.rectify import remap_bilinear_shifts
        rect = lambda: remap_bilinear_shifts(imgs_dev.astype(jnp.float32),
                                             tracker._rect_maps,
                                             *tracker._rect_bounds)
        out["device_rectify_ms_per_frame"] = round(timed(rect, 12) / C, 3)
        imgs_dev = rect()
    c_args, c_kw = chunk_step_call(tracker, imgs_dev)
    out["device_chunk_ms_per_frame"] = timed(
        lambda: _frame_step_chunk(*c_args, **c_kw)[1][0], 12, per=C)

    # per-keyframe mapper costs (the KF-cadence governor)
    leaves = jax.tree_util.tree_leaves(tracker.map)
    n_host = sum(1 for l in leaves if not isinstance(l, jax.Array))
    if n_host:
        print(f"[bench] WARNING: {n_host} host-side map leaves "
              f"(each re-uploads per dispatch)", file=sys.stderr, flush=True)
    if tracker.place_rec is not None:
        from orbslam3lib_tpu.mapping import local_mapping as lm
        from orbslam3lib_tpu.mapping.loop_closing import mapper_step_fused
        from orbslam3lib_tpu.mapping.map_ba import map_window_ba
        kid = jnp.int32(max(int(tracker.last_kf_id), 1))
        m_args, m_kw = mapper_step_call(tracker, kid)
        mstep = lambda: mapper_step_fused(*m_args, **m_kw)[3]
        out["device_mapper_ms_per_kf"] = timed(mstep, 20)

        ids, fixed = lm.covis_ba_window(tracker.map, kid,
                                        n_win=cfg.ba.window_size,
                                        n_fixed=cfg.ba.n_fixed)

        def ba():
            return map_window_ba(
                tracker.map, ids, fixed, tracker.cam_params, float(cfg.bf),
                cam_model=cfg.camera.model_id,
                n_ba_points=cfg.ba.max_points, n_iters=cfg.ba.n_iters).kf_R

        out["device_local_ba_ms_per_kf"] = timed(ba, 20)
    return out


def warm_cold_graphs(tracker):
    """Compile and run once every graph a live loop closure / tracking
    hiccup can demand mid-window: the staged Sim3 verification cascade, the
    essential-graph correction, the async-GBA chunk, and the relocalization
    chain. A fresh machine starts with no compile cache, so without this
    the first real loop pays multi-second compiles inside a measured
    window. Prints one line per graph; an exception propagates."""
    import jax
    import jax.numpy as jnp
    from orbslam3lib_tpu.mapping.local_ba import CHI2_GATE_AFTER
    from orbslam3lib_tpu.mapping.loop_closing import verify_loop_fused
    from orbslam3lib_tpu.mapping.map_ba import global_bundle_adjust_auto
    from orbslam3lib_tpu.models.vocabulary import bow_from_descriptors
    from orbslam3lib_tpu.tracking.reloc import (detect_reloc_candidates,
                                                relocalize_against_kf,
                                                track_reference_kf)

    cfg = tracker.cfg
    m = tracker.map
    cam = tracker.cam_params
    ck = dict(cam_model=cfg.camera.model_id, img_w=cfg.camera.width,
              img_h=cfg.camera.height, n_levels=cfg.orb.n_levels)
    F = cfg.orb.max_kp
    lc = tracker.loop_closer
    pr = tracker.place_rec
    fix = lc.fix_scale if lc else True
    graphs = [("verify_loop_fused", lambda: verify_loop_fused(
        m, jnp.int32(1), jnp.int32(0), cam, fix_scale=fix, **ck))]
    if lc is not None:
        def correct():
            # essential-graph correction (restore the state it mutates)
            n_edges = len(lc.loop_edges)
            m2 = lc.correct(m, int(tracker.last_kf_id), 0,
                            (jnp.eye(3), jnp.zeros(3), jnp.float32(1.0)))
            lc.loop_edges = lc.loop_edges[:n_edges]
            return m2.kf_R
        graphs.append(("LoopCloser.correct", correct))
        if lc.gba_iters > 0:
            # the async GBA's 1-iteration chunks, before and after pruning
            graphs.append(("global_bundle_adjust_auto", lambda: (
                global_bundle_adjust_auto(
                    m, cam, bf=float(cfg.bf), cam_model=cfg.camera.model_id,
                    n_iters=CHI2_GATE_AFTER + 1, chunk=1,
                    n_ba_points=min(int(m.max_mp), 4096)).kf_R)))
    if pr is not None:
        graphs.append(("detect_reloc_candidates", lambda: (
            detect_reloc_candidates(m, pr.bow_db, pr.active,
                                    bow_from_descriptors(
                                        pr.voc, m.kf_desc[0],
                                        m.kf_feat_valid[0])))))
    graphs.append(("relocalize_against_kf", lambda: relocalize_against_kf(
        m, jnp.int32(0), m.kf_xy[0], m.kf_level[0], m.kf_desc[0],
        m.kf_feat_valid[0], m.kf_angle[0], cam, **ck)))
    graphs.append(("track_reference_kf", lambda: track_reference_kf(
        m, jnp.int32(0), jnp.eye(3), jnp.zeros(3), m.kf_xy[0],
        m.kf_level[0], m.kf_desc[0], m.kf_feat_valid[0], m.kf_angle[0],
        jnp.full(F, -1.0), jnp.zeros(F), cam,
        cam_model=cfg.camera.model_id, bf=float(cfg.bf),
        n_levels=cfg.orb.n_levels)))
    t_all = time.time()
    for name, fn in graphs:
        t0 = time.time()
        jax.block_until_ready(fn())
        print(f"[bench] cold graph {name}: compiled+ran in "
              f"{time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    print(f"[bench] cold-graph warmup in {time.time() - t_all:.1f}s",
          file=sys.stderr, flush=True)
    return [name for name, _ in graphs]


def run_full_slam(distorted: bool = False):
    """The headline stereo deployment end to end: populate a map over the
    first 240 deg of the orbit, then run the measured windows through the
    revisit (live loop detection, verification, correction, async GBA).
    Returns (tracker, frames, result dict with the speed and the gates)."""
    from orbslam3lib_tpu.config import SlamConfig
    from orbslam3lib_tpu.evaluation import ate_rmse
    from orbslam3lib_tpu.tracking.tracker import Tracker

    t_setup = time.time()
    imgs, ts, rig = _load_frames(N_POPULATE + N_STEADY, distorted)
    print(f"[bench] frames ready in {time.time() - t_setup:.1f}s"
          f"{' (distorted input)' if distorted else ''}",
          file=sys.stderr, flush=True)

    cfg = SlamConfig()
    cfg.camera.fx, cfg.camera.fy = rig.fx, rig.fy
    cfg.camera.cx, cfg.camera.cy = rig.cx, rig.cy
    cfg.camera.width, cfg.camera.height = rig.width, rig.height
    cfg.stereo.baseline = rig.baseline
    if distorted:
        # raw distorted stereo -> on-device rectification (Settings.cc:485)
        cfg.camera.dist = tuple(rig.dist)
        cfg.camera2 = None
        cfg.stereo.rectify = True
    cfg.orb.max_kp = 512
    cfg.orb.n_levels = 8
    # production schedule: the reference runs 2 rounds x {1,2} LM iterations
    # per frame ("LYNX MODIFIED", Optimizer.cc:990-995)
    cfg.tracker.pose_rounds = 2
    cfg.tracker.pose_iters = 2

    # zero-copy ingest analog (the reference's rpcmem/AHardwareBuffer path,
    # LynxHardwareAccelerator.cpp:121: camera frames land in pre-registered
    # shared memory, no per-frame copy): stage every frame device-resident
    # up front.
    import jax as _jax
    t0 = time.time()
    imgs_dev = [_jax.device_put(imgs[i]) for i in range(len(imgs))]
    _jax.block_until_ready(imgs_dev[-1])
    print(f"[bench] {len(imgs_dev)} frames staged on device "
          f"in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)

    pipeline = int(os.environ.get("ORBSLAM3_TPU_PIPELINE", "16"))
    chunk = int(os.environ.get("ORBSLAM3_TPU_CHUNK", "4"))
    tracker = Tracker(cfg, sensor="stereo", enable_loop_closing=True,
                      enable_timing=True, pipeline=pipeline, chunk=chunk,
                      async_mapping=True)
    # async GBA after a live loop correction (mpThreadGBA analog): the
    # measured windows then absorb its FPS impact, as in production
    cfg.mapping.async_gba = True
    if tracker.loop_closer is not None:
        tracker.loop_closer.async_gba = True

    # --- populate: dense keyframing over the first 240 deg of the orbit ---
    t0 = time.time()
    kf_ratio = cfg.tracker.kf_ref_ratio
    cfg.tracker.kf_ref_ratio = 10.0       # c2 always true -> KF by c1 cadence
    cfg.tracker.min_frames_between_kf = 2  # KF every 2nd frame: ~120 KFs
    cfg.tracker.max_frames_between_kf = 2  # (headroom under max_kf=256)
    # no redundancy culling while BUILDING the map: dense populate keyframes
    # are redundant by construction, and the goal here is a big map
    cfg.mapping.kf_culling = False
    # PIPELINED populate: frames flow through the chunked fast path; the
    # mapper queue is detached so mapping runs inline at consume time
    # (mapper-idle is then always true -> exactly one KF per consumed frame,
    # deterministic) and loop probes ride the batched burst fetch: one
    # batched fetch per chunk instead of ~15 blocking syncs per frame.
    queue_save, tracker._map_queue = tracker._map_queue, None
    for i in range(N_POPULATE):
        tracker.process_frame(imgs_dev[i], float(ts[i]))
    tracker.finish()
    tracker._map_queue = queue_save
    n_kf = int(tracker.map.n_kf)
    # n_mp is the live landmark count (the allocator recycles freed slots)
    n_mp = int(tracker.map.n_mp)
    fails_populate = tracker.stats["track_fail"]
    print(f"[bench] populate: {N_POPULATE} frames -> {n_kf} KFs, "
          f"{n_mp} live MPs, fails {fails_populate} "
          f"in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    for k, st in sorted(tracker.timer.summary().items(),
                        key=lambda kv: -kv[1]["mean_ms"] * kv[1]["count"]):
        print(f"[bench]   populate {k:20s} mean {st['mean_ms']:8.2f} ms "
              f"n={st['count']}", file=sys.stderr, flush=True)
    cfg.tracker.kf_ref_ratio = kf_ratio
    cfg.tracker.min_frames_between_kf = 3
    cfg.tracker.max_frames_between_kf = 15
    cfg.mapping.kf_culling = True
    # reclaim the slots of populate-culled landmarks NOW: a capacity-pressure
    # compaction inside a measured window would stall it
    tracker._compact_map()

    # --- steady state: warm up the pipelined graphs, then measure ---
    # pre-compile the cull-enabled mapper graph (populate ran with culling
    # off; its first lazy compile must not land inside a measured window)
    import jax
    import jax.numpy as jnp
    if tracker.place_rec is not None:
        from orbslam3lib_tpu.mapping.loop_closing import mapper_step_fused
        m_args, m_kw = mapper_step_call(tracker, tracker.last_kf_id)
        warm = mapper_step_fused(*m_args, **m_kw)
        jax.block_until_ready(warm[0].kf_R)
        del warm
    warm_cold_graphs(tracker)

    base = N_POPULATE
    for i in range(N_WARM):
        tracker.process_frame(imgs_dev[base + i], float(ts[base + i]))
    tracker._drain_pipeline()
    tracker.timer.samples.clear()

    # measure in windows and keep the best HEALTHY one (best-of-N isolates
    # engine cost from host noise). Health gate: a window during which
    # tracking failed or that ends with an empty/reset map is NOT eligible —
    # a dead tracker is faster than a live one, so rewarding it would invert
    # the metric.
    n_meas = (N_STEADY - N_WARM) // N_REPS
    best_dt = worst_dt = None
    any_dt = None
    i = N_WARM
    for rep in range(N_REPS):
        fails_before = tracker.stats["track_fail"]
        t0 = time.perf_counter()
        for _ in range(n_meas):
            tracker.process_frame(imgs_dev[base + i], float(ts[base + i]))
            i += 1
        tracker._drain_pipeline()
        dt = (time.perf_counter() - t0) / n_meas
        d_fails = tracker.stats["track_fail"] - fails_before
        n_kf_now = int(tracker.map.n_kf)
        healthy = d_fails == 0 and n_kf_now > 0
        print(f"[bench] window {rep}: {dt * 1e3:.2f} ms/frame "
              f"(fails +{d_fails}, KFs {n_kf_now}, "
              f"loops {tracker.stats['n_loops']}"
              f"{', UNHEALTHY - excluded' if not healthy else ''})",
              file=sys.stderr, flush=True)
        any_dt = dt if any_dt is None else min(any_dt, dt)
        worst_dt = dt if worst_dt is None else max(worst_dt, dt)
        if healthy:
            best_dt = dt if best_dt is None else min(best_dt, dt)

    degraded = best_dt is None or tracker.stats["track_fail"] > 5
    dt = best_dt if best_dt is not None else any_dt

    fps = 1.0 / dt
    tracker.finish()
    n_kf_final = int(tracker.map.n_kf)
    n_loops = tracker.stats["n_loops"]

    # --- accuracy: drifted odometry trajectory vs loop-corrected keyframes
    est = tracker.trajectory_centers()
    ts_traj = np.asarray([t for t, _, _ in tracker.trajectory])
    ate_traj = ate_rmse(est, _gt_centers(ts_traj), with_scale=False)
    kf_valid = np.asarray(tracker.map.kf_valid)
    kf_R = np.asarray(tracker.map.kf_R)[kf_valid]
    kf_t = np.asarray(tracker.map.kf_t)[kf_valid]
    kf_ts = np.asarray(tracker.map.kf_ts)[kf_valid] + (tracker._ts_origin or 0.0)
    kf_c = -np.einsum("kij,kj->ki", np.transpose(kf_R, (0, 2, 1)), kf_t)
    ate_kf = ate_rmse(kf_c, _gt_centers(kf_ts), with_scale=False)

    print(f"[bench] steady state: {n_meas} frames/window, "
          f"{dt * 1e3:.2f} ms/frame, KFs {n_kf_final}, "
          f"fails {tracker.stats['track_fail']}, loops {n_loops}, "
          f"ATE traj {ate_traj:.4f} m vs KF {ate_kf:.4f} m"
          f"{' [DEGRADED: no healthy window]' if degraded else ''}",
          file=sys.stderr, flush=True)
    for k, st in sorted(tracker.timer.summary().items()):
        print(f"[bench]   {k:20s} mean {st['mean_ms']:8.2f} ms  "
              f"n={st['count']}", file=sys.stderr, flush=True)

    out = {
        "metric": "full_slam_distorted" if distorted else "full_slam_fps",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 90.0, 3),
        "worst_window_ms": round(worst_dt * 1e3, 2),
        "fails": tracker.stats["track_fail"],
        "fails_after_populate": tracker.stats["track_fail"] - fails_populate,
        "n_kf": n_kf_final,
        "n_loops": n_loops,
        "n_gba": tracker.stats["n_gba"],
        "n_gba_merged": tracker.stats["n_gba_merged"],
        "ate_traj_m": round(ate_traj, 4),
        "ate_kf_m": round(ate_kf, 4),
    }
    if "loop_latency_ms" in tracker.stats:
        out["loop_latency_ms"] = tracker.stats["loop_latency_ms"]
    if degraded:
        out["degraded"] = True
    return tracker, imgs, out


def bench_full_slam(distorted: bool = False):
    device = require_gpu()
    tracker, imgs, out = run_full_slam(distorted)
    dev = _device_metrics(tracker, imgs)
    print(f"[bench] device-only: extract {dev['device_extract_ms']} ms, "
          f"chunk step {dev['device_chunk_ms_per_frame']} ms/frame",
          file=sys.stderr, flush=True)
    out.update(dev)
    out.update(device)
    tracker.shutdown_mapping()

    sidecar = os.path.join(ROOT, ".bench_last_clean.json")
    if distorted:
        # parity gate vs the last clean run: ATE within ~10%
        if os.path.exists(sidecar):
            clean = json.load(open(sidecar))
            out["ate_clean_m"] = clean.get("ate_kf_m")
            if out["ate_clean_m"]:
                out["ate_ratio_vs_clean"] = round(
                    out["ate_kf_m"] / max(out["ate_clean_m"], 1e-9), 3)
    else:
        json.dump(out, open(sidecar, "w"))
    print(json.dumps(out))


def bench_frontend():
    device = require_gpu()
    import jax
    import jax.numpy as jnp
    from orbslam3lib_tpu.ops.extractor import extract_orb_stereo
    from orbslam3lib_tpu.tracking.matching import match_rectified_stereo

    @jax.jit
    def frontend(img_pair, threshold):
        feats = extract_orb_stereo(img_pair, threshold, max_kp=512, n_levels=8)
        u_r, depth = match_rectified_stereo(
            feats.xy[0], feats.level[0], feats.desc[0], feats.valid[0],
            feats.xy[1], feats.level[1], feats.desc[1], feats.valid[1],
            jnp.float32(33.0), jnp.float32(0.3), n_levels=8)
        return feats.xy, feats.valid, u_r, depth

    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(2, 50, 80)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), dtype=np.float32))
    img += rng.normal(0, 8, img.shape).astype(np.float32)
    img_pair = jnp.asarray(np.clip(img, 0, 255))
    threshold = jnp.float32(17.0)

    out = frontend(img_pair, threshold)
    jax.block_until_ready(out)
    n_warm, n_iter = 5, 50
    for _ in range(n_warm):
        jax.block_until_ready(frontend(img_pair, threshold))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = frontend(img_pair, threshold)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n_iter
    fps = 1.0 / dt
    print(json.dumps({
        "metric": "stereo_frontend_fps",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 90.0, 3),
        **device,
    }))


def main():
    import faulthandler
    faulthandler.dump_traceback_later(3600, exit=False)
    from orbslam3lib_tpu.utils.timing import Verbose
    Verbose.level = int(os.environ.get("ORBSLAM3_TPU_VERBOSE", "0"))
    mode = sys.argv[1] if len(sys.argv) > 1 else "full_slam"
    if mode == "frontend":
        bench_frontend()
    elif mode == "full_slam":
        bench_full_slam()
    elif mode == "distorted":
        bench_full_slam(distorted=True)
    else:
        raise SystemExit(f"unknown bench mode {mode!r}")


if __name__ == "__main__":
    main()

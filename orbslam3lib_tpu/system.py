"""System: the public API facade + frame pipeline.

Re-design of the reference's System layer
(/root/reference app/src/main/cpp/src/System.cc): constructor loads the
vocabulary, builds Atlas/KeyFrameDatabase, spawns the mapping/loop threads
and the AHB-consumer thread (System.cc:48-223); TrackStereo/TrackStereoAHB/
TrackRGBD/TrackMonocular dispatch frames (System.cc:260-363); the production
path is a bounded producer/consumer pipeline — the camera thread preprocesses
frame N+1 while the consumer finishes tracking frame N, queue depth 2 with
drop-on-backpressure (System.cc:356-438; SURVEY.md §2.4 P1); Shutdown joins
everything and SaveTrajectory* writes the result (System.h:158-179).

Here the DSP preprocessing is the jitted extraction graph, so the pipeline
overlap is: the producer thread dispatches extraction (async on device) for
frame N+1 while the consumer runs frame N's host-side tracking logic.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .config import SlamConfig
from .evaluation import save_trajectory_kitti, save_trajectory_tum
from .tracking.tracker import LOST, NOT_INITIALIZED, OK, RECENTLY_LOST, Tracker
from .utils.timing import StageTimer, Verbose

SENSOR_MONOCULAR = "mono"
SENSOR_STEREO = "stereo"
SENSOR_RGBD = "rgbd"
SENSOR_IMU_MONOCULAR = "imu_mono"
SENSOR_IMU_STEREO = "imu_stereo"


class System:
    def __init__(self, cfg: SlamConfig, sensor: str = SENSOR_STEREO,
                 vocabulary=None, use_pipeline: bool = False,
                 enable_loop_closing: bool = True,
                 enable_timing: bool = False,
                 background_mapping: bool = False,
                 pose_callback: Optional[Callable] = None):
        self.sensor = sensor
        cfg.use_imu = sensor in (SENSOR_IMU_MONOCULAR, SENSOR_IMU_STEREO)
        base = "mono" if sensor in (SENSOR_MONOCULAR, SENSOR_IMU_MONOCULAR) \
            else "stereo"
        self.tracker = Tracker(cfg, sensor=base, vocabulary=vocabulary,
                               enable_loop_closing=enable_loop_closing,
                               enable_timing=enable_timing,
                               async_mapping=background_mapping)
        self.cfg = cfg
        self.pose_callback = pose_callback
        self._shutdown = False
        self._queue: Optional[queue.Queue] = None
        self._consumer: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._dropped = 0
        if use_pipeline:
            self._queue = queue.Queue(maxsize=2)
            self._consumer = threading.Thread(target=self._consume_loop,
                                              daemon=True)
            self._consumer.start()

    # -- frame entry points (TrackStereo / TrackMonocular / TrackRGBD) ------
    def track_stereo(self, img_pair: np.ndarray, ts: float,
                     imu: Optional[Tuple] = None) -> dict:
        return self._dispatch(img_pair, ts, imu)

    def track_monocular(self, img: np.ndarray, ts: float,
                        imu: Optional[Tuple] = None) -> dict:
        return self._dispatch(img, ts, imu)

    def track_rgbd(self, img: np.ndarray, depth_map: np.ndarray,
                   ts: float) -> dict:
        """RGB-D: depth sampled at keypoints provides the stereo-equivalent
        observations (System::TrackRGBD; Frame RGB-D ctor builds virtual
        right coords u_r = u - bf/z from the depth map)."""
        return self._dispatch((img, depth_map), ts, None)

    def _dispatch(self, payload, ts, imu) -> dict:
        if self._queue is None:
            return self._process(payload, ts, imu)
        # producer side of the P1 pipeline: drop on backpressure
        try:
            self._queue.put_nowait((payload, ts, imu))
        except queue.Full:
            self._dropped += 1
            Verbose.log(f"[system] frame dropped (backpressure), total "
                        f"{self._dropped}", Verbose.VERBOSE)
        return {"queued": True}

    def _consume_loop(self):
        while not self._shutdown:
            try:
                payload, ts, imu = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            out = self._process(payload, ts, imu)
            if self.pose_callback is not None and self.tracker.pose is not None:
                R, t = self.tracker.pose
                self.pose_callback(np.array(R), np.array(t), ts, out)

    def _process(self, payload, ts, imu) -> dict:
        with self._lock:
            if imu is not None:
                gyro, acc, dts = imu
                self.tracker.feed_imu(gyro, acc, dts)
            if self.sensor == SENSOR_RGBD:
                img, depth_map = payload
                return self._process_rgbd(img, depth_map, ts)
            return self.tracker.process_frame(payload, ts)

    def _process_rgbd(self, img, depth_map, ts) -> dict:
        """Feed an RGB-D frame through the stereo path by synthesizing a
        virtual rectified right view from the depth map at keypoints."""
        from .ops.extractor import extract_orb_mono
        t = self.tracker
        cfg = self.cfg
        feats = extract_orb_mono(
            jnp.asarray(img), jnp.float32(t.threshold.t),
            max_kp=cfg.orb.max_kp, n_levels=cfg.orb.n_levels)
        xy = np.asarray(feats.xy[0])
        xs = np.clip(xy[:, 0].astype(int), 0, depth_map.shape[1] - 1)
        ys = np.clip(xy[:, 1].astype(int), 0, depth_map.shape[0] - 1)
        depth = depth_map[ys, xs].astype(np.float32)
        depth[depth <= 0] = 0.0
        u_r = np.where(depth > 0, xy[:, 0] - cfg.bf / np.maximum(depth, 1e-3),
                       -1.0).astype(np.float32)
        n_feat = int(feats.n_valid[0])
        t.threshold.update(n_feat)
        if t.state == NOT_INITIALIZED:
            out = t._initialize_stereo(feats, jnp.asarray(u_r),
                                       jnp.asarray(depth), ts, n_feat)
        else:
            out = t._track(feats, jnp.asarray(u_r), jnp.asarray(depth), ts, n_feat)
        t.frame_id += 1
        t.stats["n_frames"] += 1
        if t.pose is not None:
            R, tt = t.pose
            t.trajectory.append((ts, np.array(R), np.array(tt)))
        return out

    # -- state accessors (System.h:187-190) ---------------------------------
    def get_tracking_state(self) -> int:
        return self.tracker.state

    def get_stats(self) -> dict:
        return dict(self.tracker.stats)

    def is_lost(self) -> bool:
        return self.tracker.state in (RECENTLY_LOST, LOST)

    def map_info(self) -> dict:
        m = self.tracker.map
        return {"n_kf": int(m.n_kf), "n_mp": int(m.n_mp),
                "n_maps": self.tracker.atlas.count_maps()}

    # -- lifecycle ----------------------------------------------------------
    def wait_idle(self, timeout: float = 30.0):
        if self._queue is not None:
            import time
            t0 = time.time()
            while not self._queue.empty() and time.time() - t0 < timeout:
                import time as _t
                _t.sleep(0.01)

    def shutdown(self):
        """System::Shutdown (System.cc:628): drain + join threads."""
        self.wait_idle()
        self._shutdown = True
        if self._consumer is not None:
            self._consumer.join(timeout=5.0)
        self.tracker.shutdown_mapping()
        if self.tracker.timer.enabled:
            self.tracker.timer.print_time_stats()

    # -- trajectory output (System.h:158-179) -------------------------------
    def save_trajectory_tum(self, path: str):
        traj = self.tracker.trajectory
        save_trajectory_tum(path, [ts for ts, _, _ in traj],
                            [(R, t) for _, R, t in traj])

    def save_trajectory_kitti(self, path: str):
        save_trajectory_kitti(path, [(R, t) for _, R, t in self.tracker.trajectory])

    # -- visualization (Viewer/FrameDrawer/MapDrawer equivalents, offline;
    #    the reference's Pangolin stack is compiled out on device anyway,
    #    CMakeLists.txt:21-25) ----------------------------------------------
    def save_map_render(self, path: str, title: str = "map"):
        from . import viz
        viz.render_map(path, self.tracker.map, title=title,
                       trajectory=self.tracker.trajectory)

    def export_map_ply(self, path: str):
        from . import viz
        viz.export_ply(path, self.tracker.map,
                       trajectory=self.tracker.trajectory)

    # -- checkpoint / resume (System.cc:146-150 — disabled in the reference,
    #    supported here: the map is already tensors, SURVEY.md §5.4) --------
    def save_atlas(self, path: str):
        from .models.serialization import save_atlas
        save_atlas(self.tracker.atlas, path)

    def load_atlas(self, path: str):
        from .models.serialization import load_atlas
        self.tracker.atlas = load_atlas(path)

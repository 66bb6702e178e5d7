"""Offline visualization: frame overlays, map renders, PLY export.

Equivalent of the reference's Pangolin stack
(/root/reference app/src/main/cpp/src/Viewer.cc, FrameDrawer.cc,
MapDrawer.cc — gated by USE_GRAPHICS and compiled out on device,
CMakeLists.txt:21-25). On a headless host the live GL window becomes
offline artifacts: PNG overlays of the tracked frame (FrameDrawer::DrawFrame
semantics — keypoints colored by tracking state), top-down / 3-D map renders
(MapDrawer::DrawMapPoints / DrawKeyFrames), and PLY point-cloud + trajectory
exports for external viewers.

Pure NumPy drawing (no GUI deps on the hot path); matplotlib only inside
render_map, imported lazily.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# PNG writing (stdlib only, keeps the hot path free of GUI imports)
# ---------------------------------------------------------------------------

def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to a PNG file."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# FrameDrawer
# ---------------------------------------------------------------------------

GREEN = np.array([30, 220, 60], np.uint8)     # tracked map point
BLUE = np.array([70, 130, 240], np.uint8)     # new/untracked feature
RED = np.array([230, 60, 50], np.uint8)       # outlier/lost


def draw_frame(img: np.ndarray, xy: np.ndarray, valid: np.ndarray,
               tracked: Optional[np.ndarray] = None,
               radius: int = 2) -> np.ndarray:
    """FrameDrawer::DrawFrame equivalent: grayscale frame + keypoint markers.

    img (H, W) float/uint8; xy (N, 2); valid (N,) bool; tracked (N,) bool
    (green = tracked in map, blue = detected only). Returns (H, W, 3) uint8.
    """
    g = np.clip(np.asarray(img, np.float32), 0, 255).astype(np.uint8)
    rgb = np.stack([g, g, g], axis=-1)
    h, w = g.shape
    xy = np.asarray(xy)
    valid = np.asarray(valid, bool)
    tracked = np.zeros(len(xy), bool) if tracked is None else np.asarray(tracked, bool)
    for i in np.flatnonzero(valid):
        x, y = int(round(float(xy[i, 0]))), int(round(float(xy[i, 1])))
        if not (radius <= x < w - radius and radius <= y < h - radius):
            continue
        color = GREEN if tracked[i] else BLUE
        rgb[y - radius:y + radius + 1, x - radius] = color
        rgb[y - radius:y + radius + 1, x + radius] = color
        rgb[y - radius, x - radius:x + radius + 1] = color
        rgb[y + radius, x - radius:x + radius + 1] = color
    return rgb


def save_frame(path: str, img, xy, valid, tracked=None) -> None:
    write_png(path, draw_frame(img, xy, valid, tracked))


# ---------------------------------------------------------------------------
# MapDrawer
# ---------------------------------------------------------------------------

def kf_centers(m) -> np.ndarray:
    """Camera centers of valid keyframes: c = -R^T t."""
    R = np.asarray(m.kf_R)
    t = np.asarray(m.kf_t)
    ok = np.asarray(m.kf_valid, bool)
    c = -np.einsum("kij,kj->ki", R.transpose(0, 2, 1), t)
    return c[ok]


def render_map(path: str, m, title: str = "map",
               trajectory: Optional[Sequence] = None) -> None:
    """MapDrawer equivalent: top-down (x-z) scatter of landmarks, keyframe
    centers, and optionally the frame trajectory. Saves a PNG via matplotlib
    (Agg backend, lazily imported)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(m.mp_pos)[np.asarray(m.mp_valid, bool)]
    kfs = kf_centers(m)
    fig, ax = plt.subplots(figsize=(7, 7))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1.0, c="#777777", label="landmarks")
    if len(kfs):
        ax.plot(kfs[:, 0], kfs[:, 2], "o-", ms=3, c="#1f77b4", label="keyframes")
    if trajectory is not None and len(trajectory):
        c = np.asarray([
            -np.asarray(R).T @ np.asarray(t) for _, R, t in trajectory])
        ax.plot(c[:, 0], c[:, 2], "-", lw=0.8, c="#2ca02c", label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def export_ply(path: str, m, trajectory: Optional[Sequence] = None) -> None:
    """Export landmarks (gray) + keyframe centers (blue) + trajectory
    (green) as an ASCII PLY point cloud."""
    pts = np.asarray(m.mp_pos)[np.asarray(m.mp_valid, bool)]
    kfs = kf_centers(m)
    rows = [(p, (180, 180, 180)) for p in pts]
    rows += [(c, (40, 90, 230)) for c in kfs]
    if trajectory is not None:
        for _, R, t in trajectory:
            rows.append((-np.asarray(R).T @ np.asarray(t), (40, 200, 70)))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(rows)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, (r, g, b) in rows:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")

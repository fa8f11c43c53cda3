"""Frame-dir → mp4/gif export and depth / RGB frame dumping for evaluation
videos (counterpart of ``partmanip_tpu/utils/video.py``; the renderer's
frames replace the reference's save camera).

``cv2`` and ``ffmpeg`` are optional: without ``cv2`` the frames are left as
``.npy`` for offline conversion, without ``ffmpeg`` no gif is made.
"""

from __future__ import annotations

import os
import subprocess
from os.path import join as pjoin

import numpy as np


def save_depth_frame(path: str, depth: np.ndarray, far: float = 3.0):
    """Write one depth image as an 8-bit grayscale png (or .npy fallback)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = np.clip(depth / far, 0, 1)
    img8 = (255 * (1.0 - img)).astype(np.uint8)
    try:
        import cv2
        cv2.imwrite(path, img8)
    except ImportError:
        np.save(path.replace(".png", ".npy"), img8)


def save_rgb_frame(path: str, rgb: np.ndarray):
    """Write one RGB image ([H, W, 3] float 0-1 or uint8) as png (or .npy
    fallback): the evaluation video's frames."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = np.asarray(rgb)
    if img.dtype != np.uint8:
        img = (255 * np.clip(img, 0, 1)).astype(np.uint8)
    try:
        import cv2
        cv2.imwrite(path, img[..., ::-1])  # cv2 writes BGR
    except ImportError:
        np.save(path.replace(".png", ".npy"), img)


def path_to_video(frame_dir: str, fps: int = 15, cleanup: bool = True):
    """png frame dir → video.mp4 (+ gif if ffmpeg exists), then delete the
    frames.  Returns the mp4's path, or None (no frames, or no cv2)."""
    frames = sorted(f for f in os.listdir(frame_dir) if f.endswith(".png"))
    if not frames:
        print(f"no frames in {frame_dir}")
        return None
    out = pjoin(frame_dir, "video.mp4")
    try:
        import cv2
        first = cv2.imread(pjoin(frame_dir, frames[0]))
        h, w = first.shape[:2]
        vw = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            vw.write(cv2.imread(pjoin(frame_dir, f)))
        vw.release()
    except ImportError:
        print("cv2 unavailable — leaving raw frames in place")
        return None
    try:
        subprocess.run(["ffmpeg", "-y", "-i", out,
                        pjoin(frame_dir, "video.gif")],
                       capture_output=True, timeout=120)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        pass
    if cleanup:
        for f in frames:
            os.remove(pjoin(frame_dir, f))
    return out

"""Point-cloud inspection (counterpart of ``partmanip_tpu/utils/viewer.py``).

``dump_pointcloud`` writes xyz(+rgb) text files loadable by any viewer (the
format the reference debug-dumps with ``np.savetxt``), and
``PointCloudViewer`` keeps the reference's update-loop API, writing
matplotlib scatter snapshots when matplotlib is present and text dumps
otherwise.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def dump_pointcloud(path: str, points, colors=None):
    """Write ``points`` ([..., 3], numpy or a tensor) and optional
    ``colors`` as rows of ``x y z [r g b]``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pts = _numpy(points).reshape(-1, 3)
    if colors is not None:
        pts = np.concatenate([pts, _numpy(colors).reshape(-1, 3)], -1)
    np.savetxt(path, pts)


def _numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class PointCloudViewer:
    """Drop-in for the reference's live viewer: ``update(points)`` writes
    numbered scatter snapshots under ``out_dir`` (default
    ``partmanip_viewer`` under the temporary directory)."""

    def __init__(self, out_dir: str = None):
        self.out_dir = out_dir or os.path.join(tempfile.gettempdir(), "partmanip_viewer")
        self.count = 0
        os.makedirs(self.out_dir, exist_ok=True)

    def update(self, points):
        pts = _numpy(points).reshape(-1, 3)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig = plt.figure(figsize=(6, 6))
            ax = fig.add_subplot(projection="3d")
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1)
            fig.savefig(os.path.join(self.out_dir, f"pc_{self.count:05d}.png"))
            plt.close(fig)
        except ImportError:
            dump_pointcloud(
                os.path.join(self.out_dir, f"pc_{self.count:05d}.txt"), pts)
        self.count += 1

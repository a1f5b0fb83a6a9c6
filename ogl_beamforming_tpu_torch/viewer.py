"""Frame visualization: B-mode rendering, A-scan plots, live display.

The TPU-library replacement for the reference's interactive Vulkan/raylib UI
(reference: ui.c — frame views, 3D X-plane views, compute-stats panels).
Rendering uses the same display transfer function as the reference's
fragment shader (render_3d.frag.glsl:61-70) via ops/display.py; output is
matplotlib figures / PNG files / numpy RGB arrays rather than a live GL
window (SURVEY.md §7 step 8).
"""

from __future__ import annotations

import numpy as np

from .ops.display import display_map
from .utils.device import to_host


def frame_to_bmode(frame, db_cutoff: float = -60.0, threshold: float = 1.0,
                   gamma: float = 1.0) -> np.ndarray:
    """Beamformed frame -> [0,1] display values (nx, ny, nz)."""
    data = frame.data if hasattr(frame, "data") else frame
    return to_host(display_map(data, db_cutoff, threshold, gamma))


def bmode_image(frame, plane: str = "xz", index: int = 0,
                db_cutoff: float = -60.0, gamma: float = 1.0) -> np.ndarray:
    """Extract a 2D display image from a frame.

    ``plane``: "xz" (lateral x axial), "yz", or "xy", slicing the remaining
    axis at ``index`` — the frame-view planes of the reference UI.
    Returns (axial, lateral) float image in [0, 1].
    """
    v = frame_to_bmode(frame, db_cutoff=db_cutoff, gamma=gamma)
    if v.ndim == 2:
        v = v[:, :, None]
    nx, ny, nz = v.shape
    if plane == "xz":
        img = v[:, min(index, ny - 1), :]       # (x, z)
    elif plane == "yz":
        img = v[min(index, nx - 1), :, :]       # (y, z)
    elif plane == "xy":
        return v[:, :, min(index, nz - 1)].T    # (y, x)
    else:
        raise ValueError(f"unknown plane {plane!r}")
    # 2D grids store axial on axis 1 when nz == 1
    if nz == 1:
        img = v[:, :, 0]
    return img.T                                 # axial down, lateral across


def a_scan(frame, lateral_index: int = 0) -> np.ndarray:
    """1D axial magnitude line (render_3d.frag.glsl:98-109 A-scan mode).

    For 2D frames (nx, n_axial, 1) the axial dimension is axis 1 (the
    das_transform_2d convention); 3D volumes use z with y centered.
    """
    data = to_host(frame.data if hasattr(frame, "data") else frame)
    if data.ndim == 3:
        data = data[:, :, 0] if data.shape[2] == 1 \
            else data[:, data.shape[1] // 2, :]
    return np.abs(data[min(lateral_index, data.shape[0] - 1)])


def save_bmode_png(frame, path, plane: str = "xz", index: int = 0,
                   db_cutoff: float = -60.0, gamma: float = 1.0,
                   extent_mm=None, title: str | None = None):
    """Render a frame to a PNG via matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = bmode_image(frame, plane, index, db_cutoff, gamma)
    fig, ax = plt.subplots(figsize=(6, 6))
    kwargs = {}
    if extent_mm is not None:
        kwargs["extent"] = [extent_mm[0], extent_mm[1],
                            extent_mm[3], extent_mm[2]]
        kwargs["aspect"] = "auto"
    ax.imshow(img, cmap="gray", vmin=0, vmax=1, **kwargs)
    ax.set_xlabel("lateral" + (" [mm]" if extent_mm else " [voxel]"))
    ax.set_ylabel("axial" + (" [mm]" if extent_mm else " [voxel]"))
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


class LiveViewer:
    """Continuously updating display for streaming use (the analogue of the
    reference's FrameViewLive panel).  Pull-based: call ``update(frame)``
    from the acquisition loop."""

    def __init__(self, db_cutoff: float = -60.0, gamma: float = 1.0,
                 plane: str = "xz"):
        import matplotlib.pyplot as plt
        self._plt = plt
        self.db_cutoff = db_cutoff
        self.gamma = gamma
        self.plane = plane
        self._im = None
        self._fig = None

    def update(self, frame):
        img = bmode_image(frame, self.plane, 0, self.db_cutoff, self.gamma)
        if self._im is None:
            self._fig, ax = self._plt.subplots()
            self._im = ax.imshow(img, cmap="gray", vmin=0, vmax=1,
                                 aspect="auto")
            self._plt.ion()
            self._plt.show()
        else:
            self._im.set_data(img)
        self._fig.canvas.draw_idle()
        self._fig.canvas.flush_events()

    def close(self):
        if self._fig is not None:
            self._plt.close(self._fig)

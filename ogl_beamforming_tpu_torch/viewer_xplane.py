"""3D X-plane view: three orthogonal volume slices in an orbitable 3D
projection with raycast plane dragging.

The software port of the reference UI's signature 3D frame view
(ui.c:913-1068): three axis-aligned planes slice the beamformed volume; the
user orbits the view and grabs a plane to drag it along its normal.  Here
the projection is a small numpy orthographic rasterizer (painter via
z-buffer) and the drag hit-test uses :func:`..utils.transforms.obb_raycast`
— the same slab-method raycast the reference uses for its plane grab.

Volume convention: bmode volume ``v[nx, ny, nz]`` in [0, 1]; normalized
volume coordinates p in [-1, 1]^3 map to voxel (nx-1)*(p+1)/2 etc.
"""

from __future__ import annotations

import numpy as np

from .utils.transforms import obb_raycast
from .viewer import frame_to_bmode


def volume_bmode(frame, db_cutoff: float = -60.0,
                 gamma: float = 1.0) -> np.ndarray:
    """(nx, ny, nz) display volume in [0, 1]."""
    v = frame_to_bmode(frame, db_cutoff=db_cutoff, gamma=gamma)
    if v.ndim == 2:
        v = v[:, :, None]
    return v


def slice_volume(v: np.ndarray, axis: int, frac: float) -> np.ndarray:
    """2D slice at normalized position ``frac`` in [0, 1] along ``axis``."""
    n = v.shape[axis]
    i = int(round(np.clip(frac, 0.0, 1.0) * (n - 1)))
    img = np.take(v, i, axis=axis)
    return img.T     # display: last remaining axis down


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return rx @ ry


_PLANE_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}     # in-plane axes per normal


def _plane_frame(axis: int, offset: float):
    """(center, e_u, e_v) of the slicing plane in normalized volume coords;
    ``offset`` in [-1, 1] along the plane normal."""
    c = np.zeros(3, np.float32)
    c[axis] = offset
    ua, va = _PLANE_AXES[axis]
    e_u = np.zeros(3, np.float32)
    e_v = np.zeros(3, np.float32)
    e_u[ua] = 1.0
    e_v[va] = 1.0
    return c, e_u, e_v


def render_xplane(v: np.ndarray, offsets, yaw: float = 0.6,
                  pitch: float = 0.45, size: int = 512) -> np.ndarray:
    """Orthographic composite of the three slice planes with a z-buffer.

    ``offsets``: normalized plane positions in [-1, 1] per axis.
    Returns a (size, size) image in [0, 1]; plane edges are highlighted so
    the planes read as draggable objects (ui.c draws outlines the same way).
    """
    r = _rotation(yaw, pitch)
    scale = size / 4.0                    # volume spans [-1,1] -> size/2 px
    out = np.zeros((size, size), np.float32)
    zbuf = np.full((size, size), -np.inf, np.float32)
    ys, xs = np.mgrid[0:size, 0:size]
    sx = (xs - size / 2) / scale          # screen in volume units
    sy = (ys - size / 2) / scale

    nx, ny, nz = v.shape
    dims = np.array([nx, ny, nz], np.float32)
    for axis in range(3):
        c, e_u, e_v = _plane_frame(axis, float(offsets[axis]))
        pc, pu, pv = r @ c, r @ e_u, r @ e_v
        det = pu[0] * pv[1] - pu[1] * pv[0]
        if abs(det) < 1e-9:               # edge-on: skip
            continue
        inv = np.array([[pv[1], -pv[0]], [-pu[1], pu[0]]],
                       np.float32) / det
        u = inv[0, 0] * (sx - pc[0]) + inv[0, 1] * (sy - pc[1])
        w = inv[1, 0] * (sx - pc[0]) + inv[1, 1] * (sy - pc[1])
        inside = (np.abs(u) <= 1.0) & (np.abs(w) <= 1.0)
        depth = pc[2] + u * pu[2] + w * pv[2]
        vis = inside & (depth > zbuf)
        ua, va = _PLANE_AXES[axis]
        iu = np.clip(((u + 1) / 2 * (dims[ua] - 1)).astype(np.int32),
                     0, int(dims[ua]) - 1)
        iv = np.clip(((w + 1) / 2 * (dims[va] - 1)).astype(np.int32),
                     0, int(dims[va]) - 1)
        ip = int(round((float(offsets[axis]) + 1) / 2
                       * (dims[axis] - 1)))
        idx = [None, None, None]
        idx[axis] = np.full_like(iu, ip)
        idx[ua] = iu
        idx[va] = iv
        tex = v[idx[0], idx[1], idx[2]]
        edge = (np.abs(np.abs(u) - 1.0) < 2.0 / scale) | \
               (np.abs(np.abs(w) - 1.0) < 2.0 / scale)
        tex = np.where(edge & inside, 1.0, tex)
        out = np.where(vis, tex, out)
        zbuf = np.where(vis, depth, zbuf)
    return out


def _sample_volume(v: np.ndarray, p: np.ndarray,
                   trilinear: bool = True) -> np.ndarray:
    """Sample ``v`` at normalized coords ``p`` (..., 3) in [-1, 1]^3;
    outside the volume returns 0."""
    dims = np.asarray(v.shape, np.float32)
    inside = np.all(np.abs(p) <= 1.0, axis=-1)
    f = (np.clip(p, -1.0, 1.0) + 1.0) / 2.0 * (dims - 1)
    if not trilinear:
        i = np.round(f).astype(np.int32)
        out = v[i[..., 0], i[..., 1], i[..., 2]]
        return np.where(inside, out, 0.0)
    i0 = np.clip(np.floor(f).astype(np.int32), 0,
                 (dims - 2).astype(np.int32))
    t = f - i0
    out = np.zeros(p.shape[:-1], v.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (np.where(dx, t[..., 0], 1 - t[..., 0])
                     * np.where(dy, t[..., 1], 1 - t[..., 1])
                     * np.where(dz, t[..., 2], 1 - t[..., 2]))
                out = out + w * v[i0[..., 0] + dx, i0[..., 1] + dy,
                                  i0[..., 2] + dz]
    return np.where(inside, out, 0.0)


def oblique_slice(v: np.ndarray, center, normal, size: int = 256,
                  extent: float = 1.0, trilinear: bool = True) -> np.ndarray:
    """Arbitrary (non-axis-aligned) plane slice through the volume.

    ``center``: plane point in normalized volume coords [-1, 1]^3;
    ``normal``: plane normal (need not be unit).  Returns a (size, size)
    image sampling the plane over u, w in [-extent, extent] along an
    orthonormal in-plane basis (deterministic: e_u lies in the plane spanned
    with the least-aligned world axis).  Extends the reference's
    axis-aligned X-plane slicing (ui.c:913-1068) to oblique cuts.
    """
    c = np.asarray(center, np.float32)
    n = np.asarray(normal, np.float32)
    n = n / max(np.linalg.norm(n), 1e-12)
    a = np.zeros(3, np.float32)
    a[int(np.argmin(np.abs(n)))] = 1.0
    e_u = np.cross(n, a)
    e_u /= max(np.linalg.norm(e_u), 1e-12)
    e_v = np.cross(n, e_u)
    ws, us = np.mgrid[0:size, 0:size].astype(np.float32)
    u = (us / (size - 1) * 2 - 1) * extent
    w = (ws / (size - 1) * 2 - 1) * extent
    p = (c[None, None] + u[..., None] * e_u[None, None]
         + w[..., None] * e_v[None, None])
    return _sample_volume(v, p, trilinear=trilinear)


def render_mip(v: np.ndarray, yaw: float = 0.6, pitch: float = 0.45,
               size: int = 256, n_steps: int = 128) -> np.ndarray:
    """Maximum-intensity projection of the display volume along the
    orthographic view ray (the classic volume MIP; the reference's render
    samples a single plane per fragment — render_3d.frag.glsl:61-70 — MIP
    is the natural volume view the UI lacks).

    Marches ``n_steps`` samples per pixel through the rotated unit cube,
    keeping a running max (nearest-neighbor: MIP is max-dominated, so
    trilinear adds cost without changing the argmax ridge).
    """
    r = _rotation(yaw, pitch)
    rinv = r.T
    scale = size / 4.0
    ys, xs = np.mgrid[0:size, 0:size]
    sx = ((xs - size / 2) / scale).astype(np.float32)
    sy = ((ys - size / 2) / scale).astype(np.float32)
    out = np.zeros((size, size), np.float32)
    span = np.sqrt(3.0)
    for z in np.linspace(-span, span, n_steps, dtype=np.float32):
        p = np.stack([sx, sy, np.full_like(sx, z)], axis=-1) @ rinv.T
        out = np.maximum(out, _sample_volume(v, p, trilinear=False))
    return out


def pick_plane(offsets, yaw: float, pitch: float, px: float, py: float,
               size: int = 512):
    """Hit-test a click at pixel (px, py): which slice plane was grabbed?

    Builds the orthographic view ray, verifies it hits the volume OBB with
    :func:`obb_raycast` (math.c:667-711), then intersects the three slice
    planes and returns the frontmost hit as ``(axis, t)`` — or ``None``.
    """
    r = _rotation(yaw, pitch)
    scale = size / 4.0
    sx = (px - size / 2) / scale
    sy = (py - size / 2) / scale
    rinv = r.T
    origin = rinv @ np.array([sx, sy, 10.0], np.float32)
    direction = rinv @ np.array([0.0, 0.0, -1.0], np.float32)

    m = np.eye(4, dtype=np.float32)
    if obb_raycast(m, [1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                   origin, direction) < 0:
        return None

    best = None
    for axis in range(3):
        d = float(direction[axis])
        if abs(d) < 1e-9:
            continue
        t = (float(offsets[axis]) - float(origin[axis])) / d
        if t <= 0:
            continue
        p = origin + t * direction
        ua, va = _PLANE_AXES[axis]
        if abs(p[ua]) <= 1.0 and abs(p[va]) <= 1.0:
            if best is None or t < best[1]:
                best = (axis, t)
    return best


def drag_plane(offsets, axis: int, yaw: float, pitch: float,
               dx_px: float, dy_px: float, size: int = 512) -> float:
    """New offset for ``axis`` after a mouse drag of (dx, dy) pixels: the
    drag is projected onto the plane normal's screen direction (the
    reference moves the grabbed plane along its normal, ui.c:1040-1068)."""
    r = _rotation(yaw, pitch)
    scale = size / 4.0
    normal_screen = r[:2, axis]            # normal's screen-space direction
    nlen2 = float(normal_screen @ normal_screen)
    if nlen2 < 1e-12:
        return float(offsets[axis])
    delta = (dx_px * normal_screen[0] + dy_px * normal_screen[1]) \
        / (nlen2 * scale)
    return float(np.clip(float(offsets[axis]) + delta, -1.0, 1.0))

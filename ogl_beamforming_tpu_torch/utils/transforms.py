"""Voxel-grid transforms for DAS output regions.

Reference: math.c:799-920 (``das_transform_*``).  A voxel transform maps
normalized voxel coordinates ``p in [0,1]^3`` to world/XDC-space meters via
``world = M @ [p, 1]``.  Matrices are stored row-major ``(4, 4)`` (the
reference stores columns; values are identical).
"""

from __future__ import annotations

import numpy as np


def _dimension(points: np.ndarray) -> int:
    """Number of axes with more than one voxel (reference: math.c:158-165)."""
    return int(np.sum(np.asarray(points)[:3] > 1))


def das_output_dimension(points) -> np.ndarray:
    """Canonicalize an output-points request (reference: math.c:799-829).

    1D collapses onto x; 2D collapses onto (x, y) with z folded in.
    """
    p = np.maximum(np.asarray(points[:3], dtype=np.int64), 1).copy()
    dim = _dimension(p)
    if dim <= 1:
        if p[1] > 1:
            p[0] = p[1]
        if p[2] > 1:
            p[0] = p[2]
        p[1] = p[2] = 1
    elif dim == 2:
        if p[0] > 1:
            if p[2] > 1:
                p[1] = p[2]
        else:
            p[0] = p[2]
        p[2] = 1
    return p.astype(np.int32)


def das_transform_1d(p1, p2) -> np.ndarray:
    """Line from p1 to p2 (reference: math.c:831-842)."""
    p1 = np.asarray(p1, np.float32)
    extent = np.asarray(p2, np.float32) - p1
    m = np.zeros((4, 4), np.float32)
    m[:3, 0] = extent
    m[:3, 3] = p1
    m[3, 3] = 1.0
    return m


def das_transform_2d_with_normal(normal, min_coordinate, max_coordinate,
                                 offset: float) -> np.ndarray:
    """Plane with the given normal (reference: math.c:844-870)."""
    n = np.asarray(normal, np.float32)
    u = np.array([0, 1, 0], np.float32)
    if np.isclose(float(np.dot(u, n)), 1.0):
        u = np.array([1, 0, 0], np.float32)
    v = np.cross(u, n)

    mn = np.asarray(min_coordinate, np.float32)
    mx = np.asarray(max_coordinate, np.float32)
    lo = u * mn[0] + v * mn[1]
    hi = u * mx[0] + v * mx[1]
    extent = hi - lo
    uu = u * float(np.dot(u, extent))
    vv = v * float(np.dot(v, extent))
    t = n * np.float32(offset) + lo

    m = np.zeros((4, 4), np.float32)
    m[:3, 0] = uu
    m[:3, 1] = vv
    m[:3, 2] = n
    m[:3, 3] = t
    m[3, 3] = 1.0
    return m


def das_transform_2d_xz(min_coordinate, max_coordinate, y_off: float = 0.0):
    """Standard imaging plane: x lateral, z axial (reference: math.c:872-877)."""
    return das_transform_2d_with_normal([0, 1, 0], min_coordinate,
                                        max_coordinate, y_off)


def das_transform_2d_yz(min_coordinate, max_coordinate, x_off: float = 0.0):
    """Reference: math.c:879-885 (normal flipped so the region extends
    correctly)."""
    return das_transform_2d_with_normal([-1, 0, 0], min_coordinate,
                                        max_coordinate, x_off)


def das_transform_2d_xy(min_coordinate, max_coordinate, z_off: float = 0.0):
    """Reference: math.c:887-892."""
    return das_transform_2d_with_normal([0, 0, 1], min_coordinate,
                                        max_coordinate, z_off)


def das_transform_3d(min_coordinate, max_coordinate) -> np.ndarray:
    """Axis-aligned volume (reference: math.c:894-904)."""
    mn = np.asarray(min_coordinate, np.float32)
    mx = np.asarray(max_coordinate, np.float32)
    m = np.zeros((4, 4), np.float32)
    m[0, 0], m[1, 1], m[2, 2] = mx - mn
    m[:3, 3] = mn
    m[3, 3] = 1.0
    return m


def das_transform(min_coordinate, max_coordinate, points):
    """Pick the 1/2/3-D transform for an output request
    (reference: math.c:906-920).  Returns ``(transform, canonical_points)``.
    """
    p = das_output_dimension(points)
    dim = _dimension(p)
    mn = np.asarray(min_coordinate, np.float32)
    mx = np.asarray(max_coordinate, np.float32)
    if dim <= 1:
        m = das_transform_1d(mn, mx)
    elif dim == 2:
        m = das_transform_2d_xz(mn[[0, 2]], mx[[0, 2]], 0.0)
    else:
        m = das_transform_3d(mn, mx)
    return m, p


def voxel_world_points(voxel_transform: np.ndarray, points) -> np.ndarray:
    """World-space coordinates for every voxel of an output grid.

    Mirrors das.glsl:368-376: ``point = voxel / max(1, size - 1)`` then
    ``world = M @ [point, 1]``.  Returns shape ``(nx, ny, nz, 3)`` float32.
    """
    nx, ny, nz = (int(v) for v in np.asarray(points[:3]))
    denom = np.maximum(np.array([nx, ny, nz], np.float32) - 1.0, 1.0)
    xs = np.arange(nx, dtype=np.float32) / denom[0]
    ys = np.arange(ny, dtype=np.float32) / denom[1]
    zs = np.arange(nz, dtype=np.float32) / denom[2]
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    p = np.stack([gx, gy, gz, np.ones_like(gx)], axis=-1)
    world = np.einsum("ij,xyzj->xyzi", np.asarray(voxel_transform, np.float32), p)
    return world[..., :3].astype(np.float32)


def apply_m4(m: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to an ``(..., 3)`` array of points."""
    p = np.asarray(points, np.float32)
    return (p @ np.asarray(m, np.float32)[:3, :3].T) + np.asarray(m, np.float32)[:3, 3]


def plane_normal_from_transform(transform: np.ndarray) -> np.ndarray:
    """Reference: math.c:922-929."""
    m = np.asarray(transform, np.float32)
    u = m[:3, 0] / np.linalg.norm(m[:3, 0])
    v = m[:3, 1] / np.linalg.norm(m[:3, 1])
    return np.cross(v, u).astype(np.float32)


def plane_offset_from_transform(transform: np.ndarray) -> float:
    """Reference: math.c:931-936."""
    m = np.asarray(transform, np.float32)
    return float(np.dot(plane_normal_from_transform(m), m[:3, 3]))


def plane_corners_from_transform(transform: np.ndarray):
    """(min_uv, max_uv) of the plane patch (reference: math.c:938-949)."""
    m = np.asarray(transform, np.float32)
    u = m[:3, 0] / np.linalg.norm(m[:3, 0])
    v = m[:3, 1] / np.linalg.norm(m[:3, 1])
    lo = apply_m4(m, np.zeros(3, np.float32))
    hi = apply_m4(m, np.ones(3, np.float32))
    return (np.array([np.dot(u, lo), np.dot(v, lo)], np.float32),
            np.array([np.dot(u, hi), np.dot(v, hi)], np.float32))


def plane_uv(point, u, v) -> np.ndarray:
    """Reference: math.c:951-958."""
    p = np.asarray(point, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    return np.array([np.dot(u, p) / np.dot(u, u),
                     np.dot(v, p) / np.dot(v, v)], np.float32)


def obb_raycast(obb_orientation: np.ndarray, obb_size, obb_center,
                ray_origin, ray_direction) -> float:
    """Ray vs oriented bounding box; returns hit distance or -1.

    Reference: math.c:667-711 (slab method) — used for the 3D X-plane view
    drag interactions; exposed here for viewer tooling.
    """
    m = np.asarray(obb_orientation, np.float32)
    size = np.asarray(obb_size, np.float32)
    p = np.asarray(obb_center, np.float32) - np.asarray(ray_origin,
                                                        np.float32)
    d = np.asarray(ray_direction, np.float32)
    axes = [m[:3, 0], m[:3, 1], m[:3, 2]]
    eps = np.finfo(np.float32).eps
    t = np.zeros(6, np.float32)
    for i, ax in enumerate(axes):
        f = float(np.dot(ax, d))
        e = float(np.dot(ax, p))
        if abs(f) < 1e-12:
            if -e - size[i] > 0 or -e + size[i] < 0:
                return -1.0
            f = eps
        t[2 * i] = (e + size[i]) / f
        t[2 * i + 1] = (e - size[i]) / f
    tmin = max(min(t[0], t[1]), min(t[2], t[3]), min(t[4], t[5]))
    tmax = min(max(t[0], t[1]), max(t[2], t[3]), max(t[4], t[5]))
    if tmax >= 0 and tmin <= tmax:
        return float(tmin if tmin > 0 else tmax)
    return -1.0

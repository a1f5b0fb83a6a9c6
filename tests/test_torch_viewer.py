"""The port's viewers (ogl_beamforming_tpu_torch.viewer, viewer_xplane)
against the JAX package's, mirroring tests/test_viewer.py and the X-plane
cases of tests/test_viewer_web.py: the copies equal to their originals up
to the named import lines (and the web viewer's lines that name its
package); ``frame_to_bmode``, ``bmode_image`` and
``a_scan`` of a port frame (a torch tensor) equal to the JAX viewer's of
the same data to 1e-6; ``save_bmode_png`` (matplotlib); the X-plane
renderers, slicers and the plane grab and drag equal to the JAX package's.
"""

import difflib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ogl_beamforming_tpu import viewer as jax_viewer  # noqa: E402
from ogl_beamforming_tpu import viewer_web as jax_viewer_web  # noqa: E402
from ogl_beamforming_tpu import viewer_xplane as jax_xplane  # noqa: E402
from ogl_beamforming_tpu.pipeline.executor import Frame as JaxFrame  # noqa: E402
from ogl_beamforming_tpu_torch import viewer, viewer_web, viewer_xplane  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.executor import Frame  # noqa: E402

# the lines of the web viewer that name its package: the usage line and the
# pages' titles
NAMING = ["    from {}.viewer_web import LiveView",
          "<html><head><title>{}</title>",
          '<h3>{} &mdash; live view (<a href="/xplane" style="color:#6af">'
          '3D x-plane</a> | <a href="/panels" style="color:#6af">panels</a>)'
          '</h3>',
          "<html><head><title>{} x-plane</title>",
          "<html><head><title>{} panels</title>"]

# the only lines in which a port viewer differs from its original
CHANGED = {
    viewer: ["from .utils.transfer import to_host",
             "from .utils.device import to_host"],
    viewer_web: ["        from .utils.transfer import to_host",
                 "        from .utils.device import to_host"]
    + [line.format(pkg) for line in NAMING
       for pkg in ("ogl_beamforming_tpu", "ogl_beamforming_tpu_torch")],
    viewer_xplane: [],
}
ORIGINAL = {viewer: jax_viewer, viewer_web: jax_viewer_web,
            viewer_xplane: jax_xplane}


@pytest.mark.parametrize("module", list(CHANGED),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_viewers_are_copies(module):
    with open(module.__file__) as f:
        ours = f.read().splitlines()
    with open(ORIGINAL[module].__file__) as f:
        theirs = f.read().splitlines()
    changed = [line[1:] for line in difflib.unified_diff(theirs, ours,
                                                         lineterm="", n=0)
               if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    old, new = CHANGED[module][:1], CHANGED[module][1:]
    assert sorted(changed) == sorted(old + new)


def _volumes():
    rng = np.random.default_rng(0x0621)
    v2 = np.zeros((64, 128, 1), np.complex64)
    v2[30:34, 60:68, 0] = 3.0 + 1j
    v2 += (rng.standard_normal(v2.shape) * 1e-3).astype(np.complex64)
    v3 = rng.standard_normal((16, 24, 32)).astype(np.float32) * 1e-2
    v3[8, 12, 20] = 1.0
    return {"2d_complex": v2, "3d_real": v3}


def _frames(name):
    v = _volumes()[name]
    return (Frame(data=torch.from_numpy(v), id=0),
            JaxFrame(data=jnp.asarray(v), id=0))


@pytest.mark.parametrize("gamma", [1.0, 1.6])
@pytest.mark.parametrize("name", ["2d_complex", "3d_real"])
def test_frame_to_bmode_matches_jax(name, gamma):
    ours, ref = _frames(name)
    a = viewer.frame_to_bmode(ours, db_cutoff=-40, gamma=gamma)
    b = jax_viewer.frame_to_bmode(ref, db_cutoff=-40, gamma=gamma)
    assert isinstance(a, np.ndarray) and a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("plane,index", [("xz", 0), ("xz", 12), ("yz", 8),
                                         ("xy", 20)])
@pytest.mark.parametrize("name", ["2d_complex", "3d_real"])
def test_bmode_image_matches_jax(name, plane, index):
    ours, ref = _frames(name)
    a = viewer.bmode_image(ours, plane, index, db_cutoff=-50)
    b = jax_viewer.bmode_image(ref, plane, index, db_cutoff=-50)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_bmode_image_peak_and_shape():
    """tests/test_viewer.py's checks on the port's frame."""
    ours, _ = _frames("2d_complex")
    img = viewer.bmode_image(ours, db_cutoff=-40)
    assert img.shape == (128, 64)
    assert img.min() >= 0 and img.max() == pytest.approx(1.0, abs=1e-5)
    iz, ix = np.unravel_index(img.argmax(), img.shape)
    assert 60 <= iz < 68 and 30 <= ix < 34
    with pytest.raises(ValueError):
        viewer.bmode_image(ours, plane="zz")


@pytest.mark.parametrize("lateral", [0, 31, 999])
@pytest.mark.parametrize("name", ["2d_complex", "3d_real"])
def test_a_scan_matches_jax(name, lateral):
    ours, ref = _frames(name)
    a = viewer.a_scan(ours, lateral_index=lateral)
    b = jax_viewer.a_scan(ref, lateral_index=lateral)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_viewer_takes_a_bare_tensor():
    v = _volumes()["3d_real"]
    np.testing.assert_allclose(viewer.frame_to_bmode(torch.from_numpy(v)),
                               jax_viewer.frame_to_bmode(jnp.asarray(v)),
                               atol=1e-6)


def test_save_bmode_png(tmp_path):
    ours, _ = _frames("2d_complex")
    p = viewer.save_bmode_png(ours, tmp_path / "f.png", db_cutoff=-40,
                              extent_mm=[0, 19, 2, 16], title="t")
    assert p.exists() and p.stat().st_size > 1000
    assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _render_volume():
    rng = np.random.default_rng(0)
    return rng.random((16, 12, 20)).astype(np.float32)


@pytest.mark.parametrize("yaw,pitch", [(0.6, 0.45), (0.0, 0.0),
                                       (2.1, -0.3)])
def test_render_xplane_and_mip_match_jax(yaw, pitch):
    v = _render_volume()
    offsets = [0.2, -0.3, 0.0]
    np.testing.assert_allclose(
        viewer_xplane.render_xplane(v, offsets, yaw=yaw, pitch=pitch,
                                    size=96),
        jax_xplane.render_xplane(v, offsets, yaw=yaw, pitch=pitch, size=96),
        atol=1e-6)
    np.testing.assert_allclose(
        viewer_xplane.render_mip(v, yaw=yaw, pitch=pitch, size=64),
        jax_xplane.render_mip(v, yaw=yaw, pitch=pitch, size=64), atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_slices_match_jax(axis):
    v = _render_volume()
    np.testing.assert_array_equal(viewer_xplane.slice_volume(v, axis, 0.3),
                                  jax_xplane.slice_volume(v, axis, 0.3))
    normal = np.eye(3)[axis] + 0.5
    np.testing.assert_allclose(
        viewer_xplane.oblique_slice(v, [0.1, 0.0, -0.2], normal, size=48),
        jax_xplane.oblique_slice(v, [0.1, 0.0, -0.2], normal, size=48),
        atol=1e-6)


def test_volume_bmode_matches_jax():
    ours, ref = _frames("3d_real")
    np.testing.assert_allclose(viewer_xplane.volume_bmode(ours, -40, 1.2),
                               jax_xplane.volume_bmode(ref, -40, 1.2),
                               atol=1e-6)
    ours, ref = _frames("2d_complex")
    assert viewer_xplane.volume_bmode(ours).shape == (64, 128, 1)


@pytest.mark.parametrize("x,y", [(64, 64), (1, 1), (40, 90), (100, 30)])
def test_pick_and_drag_match_jax(x, y):
    offsets = [0.0, 0.25, -0.5]
    hit = viewer_xplane.pick_plane(offsets, 0.6, 0.45, x, y, size=128)
    assert hit == jax_xplane.pick_plane(offsets, 0.6, 0.45, x, y, size=128)
    for axis in range(3):
        assert viewer_xplane.drag_plane(offsets, axis, 0.6, 0.45, 30.0,
                                        -12.0, size=128) == pytest.approx(
            jax_xplane.drag_plane(offsets, axis, 0.6, 0.45, 30.0, -12.0,
                                  size=128), abs=1e-6)

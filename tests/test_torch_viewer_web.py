"""The port's live web viewer (ogl_beamforming_tpu_torch.viewer_web) over the
port's ``Beamformer(device="cpu")``, its endpoints served over real HTTP on
port 0: tests/test_viewer_web.py mirrored, the frame PNG decoded back to the
pixels of ``viewer.bmode_image`` of the last frame, and the
``live_streaming`` example's session streaming into a ``LiveView`` (stats
rows, the frame served, StopImaging reaching the session).  Every request
waits at most ``TIMEOUT`` seconds and every thread is joined with one.
"""

import json
import struct
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ogl_beamforming_tpu_torch.examples import live_streaming  # noqa: E402
from ogl_beamforming_tpu_torch.params.enums import (  # noqa: E402
    AcquisitionKind, DataKind, InterpolationMode, LiveImagingDirtyFlags,
    ShaderKind)
from ogl_beamforming_tpu_torch.params.types import Parameters  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer  # noqa: E402
from ogl_beamforming_tpu_torch.runtime.streaming import (  # noqa: E402
    StreamingSession)
from ogl_beamforming_tpu_torch.utils.transforms import (  # noqa: E402
    das_transform_2d_xz)
from ogl_beamforming_tpu_torch.viewer import a_scan, bmode_image  # noqa: E402
from ogl_beamforming_tpu_torch.viewer_web import (  # noqa: E402
    LiveView, encode_png_gray)

torch.set_num_threads(1)

TIMEOUT = 10


def decode_png_gray(png: bytes) -> np.ndarray:
    """The 8-bit grayscale image of a PNG written by ``encode_png_gray``
    (filter type 0 on every row)."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, shape = 8, b"", None
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 0)
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], shape[1] + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


def _as_png_pixels(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def view():
    """One view for the module's endpoint tests (each stop waits up to
    the server's half-second poll); a test that edits the block's
    parameters or live controls reads back only what it edited."""
    rng = np.random.default_rng(0x0621)
    pitch = 0.3e-3
    p = Parameters(
        sample_count=256, channel_count=8, acquisition_count=4,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [7 * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    bf = Beamformer(device="cpu")
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    bf.push_data_with_compute(
        rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16))
    v = LiveView(bf, port=0).start()
    yield v
    thread = v._thread
    v.stop()
    thread.join(TIMEOUT)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _post(url, body):
    req = urllib.request.Request(url, method="POST",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_png_encoder_round_trip():
    img = np.linspace(0, 1, 64 * 32).reshape(64, 32)
    png = encode_png_gray(img)
    assert png.startswith(b"\x89PNG")
    assert b"IHDR" in png and b"IEND" in png
    np.testing.assert_array_equal(decode_png_gray(png), _as_png_pixels(img))


def test_index_page(view):
    status, ctype, body = _get(view.url)
    assert status == 200 and ctype == "text/html"
    assert b"live view" in body


def test_frame_endpoint_is_bmode_image_of_the_last_frame(view):
    status, ctype, body = _get(view.url + "frame.png?db=-50&gamma=1.2")
    assert status == 200 and ctype == "image/png"
    frame = view.beamformer.get_last_frames(1)[-1]
    expect = bmode_image(frame, db_cutoff=-50, gamma=1.2)
    np.testing.assert_array_equal(decode_png_gray(body),
                                  _as_png_pixels(expect))


def test_stats_endpoint(view):
    status, _, body = _get(view.url + "stats.json")
    st = json.loads(body)
    names = [s["name"] for s in st["stages"]]
    assert names == ["Decode", "DAS"]
    assert st["frame_ms"] > 0


def test_live_controls(view):
    out = _post(view.url + "live", {"transmit_power": 0.7})
    assert out["ok"]
    assert view.beamformer.live_parameters.transmit_power == \
        pytest.approx(0.7)
    flags = view.beamformer.live_parameters_get_dirty_flag()
    assert flags & int(LiveImagingDirtyFlags.TransmitPower)
    _, _, body = _get(view.url + "live")
    assert json.loads(body)["transmit_power"] == pytest.approx(0.7)


def test_xplane_endpoints(view):
    base = view.url.rstrip("/")
    for path in ("/xplane.png?size=64", "/slice.png?axis=2&frac=0.5",
                 "/mip.png?size=48", "/oblique.png?nx=1&ny=1&nz=0.5&size=48"):
        status, ctype, png = _get(base + path)
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n", path
    _, _, page = _get(base + "/xplane")
    assert b"x-plane" in page
    res = _post(base + "/pick", {"offsets": [0, 0, 0], "yaw": 0.6,
                                 "pitch": 0.45, "x": 256, "y": 256})
    assert "axis" in res
    res = _post(base + "/drag", {"offsets": [0, 0, 0], "axis": 0,
                                 "yaw": 0.6, "pitch": 0.45, "dx": 20,
                                 "dy": 0})
    assert len(res["offsets"]) == 3


def test_params_live_edit(view):
    base = view.url.rstrip("/")
    _, _, body = _get(base + "/params")
    assert json.loads(body)["f_number"] == pytest.approx(0.8)
    after = _post(base + "/params", {"f_number": 1.25})
    assert after["f_number"] == pytest.approx(1.25)
    b = view.beamformer._block(0)
    assert b.parameters.f_number == pytest.approx(1.25)
    assert b.dirty


def test_panels_page(view):
    _, _, page = _get(view.url + "panels")
    for marker in ("splitLeaf", "closeTab", "tabbar", "divider",
                   "Compute Stats", "X-Plane", "Parameters"):
        assert marker.encode() in page


@pytest.mark.parametrize("path", ["frame.png?db=nan-garbage",
                                  "mip.png?size=abc", "oblique.png?nx=zz"])
def test_bad_request_returns_400(view, path):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(view.url + path)
    assert ei.value.code == 400


def test_size_clamped(view):
    status, _, body = _get(view.url + "mip.png?size=0")
    assert status == 200 and body.startswith(b"\x89PNG")
    status, _, body = _get(view.url + "oblique.png?size=99999")
    assert status == 200 and body.startswith(b"\x89PNG")


def test_frame_zoom_region(view):
    _, _, full = _get(view.url + "frame.png?out=128")
    _, _, zoom = _get(view.url +
                      "frame.png?x0=0.25&y0=0.25&x1=0.75&y1=0.75&out=128")
    assert decode_png_gray(full).shape == (128, 96)
    assert full != zoom


def test_frame_meta_rulers(view):
    _, _, body = _get(view.url + "frame_meta.json")
    meta = json.loads(body)
    np.testing.assert_allclose(meta["lat_mm"], [0.0, 7 * 0.3], atol=1e-6)
    np.testing.assert_allclose(meta["ax_mm"], [1.0, 8.0], atol=1e-6)
    assert meta["shape"] == [16, 12]


def test_ascan_endpoint_matches_viewer(view):
    _, _, body = _get(view.url + "ascan.json?frac=0.5")
    a = json.loads(body)
    frame = view.beamformer.get_last_frames(1)[-1]
    expect = a_scan(frame, a["lateral_index"])
    np.testing.assert_allclose(np.asarray(a["values"]) * a["peak"], expect,
                               rtol=1e-5)
    assert a["ax_mm"][0] == pytest.approx(1.0)
    assert a["ax_mm"][-1] == pytest.approx(8.0)


def test_empty_view_serves_placeholders():
    bf = Beamformer(device="cpu")
    v = LiveView(bf, port=0).start()
    try:
        _, _, png = _get(v.url + "frame.png")
        assert decode_png_gray(png).shape == (16, 16)
        _, _, body = _get(v.url + "ascan.json")
        assert json.loads(body) == {"values": [], "ax_mm": []}
    finally:
        v.stop()


def test_live_streaming_example_into_a_live_view():
    """The example's session on the CPU: 4 orbiting-target frames stream
    into a LiveView, the served frame is the last one's B-mode, the stats
    hold 4 rows, and a StopImaging POST shows in the dirty flag and stops
    the session."""
    bf = live_streaming.configure("cpu")
    view = LiveView(bf, port=0).start()
    try:
        lines = []
        with StreamingSession(bf, depth=2) as session:
            handle = live_streaming.stream(bf, session, 4, out=lines.append)
            last = handle.result(timeout=TIMEOUT)
            session.drain(timeout=TIMEOUT)
            assert last.id == 3
            _, _, png = _get(view.url + "frame.png")
            np.testing.assert_array_equal(
                decode_png_gray(png), _as_png_pixels(bmode_image(last)))
            _, _, body = _get(view.url + "stats.json")
            assert json.loads(body)["frame_ms"] > 0
            assert bf.stats._frame_index == 4
            assert _post(view.url + "live", {"stop": True})["ok"]
            assert bf.live_parameters_get_dirty_flag() \
                & LiveImagingDirtyFlags.StopImaging
            dropped = session.submit(live_streaming.frame_for_target(
                live_streaming.orbit_target(4)))
            assert dropped.result(timeout=TIMEOUT) is None
            assert session.stop_requested
    finally:
        view.stop()

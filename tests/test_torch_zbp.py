"""The port's ``.zbp`` loader (ogl_beamforming_tpu_torch.utils.zbp) against
the JAX package's: the module is a byte-for-byte copy; files written by the
port's writers (V1, V2 raw and zstd-compressed, for every acquisition-
parameter block and both emission descriptors) read back by both packages'
loaders field for field and bit for bit; the committed fixture
``tests/data/point_targets.zbp`` read by both; ``from_zbp`` of it equal to
the JAX package's; a compressed payload without ``zstandard`` raising in
both.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ogl_beamforming_tpu.models import presets as jax_presets  # noqa: E402
from ogl_beamforming_tpu.utils import zbp as jax_zbp  # noqa: E402
from ogl_beamforming_tpu_torch.models import presets  # noqa: E402
from ogl_beamforming_tpu_torch.params.enums import (  # noqa: E402
    AcquisitionKind, DataKind, DecodeMode)
from ogl_beamforming_tpu_torch.utils import zbp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "point_targets.zbp")
C, A, S = 8, 4, 64


def test_zbp_is_a_byte_copy():
    with open(zbp.__file__, "rb") as a, open(jax_zbp.__file__, "rb") as b:
        assert a.read() == b.read()


def _file(kind, emission, data_kind=DataKind.Int16) -> zbp.ZbpFile:
    """A small acquisition of ``kind`` with every table its V2 block
    carries; ``emission`` None, "sine" or "chirp"."""
    rng = np.random.default_rng(int(kind) * 7 + len(emission or ""))
    dtype, elements = zbp._DATA_DTYPES[int(data_kind)]
    xform = np.eye(4, dtype=np.float32)
    xform[0, 3], xform[2, 1] = 1.5e-3, 0.25
    z = zbp.ZbpFile(
        version=(2, 0), raw_data_dimension=(A * S * elements, C, 1, 1),
        data_kind=data_kind, decode_mode=DecodeMode.Hadamard,
        sampling_mode=1, sampling_frequency=40e6,
        demodulation_frequency=7.8e6, speed_of_sound=1540.0,
        sample_count=S, channel_count=C, receive_event_count=A,
        xdc_transform=xform,
        xdc_element_pitch=np.array([3e-4, 2.5e-4], np.float32),
        time_offset=1.25e-6, acquisition_kind=kind,
        channel_mapping=rng.permutation(C).astype(np.int16),
        data=(rng.standard_normal(C * A * S * elements) * 900).astype(dtype))
    if kind in (AcquisitionKind.FORCES, AcquisitionKind.UFORCES,
                AcquisitionKind.HERCULES, AcquisitionKind.UHERCULES):
        z.transmit_focus = zbp.RCATransmitFocus(6e-3, 2.5, 1e-4, 17)
    if kind in (AcquisitionKind.UFORCES, AcquisitionKind.UHERCULES):
        z.sparse_elements = rng.permutation(C)[:A].astype(np.int16)
    if kind in (AcquisitionKind.RCA_TPW, AcquisitionKind.RCA_VLS):
        z.transmit_receive_orientations = rng.integers(0, 3, A).astype(
            np.uint8)
        if kind == AcquisitionKind.RCA_TPW:
            z.steering_angles = np.linspace(-9, 9, A).astype(np.float32)
            z.focal_depths = np.full(A, np.inf, np.float32)
        else:
            z.focal_depths = np.linspace(-3e-3, -1e-3, A).astype(np.float32)
            z.steering_angles = np.zeros(A, np.float32)
    if emission == "sine":
        z.emissions = [{"kind": 0, "cycles": np.float32(2.5),
                        "frequency": np.float32(7.8e6)}]
    elif emission == "chirp":
        z.emissions = [{"kind": 1, "duration": np.float32(2e-6),
                        "min_frequency": np.float32(1e6),
                        "max_frequency": np.float32(4e6)}]
    return z


def _assert_same(got, want):
    """Every field equal, arrays and floats bit for bit."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert g is not None and w is not None, f.name
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            assert g.tobytes() == w.tobytes(), f.name
        elif f.name == "transmit_focus":
            assert [np.float32(v) for v in dataclasses.astuple(g)] == \
                [np.float32(v) for v in dataclasses.astuple(w)], f.name
        elif f.name == "emissions":
            assert [{k: np.float32(v) for k, v in e.items()} for e in g] \
                == [{k: np.float32(v) for k, v in e.items()} for e in w]
        elif isinstance(w, float):
            assert np.float32(g) == np.float32(w), f.name
        else:
            assert int(g) == int(w) if isinstance(w, int) else g == w, f.name


V2_KINDS = [AcquisitionKind.FORCES, AcquisitionKind.UFORCES,
            AcquisitionKind.HERCULES, AcquisitionKind.UHERCULES,
            AcquisitionKind.RCA_TPW, AcquisitionKind.RCA_VLS,
            AcquisitionKind.Flash]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("emission", [None, "sine", "chirp"])
@pytest.mark.parametrize("kind", V2_KINDS, ids=lambda k: k.name)
def test_v2_round_trip_in_both_loaders(tmp_path, kind, emission, compress):
    z = _file(kind, emission)
    path = tmp_path / "a.zbp"
    zbp.save_zbp_v2(path, z, compress=compress)
    port, ref = zbp.load_zbp(path), jax_zbp.load_zbp(path)
    _assert_same(port, z)
    _assert_same(ref, port)
    # the JAX writer writes the same bytes
    jax_path = tmp_path / "b.zbp"
    jax_zbp.save_zbp_v2(jax_path, z, compress=compress)
    assert path.read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("data_kind", list(DataKind), ids=lambda k: k.name)
def test_v2_data_kinds_round_trip(tmp_path, data_kind):
    z = _file(AcquisitionKind.FORCES, None, data_kind)
    zbp.save_zbp_v2(tmp_path / "a.zbp", z, compress=False)
    port = zbp.load_zbp(tmp_path / "a.zbp")
    _assert_same(port, z)
    _assert_same(jax_zbp.load_zbp(tmp_path / "a.zbp"), port)


@pytest.mark.parametrize("kind", [AcquisitionKind.FORCES,
                                  AcquisitionKind.UFORCES,
                                  AcquisitionKind.RCA_VLS],
                         ids=lambda k: k.name)
def test_v1_round_trip_in_both_loaders(tmp_path, kind):
    """V1 carries fixed 256-entry tables and no emission or focus block:
    what comes back is the file's fields with its tables zero-padded."""
    z = _file(kind, None)
    zbp.save_zbp_v1(tmp_path / "a.zbp", z)
    port, ref = (zbp.load_zbp(tmp_path / "a.zbp"),
                 jax_zbp.load_zbp(tmp_path / "a.zbp"))
    want = dataclasses.replace(
        z, version=(1, 1), data_kind=DataKind.Int16, sampling_mode=0,
        transmit_focus=zbp.RCATransmitFocus(), emissions=[],
        transmit_receive_orientations=None)
    for name, dt in (("channel_mapping", np.int16),
                     ("steering_angles", np.float32),
                     ("focal_depths", np.float32),
                     ("sparse_elements", np.int16)):
        table = np.zeros(256, dt)
        src = getattr(z, name)
        if src is not None:
            table[:len(src)] = src
        setattr(want, name, table)
    _assert_same(port, want)
    _assert_same(ref, port)


def test_fixture_loads_equal_in_both():
    port, ref = zbp.load_zbp(FIXTURE), jax_zbp.load_zbp(FIXTURE)
    _assert_same(port, ref)
    assert port.data.shape == (32 * 16 * 1024,)


def _assert_fields_equal(ours, ref, path=""):
    """Two values of the two packages' parameter types are equal field by
    field: arrays by dtype and value, enums as ints."""
    if dataclasses.is_dataclass(ref):
        assert type(ours).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ref):
            _assert_fields_equal(getattr(ours, f.name), getattr(ref, f.name),
                                 f"{path}.{f.name}")
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert type(ours).__name__ == type(ref).__name__, path
        assert ours == ref, path


@pytest.mark.parametrize("grid", [{}, dict(output_points=(128, 256),
                                           lateral_mm=(0.0, 9.3),
                                           axial_mm=(2.0, 16.0))],
                         ids=["throughput_grid", "fixture_grid"])
def test_from_zbp_equals_the_jax_package(grid):
    p, pipe = presets.from_zbp(zbp.load_zbp(FIXTURE), **grid)
    jp, jpipe = jax_presets.from_zbp(jax_zbp.load_zbp(FIXTURE), **grid)
    _assert_fields_equal(p, jp, "parameters")
    assert [int(s) for s in pipe.shaders] == [int(s) for s in jpipe.shaders]
    assert int(pipe.data_kind) == int(jpipe.data_kind)


@pytest.mark.parametrize("loader", ["port", "jax"])
def test_compressed_payload_without_zstandard_raises(monkeypatch, loader):
    """A compressed payload needs ``zstandard``: without it the loader
    raises, it neither decodes nor skips the payload."""
    monkeypatch.setitem(sys.modules, "zstandard", None)
    load = zbp.load_zbp if loader == "port" else jax_zbp.load_zbp
    with pytest.raises(ImportError):
        load(FIXTURE)

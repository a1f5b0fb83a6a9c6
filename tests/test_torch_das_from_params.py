"""The port's ``ops.das.das_from_params`` (the golden ``das(rf, params)``
API) on the CPU, for every DAS family, real and IQ, against the JAX
package's ``das_from_params`` (XLA, NRMSE <= 1e-4) and golden (<= 1e-3) on
a small grid: a numpy ``rf`` goes to the device asked for, a tensor stays
where it is, and the GPU is the default.  The twin in blocks of
``voxel_block`` voxels is its one block bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import das as jax_das  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, InterpolationMode, RCAOrientation,
    pack_tx_rx_orientation)
from ogl_beamforming_tpu.utils.hadamard import hadamard  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import (  # noqa: E402
    das_transform_2d_xz, das_transform_3d)
from ogl_beamforming_tpu_torch.ops import das  # noqa: E402

torch.set_num_threads(1)

C, S, PITCH = 8, 256, 0.3e-3
FAMILIES = ["forces", "uforces", "readi", "flash", "tpw", "vls", "hercules",
            "uhercules"]


def _params(family) -> golden.DasParams:
    a, kind, kw = 4, AcquisitionKind.FORCES, {}
    ap = (C - 1) * PITCH
    vt = das_transform_2d_xz([0, 1e-3], [ap, 8e-3])
    points = (12, 16, 1)
    cols = pack_tx_rx_orientation(RCAOrientation.Columns,
                                  RCAOrientation.Columns)
    rows = pack_tx_rx_orientation(RCAOrientation.Rows, RCAOrientation.Rows)
    sparse = dict(sparse=True,
                  sparse_elements=np.array([0, 2, 4, 6, 7], np.int16))
    if family == "uforces":
        a, kind, kw = 5, AcquisitionKind.UFORCES, sparse
    elif family == "readi":
        kw = dict(readi_group_count=2, readi_group=1,
                  das_hadamard=hadamard(2).T)
    elif family == "flash":
        a, kind = 1, AcquisitionKind.Flash
        kw = dict(transmit_receive_orientation=cols)
    elif family in ("tpw", "vls"):
        a = 3
        kind = (AcquisitionKind.RCA_TPW if family == "tpw"
                else AcquisitionKind.RCA_VLS)
        depth = np.float32(np.inf if family == "tpw" else -2e-3)
        kw = dict(single_focus=False, single_orientation=False,
                  focal_vectors=np.stack(
                      [np.array([-8.0, 0.0, 11.0], np.float32),
                       np.full(3, depth)], axis=-1),
                  transmit_receive_orientations=np.array([cols, rows, cols],
                                                         np.uint8))
    elif family in ("hercules", "uhercules"):
        kind = AcquisitionKind.HERCULES
        if family == "uhercules":
            a, kind, kw = 5, AcquisitionKind.UHERCULES, dict(sparse)
        vt = das_transform_3d([0, 0, 1e-3], [ap, ap, 8e-3])
        points = (6, 5, 7)
        kw.update(transmit_receive_orientation=pack_tx_rx_orientation(
            RCAOrientation.Rows, RCAOrientation.Columns), transmit_angle=3.0,
            focus_depth=6e-3)
    return golden.DasParams(
        acquisition_kind=kind, acquisition_count=a, channel_count=C,
        sample_count=S, sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        voxel_transform=vt,
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=points, interpolation_mode=InterpolationMode.Cubic,
        **kw)


def _rf(p, iq):
    rng = np.random.default_rng(0x0621 + p.acquisition_count + 2 * iq)
    rf = rng.standard_normal((C, p.acquisition_count, S)).astype(np.float32)
    if iq:
        rf = (rf + 1j * rng.standard_normal(rf.shape)).astype(np.complex64)
    return rf


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
@pytest.mark.parametrize("family", FAMILIES)
def test_das_from_params_matches_jax_and_golden(family, iq):
    p = _params(family)
    rf = _rf(p, iq)
    out = das.das_from_params(rf, p, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    out = out.numpy()
    ref = np.asarray(jax_das.das_from_params(rf, p))
    assert out.shape == ref.shape == tuple(p.output_points)
    assert out.dtype == (np.complex64 if iq else np.float32)
    assert np.abs(ref).max() > 0
    assert nrmse(ref, out) <= 1e-4
    assert nrmse(golden.das(rf, p), out) <= 1e-3


def test_das_from_params_keeps_a_tensor_where_it_is():
    p = _params("forces")
    rf = _rf(p, False)
    out = das.das_from_params(torch.from_numpy(rf), p)   # no device: stays
    np.testing.assert_array_equal(
        out.numpy(), das.das_from_params(rf, p, device="cpu").numpy())


def test_das_from_params_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    p = _params("forces")
    with pytest.raises(RuntimeError, match="cuda"):
        das.das_from_params(_rf(p, False), p)


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
@pytest.mark.parametrize("family", ["forces", "hercules", "flash"])
def test_voxel_blocks_are_one_block_bit_for_bit(family, iq):
    """The twin in blocks of 128 voxels (of a grid of 192 or 210) is its
    one block of the whole grid bit for bit, and within the DAS bound of
    the JAX package's ``das_from_params(..., voxel_block=128)``."""
    p = _params(family)
    rf = _rf(p, iq)
    out = das.das_from_params(rf, p, voxel_block=128, device="cpu")
    whole = das.das_from_params(rf, p, voxel_block=1 << 20, device="cpu")
    assert int(np.prod(p.output_points)) > 128
    np.testing.assert_array_equal(out.numpy(), whole.numpy())
    ref = np.asarray(jax_das.das_from_params(rf, p, voxel_block=128))
    assert np.abs(ref).max() > 0
    assert nrmse(ref, out.numpy()) <= 1e-4

"""Port DAS (ogl_beamforming_tpu_torch.ops.das, plain twin on the CPU) vs the
JAX package's DAS and the golden oracle, on the same numpy-seeded RF.

Tolerances (NRMSE):
  * vs JAX ``ops.das.das`` (the same f32 formula through XLA): 1e-4.
    Transcendentals and summation order alone put JAX's own XLA DAS
    1e-7..2.3e-5 from golden at these shapes.
  * vs JAX ``das_pallas(..., interpret=True)``: 2e-4.  The Pallas kernel
    quantises each RF line to int16 against its peak (about 3e-5,
    das_pallas.py:520-530) and uses polynomial apodization and sincos.
  * vs golden: 1e-3, the repo's contract.

The JAX XLA reference runs once per (family, mode, IQ) with coherency on:
its coherent output does not depend on the flag.  The Pallas comparison
runs on one configuration that covers READI weights, IQ rotation and the
incoherent sum: interpret mode costs 20-30 s of compilation per
configuration on one core; the FORCES cubic flagship goes through it end to
end in test_torch_pipeline.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import das as jax_das  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.ops.das_pallas import das_pallas  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, InterpolationMode, RCAOrientation,
    pack_tx_rx_orientation)
from ogl_beamforming_tpu.utils.hadamard import hadamard  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz  # noqa: E402
from ogl_beamforming_tpu_torch.ops import das  # noqa: E402

torch.set_num_threads(1)

C, S, PITCH, POINTS = 8, 256, 0.3e-3, (12, 16, 1)
FAMILIES = ["forces", "uforces", "readi"]


def _params(family, interp, coherency) -> golden.DasParams:
    kw = {}
    a = 4
    kind = AcquisitionKind.FORCES
    if family == "uforces":
        a = 5
        kind = AcquisitionKind.UFORCES
        kw = dict(sparse=True,
                  sparse_elements=np.array([0, 2, 4, 6, 7], np.int16))
    elif family == "readi":
        kw = dict(readi_group_count=2, readi_group=1,
                  das_hadamard=hadamard(2).T)
    return golden.DasParams(
        acquisition_kind=kind, acquisition_count=a, channel_count=C,
        sample_count=S, sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3],
                                            [(C - 1) * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=POINTS, interpolation_mode=interp,
        coherency_weighting=coherency, **kw)


def _rf(p, iq):
    rng = np.random.default_rng(0x0621 + p.acquisition_count + 2 * iq)
    rf = rng.standard_normal((C, p.acquisition_count, S)).astype(np.float32)
    if iq:
        rf = (rf + 1j * rng.standard_normal(rf.shape)).astype(np.complex64)
    return rf


def _port(rf, p, iq):
    out = das.das(torch.from_numpy(rf), das.make_dynamic(p),
                  das.make_static(p, iq=iq))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _jax_xla(family, interp, iq):
    """(coherent, incoherent) from the JAX package's XLA DAS."""
    p = _params(family, interp, coherency=True)
    out = jax_das.das_jit(_rf(p, iq), jax_das.make_dynamic(p),
                          jax_das.make_static(p, iq=iq))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("family", FAMILIES)
def test_das_matches_jax_and_golden(family, interp, iq, coherency):
    p = _params(family, interp, coherency)
    rf = _rf(p, iq)
    out = _port(rf, p, iq)
    ref = golden.das(rf, p)
    coh, inco = _jax_xla(family, interp, iq)
    if coherency:
        out, out_inco = out
        ref, ref_inco = ref
        assert nrmse(inco, out_inco) <= 1e-4
        assert nrmse(ref_inco, out_inco) <= 1e-3
    assert out.shape == POINTS
    assert out.dtype == (np.complex64 if iq else np.float32)
    assert np.abs(ref).max() > 0
    assert nrmse(coh, out) <= 1e-4
    assert nrmse(ref, out) <= 1e-3


def test_das_matches_pallas_interpret():
    p = _params("readi", InterpolationMode.Linear, coherency=True)
    rf = _rf(p, iq=True)
    coh, inco = _port(rf, p, iq=True)
    st = jax_das.make_static(p, iq=True)
    ref_coh, ref_inco = das_pallas(rf, jax_das.make_dynamic(p), st,
                                   interpret=True)
    assert nrmse(np.asarray(ref_coh), coh) <= 2e-4
    assert nrmse(np.asarray(ref_inco), inco) <= 2e-4


@pytest.mark.parametrize("kind", [AcquisitionKind.HERCULES,
                                  AcquisitionKind.Flash])
def test_unported_families_raise(kind):
    p = _params("forces", InterpolationMode.Linear, False)
    p.acquisition_kind = kind
    p.transmit_receive_orientation = pack_tx_rx_orientation(
        RCAOrientation.Rows, RCAOrientation.Columns)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(_rf(p, False), p, False)


def test_undispatched_kind_gives_zero_frame():
    """RACES has no das.glsl dispatch case: the frame stays zero, as in
    golden and the JAX package."""
    p = _params("forces", InterpolationMode.Linear, False)
    p.acquisition_kind = AcquisitionKind.RACES
    out = _port(_rf(p, False), p, False)
    assert out.shape == POINTS and not out.any()

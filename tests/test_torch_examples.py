"""The port's examples (ogl_beamforming_tpu_torch.examples) and its single-card
entry point (ogl_beamforming_tpu_torch.entry) on the CPU against the JAX
package's counterparts:

  * the throughput chain (the reference's tests/throughput.c) on
    ``tests/data/point_targets.zbp`` at a reduced grid passed to
    ``from_zbp`` (128 x 256 under the fixture's aperture): Demodulate ->
    Decode -> FORCES IQ DAS through the port's ``Beamformer(device="cpu")``
    and the JAX ``Beamformer`` (XLA) configured alike, NRMSE <= 1e-4
    against JAX and <= 1e-3 against the golden chain, the image peaks on
    the fixture's three targets;
  * the filter from a sine and from a chirp emission descriptor: the JAX
    example's construction (examples/throughput.py:80-101) designed at the
    pair rate fs / 2, at which Demodulate runs it, so that its delay
    compensation is the delay the filter has there;
  * ``decode_sweep`` at orders 2, 12 and 96 (a reduced frame), exactly
    equal to the JAX ``decode_hadamard`` of the same canonical RF, and its
    ``main`` printing the reference's line;
  * ``point_scatterer`` at a reduced size: the peak on the target and the
    frame within 1e-4 of the JAX Beamformer's;
  * ``entry(device="cpu")``'s forward on a nonzero frame within 1e-4 of
    ``__graft_entry__.entry``'s;
  * every example's ``main`` and ``entry`` asking for the GPU by default.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

import __graft_entry__  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.ops.decode import (  # noqa: E402
    decode_hadamard as jax_decode, hadamard_matrix as jax_hadamard)
from ogl_beamforming_tpu.params import types as jax_types  # noqa: E402
from ogl_beamforming_tpu.pipeline import executor as jax_executor  # noqa: E402
from ogl_beamforming_tpu.runtime.upload import prepare_rf  # noqa: E402
from ogl_beamforming_tpu.utils.filters import make_filter  # noqa: E402
from ogl_beamforming_tpu.utils.hadamard import hadamard  # noqa: E402
from ogl_beamforming_tpu_torch import convert, entry  # noqa: E402
from ogl_beamforming_tpu_torch.examples import (  # noqa: E402
    decode_sweep, live_streaming, point_scatterer, throughput)
from ogl_beamforming_tpu_torch.params.enums import FilterKind  # noqa: E402
from ogl_beamforming_tpu_torch.utils import filters as port_filters  # noqa: E402
from ogl_beamforming_tpu_torch.utils.zbp import load_zbp  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests", "data"))
import make_point_fixture  # noqa: E402

FIXTURE_GRID = dict(output_points=(128, 256), lateral_mm=(0.0, 9.3),
                    axial_mm=(2.0, 16.0))


def _to_jax(cls, port_value):
    """The JAX package's block of ``cls`` with the port block's fields."""
    return convert._from_fields(cls, dataclasses.asdict(port_value))


def _jax_throughput_frame(z, fp):
    """The JAX example's configuration (examples/throughput.py:64-101) of a
    JAX Beamformer with filter ``fp``, one frame."""
    from ogl_beamforming_tpu.models.presets import from_zbp
    from ogl_beamforming_tpu.utils import zbp as jax_zbp
    jz = jax_zbp.load_zbp(throughput.FIXTURE)
    params, pipe = from_zbp(jz, **FIXTURE_GRID)
    bf = jax_executor.Beamformer(voxel_block=4096)
    bf.push_parameters(params)
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    bf.push_channel_mapping(jz.channel_mapping)
    bf.create_filter(_to_jax(jax_types.FilterParameters, fp), filter_slot=0)
    return bf.push_data_with_compute(throughput.raw_frame(z)).to_numpy()


def _golden_throughput_frame(z, bf):
    """The golden chain: demodulate, decode, DAS at the pair rate with the
    filter's delay in the time offset."""
    p = bf._block(0).parameters
    filt = make_filter(_to_jax(jax_types.FilterParameters,
                               throughput.emission_filter(z)))
    c, a, s = z.channel_count, z.receive_event_count, z.sample_count
    rf = prepare_rf(throughput.raw_frame(z), z.channel_mapping, c, a, s)
    iq = golden.demodulate(rf, filt.taps, p.demodulation_frequency,
                           p.sampling_frequency)
    dec = golden.decode_hadamard(iq, hadamard(a))
    return golden.das(dec, golden.DasParams(
        acquisition_kind=p.acquisition_kind, acquisition_count=a,
        channel_count=c, sample_count=s // 2,
        sampling_frequency=p.sampling_frequency / 2,
        demodulation_frequency=p.demodulation_frequency,
        speed_of_sound=p.speed_of_sound,
        time_offset=p.time_offset + filt.time_delay,
        interpolation_mode=p.interpolation_mode, f_number=p.f_number,
        voxel_transform=np.asarray(p.xdc_transform)
        @ np.asarray(p.das_voxel_transform),
        xdc_transform=np.asarray(p.xdc_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(128, 256, 1),
        transmit_receive_orientation=p.transmit_receive_orientation,
        transmit_angle=float(p.focal_vector[0]),
        focus_depth=float(p.focal_vector[1])))


def test_throughput_chain_on_the_fixture_matches_jax_and_golden():
    z = load_zbp(throughput.FIXTURE)
    bf = throughput.configure(z, "cpu", **FIXTURE_GRID)
    kinds = [sd.kind.name for sd in bf._ensure_plan(bf._block(0))
             .descriptor.stages]
    assert kinds == ["Demodulate", "Decode", "DAS"]
    times = throughput.run(bf, throughput.raw_frame(z), 1, out=lambda _: 0)
    assert len(times) == 1
    out = bf.get_last_frames(1)[-1].to_numpy()
    assert out.shape == (128, 256, 1) and out.dtype == np.complex64

    ref = _jax_throughput_frame(z, throughput.emission_filter(z))
    assert nrmse(ref, out) <= 1e-4
    assert nrmse(_golden_throughput_frame(z, bf), out) <= 1e-3

    # each of the fixture's targets is the brightest point near it
    p = bf._block(0).parameters
    inv = np.linalg.inv(np.asarray(p.das_voxel_transform, np.float64))
    img = np.abs(out[:, :, 0])
    for target in make_point_fixture.TARGETS:
        u = (inv @ np.array([*target, 1.0]))[:3]
        ix, iz = round(u[0] * 127), round(u[1] * 255)
        lo_x, lo_z = max(ix - 8, 0), max(iz - 16, 0)
        win = img[lo_x:ix + 9, lo_z:iz + 17]
        px, pz = np.unravel_index(np.argmax(win), win.shape)
        assert abs(px + lo_x - ix) <= 2 and abs(pz + lo_z - iz) <= 2, \
            (target, (px + lo_x, pz + lo_z), (ix, iz))


def test_frame_line_is_the_reference_format():
    line = throughput.frame_line(0.002, [0.004, 0.002], 4_000_000)
    assert line == ("Frame Time:    2.000 [ms] | 32-Frame Average:    3.000"
                    " [ms] |  1.33 GB/s")


def _emission_file(kind):
    z = load_zbp(throughput.FIXTURE)
    if kind == "chirp":
        z.emissions = [{"kind": 1, "duration": 2e-6, "min_frequency": 1e6,
                        "max_frequency": 4e6}]
    elif kind == "sine":
        z.emissions = [{"kind": 0, "cycles": 2.0, "frequency": 5e6}]
    return z


def _jax_example_filter(z, fs):
    """examples/throughput.py:80-101, designed at ``fs``."""
    em = z.emissions[0] if z.emissions else {"kind": 0}
    if em.get("kind") == 1:
        return jax_types.FilterParameters(
            kind=FilterKind.MatchedChirp, sampling_frequency=fs,
            complex=True,
            matched_chirp=jax_types.MatchedChirpFilterParameters(
                em.get("duration", 2e-6), em.get("min_frequency", 2e6),
                em.get("max_frequency", 8e6)))
    return jax_types.FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=fs,
        kaiser=jax_types.KaiserFilterParameters(
            z.demodulation_frequency or z.sampling_frequency / 4, 4.0, 36))


@pytest.mark.parametrize("emission", ["none", "sine", "chirp"])
def test_emission_filter_is_the_jax_construction_at_the_pair_rate(emission):
    z = _emission_file(emission)
    ours = throughput.emission_filter(z)
    ref = _jax_example_filter(z, z.sampling_frequency / 2)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    a, b = port_filters.make_filter(ours), make_filter(ref)
    np.testing.assert_array_equal(a.taps, b.taps)
    assert a.time_delay == b.time_delay
    assert a.complex == (emission == "chirp")


def test_kaiser_delay_compensation_is_its_delay_at_the_pair_rate():
    """The Kaiser filter's taps centre on tap L / 2 (utils/filters.py), so
    run at the pair rate fs / 2 it delays by L / 2 pairs: the compensation
    ``make_filter`` computes from the design rate is that delay only when
    the design rate is the pair rate (the JAX example's fs gives half)."""
    z = _emission_file("sine")
    filt = port_filters.make_filter(throughput.emission_filter(z))
    pairs_per_second = z.sampling_frequency / 2
    centre = int(np.argmax(filt.taps))
    assert centre == len(filt.taps) // 2
    assert filt.time_delay == pytest.approx(centre / pairs_per_second)
    jax_filt = make_filter(_jax_example_filter(z, z.sampling_frequency))
    assert jax_filt.time_delay == pytest.approx(filt.time_delay / 2)


def test_synthetic_zbp_and_raw_frame():
    z = throughput.synthesize_zbp(c=16, a=8, s=64)
    raw = throughput.raw_frame(z)
    assert raw.shape == (16, 8 * 64) and raw.dtype == np.int16
    bf = throughput.configure(z, "cpu", output_points=(8, 16))
    assert bf._block(0).filters[0].parameters.kaiser.cutoff_frequency \
        == pytest.approx(7.8e6)


def _sweep_raw(t, channels, samples, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-2048, 2048, (channels, samples * t),
                         dtype=torch.int16, generator=gen).numpy()


@pytest.mark.parametrize("t", [2, 12, 96])
def test_decode_sweep_order_equals_jax(t):
    channels, samples = 16, 64
    rf, h = decode_sweep.sweep_input(t, "cpu", seed=t, channels=channels,
                                     samples=samples)
    raw = _sweep_raw(t, channels, samples, seed=t)
    want_rf = prepare_rf(raw, decode_sweep.shuffled_channel_mapping(channels),
                         channels, t, samples)
    np.testing.assert_array_equal(rf.numpy(), want_rf)
    avg_ms, out = decode_sweep.time_order(rf, h, warmup=1, frames=2)
    assert avg_ms > 0
    ref = np.asarray(jax_decode(want_rf, jax_hadamard(t)))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_decode_sweep_main_prints_the_reference_line(capsys, tmp_path):
    decode_sweep.main(["--device", "cpu", "--transmits", "2", "--warmup",
                       "0", "--dump", str(tmp_path)])
    line = capsys.readouterr().out.strip()
    assert line.startswith("decode   2 | 32F Average: ") and "GB/s" in line
    assert (tmp_path / "decode_sweep.json").exists()


def test_decode_sweep_orders_are_the_reference_list():
    assert decode_sweep.TRANSMIT_COUNTS == [
        2, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128, 160, 192, 256]
    assert sorted(decode_sweep.shuffled_channel_mapping(256)) == \
        list(range(256))


def test_point_scatterer_matches_jax_and_peaks_on_target():
    c, a, s = 32, 16, 1024
    p = point_scatterer.parameters(c=c, a=a, s=s, grid=(64, 128))
    target = point_scatterer.target_for(c)
    raw = point_scatterer.raw_frame(p, target)
    frame = point_scatterer.configure(p, "cpu").push_data_with_compute(raw)
    jbf = jax_executor.Beamformer(voxel_block=4096)
    jbf.push_parameters(_to_jax(jax_types.Parameters, p))
    jbf.push_pipeline([0, 3], 0)
    ref = jbf.push_data_with_compute(raw).to_numpy()
    assert nrmse(ref, frame.to_numpy()) <= 1e-4

    from ogl_beamforming_tpu_torch import viewer
    wx, wz = point_scatterer.image_peak_mm(
        viewer.bmode_image(frame, db_cutoff=-50), p)
    lateral_pitch = (c - 1) * 0.3 / 63
    axial_pitch = 14.0 / 127
    assert abs(wx - target[0] * 1e3) <= lateral_pitch
    assert abs(wz - target[2] * 1e3) <= 2 * axial_pitch


def test_entry_forward_matches_the_jax_entry():
    forward, (rf,) = entry.entry(device="cpu")
    assert rf.shape == (32, 16, 1024) and not rf.any()
    raw = np.random.default_rng(11).integers(-2048, 2048, tuple(rf.shape),
                                             dtype=np.int16)
    out = forward(torch.from_numpy(raw)).numpy()
    jax_forward, (jax_rf,) = __graft_entry__.entry()
    assert jax_rf.shape == tuple(rf.shape)
    ref = np.asarray(jax_forward(raw))
    assert out.shape == ref.shape == (128, 128, 1)
    assert np.abs(out).max() > 0
    assert nrmse(ref, out) <= 1e-4
    np.testing.assert_allclose(forward(raw).numpy(), out)


@pytest.mark.parametrize("main", [
    lambda: throughput.main(["--synthetic"]),
    lambda: decode_sweep.main([]),
    lambda: point_scatterer.main([]),
    lambda: live_streaming.main([]),
    lambda: entry.entry()],
    ids=["throughput", "decode_sweep", "point_scatterer", "live_streaming",
         "entry"])
def test_entry_points_default_to_the_gpu(main):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main()

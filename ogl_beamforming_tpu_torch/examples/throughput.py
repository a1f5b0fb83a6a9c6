"""End-to-end throughput benchmark: the reference's tests/throughput.c.

Loads a ``.zbp`` dataset (or synthesizes one with --synthetic), builds the
[Demodulate?] -> Decode -> DAS pipeline with the filter chosen from the
emission descriptor (tests/throughput.c:455-491), beamforms onto the
512 x 1024 grid (lateral +-60 mm, axial 10-165 mm, f# = 0.5, cubic;
tests/throughput.c:20-23,450-451) and prints per-frame time, the 32-frame
rolling average, and GB/s of raw RF exactly like the reference's --loop
output (tests/throughput.c:536-556).

Usage:
  python -m ogl_beamforming_tpu_torch.examples.throughput data.zbp --loop
  python -m ogl_beamforming_tpu_torch.examples.throughput --synthetic \
      --frames 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..models.presets import from_zbp
from ..params.enums import (AcquisitionKind, DataKind, DecodeMode,
                            EmissionKind, FilterKind, ShaderKind)
from ..params.types import (FilterParameters, KaiserFilterParameters,
                            MatchedChirpFilterParameters)
from ..pipeline.executor import Beamformer
from ..pipeline.spec import PipelineSpec
from ..utils.device import sync
from ..utils.zbp import ZbpFile, load_zbp

FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "data"
           / "point_targets.zbp")
"""The committed golden recording (three point targets), the default
dataset; it is zstd-compressed, so loading it needs ``zstandard``."""


def synthesize_zbp(c=128, a=64, s=2048) -> ZbpFile:
    rng = np.random.default_rng(3)
    return ZbpFile(
        version=(1, 0), raw_data_dimension=(a * s, c, 1, 1),
        data_kind=DataKind.Int16, decode_mode=DecodeMode.Hadamard,
        sampling_mode=0, sampling_frequency=40e6,
        demodulation_frequency=7.8e6, speed_of_sound=1540.0,
        sample_count=s, channel_count=c, receive_event_count=a,
        xdc_transform=np.eye(4, dtype=np.float32),
        xdc_element_pitch=np.array([2e-4, 2e-4], np.float32),
        time_offset=0.0, acquisition_kind=AcquisitionKind.FORCES,
        channel_mapping=np.arange(c, dtype=np.int16),
        data=rng.integers(-2048, 2048, c * a * s).astype(np.int16))


def emission_filter(z: ZbpFile) -> FilterParameters:
    """The Demodulate stage's filter from the file's emission descriptor
    (tests/throughput.c:463-491): a matched chirp with complex taps for a
    chirp emission, else a 36-tap Kaiser low-pass (beta 4) at the
    demodulation frequency.

    Both are designed at the pair rate fs / 2, the rate Demodulate runs
    its filter at: the filter's delay compensation (``make_filter``'s
    ``time_delay``) and a chirp's sweep assume the design rate.  The JAX
    example designs them at fs, which leaves half of a Kaiser filter's
    delay uncompensated (its point targets image 2 voxels deep on the
    512 x 1024 grid at 40 MHz, 12 on a 256-deep grid over 14 mm at
    20 MHz)."""
    fs = z.sampling_frequency / 2
    em = z.emissions[0] if z.emissions else {"kind": 0}
    if em.get("kind") == int(EmissionKind.Chirp):
        return FilterParameters(
            kind=FilterKind.MatchedChirp,
            sampling_frequency=fs, complex=True,
            matched_chirp=MatchedChirpFilterParameters(
                em.get("duration", 2e-6), em.get("min_frequency", 2e6),
                em.get("max_frequency", 8e6)))
    return FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=fs,
        kaiser=KaiserFilterParameters(
            z.demodulation_frequency or z.sampling_frequency / 4, 4.0, 36))


def configure(z: ZbpFile, device="cuda", demodulate: bool = True,
              **grid) -> Beamformer:
    """A :class:`Beamformer` on ``device`` set up for ``z`` as the example
    sets it up: ``from_zbp(z, **grid)`` (the throughput grid unless
    ``grid`` says otherwise), the file's channel mapping and sparse
    elements, and the emission's filter in slot 0 when the pipeline
    demodulates; ``demodulate=False`` drops the Demodulate stage."""
    params, pipe = from_zbp(z, **grid)
    if not demodulate:
        stages = [s for s in pipe.shaders if s != ShaderKind.Demodulate]
        pipe = PipelineSpec.from_shaders(stages, pipe.data_kind)
    bf = Beamformer(device=device)
    bf.push_parameters(params)
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    if z.channel_mapping is not None:
        bf.push_channel_mapping(z.channel_mapping)
    if z.sparse_elements is not None:
        bf.push_sparse_elements(z.sparse_elements)
    if any(s == ShaderKind.Demodulate for s in pipe.shaders):
        bf.create_filter(emission_filter(z), filter_slot=0)
    return bf


def raw_frame(z: ZbpFile) -> np.ndarray:
    """The recording's first frame in the raw (channels, samples) layout."""
    return z.data[: z.channel_count * z.receive_event_count * z.sample_count
                  ].reshape(z.channel_count, -1)


def frame_line(dt: float, times: list, raw_bytes: int) -> str:
    """The reference's --loop line for a frame of ``dt`` seconds after
    ``times`` (this frame's included)."""
    window = times[-32:]
    avg = sum(window) / len(window)
    return (f"Frame Time: {dt * 1e3:8.3f} [ms] | 32-Frame Average: "
            f"{avg * 1e3:8.3f} [ms] | {raw_bytes / avg / 1e9:5.2f} GB/s")


def run(bf: Beamformer, raw: np.ndarray, frames: int, out=print) -> list:
    """Beamform ``raw`` ``frames`` times, each frame uploaded, computed and
    waited for; ``out`` gets each frame's line.  Returns the host seconds
    of each frame."""
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        frame = bf.push_data_with_compute(raw)
        sync(frame.data)
        dt = time.perf_counter() - t0
        times.append(dt)
        out(frame_line(dt, times, raw.nbytes))
    return times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", help=".zbp file")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--no-demodulate", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.synthetic:
        z = synthesize_zbp()
    elif not args.dataset:
        # default to the committed golden fixture (known point targets)
        z = load_zbp(FIXTURE) if FIXTURE.exists() else synthesize_zbp()
    else:
        z = load_zbp(args.dataset)

    bf = configure(z, args.device, demodulate=not args.no_demodulate)
    run(bf, raw_frame(z), 10 ** 9 if args.loop else args.frames,
        out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()

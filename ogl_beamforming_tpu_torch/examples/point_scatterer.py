"""End-to-end demo: synthetic FORCES point scatterer -> GPU beamform -> PNG.

Run from the repo root:

    python -m ogl_beamforming_tpu_torch.examples.point_scatterer [--device cpu]

The PNG goes through ``viewer.save_bmode_png``, which needs matplotlib.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import viewer
from ..params.enums import (AcquisitionKind, DataKind, InterpolationMode,
                            ShaderKind)
from ..params.types import Parameters
from ..pipeline.executor import Beamformer
from ..utils.hadamard import hadamard
from ..utils.transforms import das_transform_2d_xz

C, A, S = 64, 32, 2048
FS, SOS, PITCH, F0 = 20e6, 1500.0, 0.3e-3, 5e6
DEPTH_MM = (2.0, 16.0)           # axial extent of the image
GRID = (256, 512)                # lateral x axial voxels


def synthesize_forces_frame(c, a, s, fs, sos, pitch, target, f0):
    """Per-(channel, transmit) echoes for a point target, Hadamard-encoded
    across transmits as the scanner records them."""
    rx_x = np.arange(c) * pitch
    tx_x = np.arange(a) * pitch
    ty = target[1] - pitch * c / 2
    rx_d = np.sqrt((target[0] - rx_x) ** 2 + target[2] ** 2)
    tx_d = np.sqrt(ty ** 2 + target[2] ** 2 + (target[0] - tx_x) ** 2)
    dist = rx_d[:, None] + tx_d[None, :]
    t = np.arange(s) / fs
    arg = t[None, None, :] - dist[:, :, None] / sos
    env = np.exp(-0.5 * (arg / (2 / f0 / 4)) ** 2)
    echo = (env * np.sin(2 * np.pi * f0 * arg)).astype(np.float32)
    encoded = np.einsum("tj,cts->cjs", hadamard(a), echo)
    return np.clip(encoded * 2000, -32768, 32767).astype(np.int16)


def target_for(c=C, pitch=PITCH) -> np.ndarray:
    """The scatterer: under the middle element, 8 mm deep."""
    return np.array([(c // 2) * pitch, 0.0, 8e-3])


def parameters(c=C, a=A, s=S, grid=GRID) -> Parameters:
    """The example's acquisition (``c`` channels, ``a`` transmits, ``s``
    samples) imaged onto ``grid`` (lateral, axial) voxels under the
    aperture."""
    return Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=FS, demodulation_frequency=F0,
        speed_of_sound=SOS, f_number=1.0,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz(
            [0, DEPTH_MM[0] * 1e-3], [(c - 1) * PITCH, DEPTH_MM[1] * 1e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([grid[0], grid[1], 1, 0], np.int32))


def configure(p: Parameters, device="cuda") -> Beamformer:
    """A Decode -> DAS :class:`Beamformer` on ``device`` for ``p``."""
    bf = Beamformer(device=device)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    return bf


def raw_frame(p: Parameters, target) -> np.ndarray:
    """The encoded echoes of ``target`` in the raw (channels, samples)
    layout."""
    c, a, s = p.channel_count, p.acquisition_count, p.sample_count
    raw = synthesize_forces_frame(c, a, s, p.sampling_frequency,
                                  p.speed_of_sound, p.xdc_element_pitch[0],
                                  target, p.demodulation_frequency)
    return raw.reshape(c, a * s)


def image_peak_mm(img: np.ndarray, p: Parameters) -> tuple:
    """World (lateral, axial) in mm of the brightest pixel of the
    ``viewer.bmode_image`` of a frame of ``p``."""
    nx, nz = int(p.output_points[0]), int(p.output_points[1])
    iz, ix = np.unravel_index(np.argmax(img), img.shape)
    width = (p.channel_count - 1) * float(p.xdc_element_pitch[0])
    wx = ix / (nx - 1) * width
    wz = (DEPTH_MM[0] + iz / (nz - 1) * (DEPTH_MM[1] - DEPTH_MM[0])) * 1e-3
    return wx * 1e3, wz * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="point_scatterer.png")
    args = ap.parse_args(argv)

    p = parameters()
    bf = configure(p, args.device)
    print("device:", bf.device)
    target = target_for()
    raw = raw_frame(p, target)

    t0 = time.perf_counter()
    frame = bf.push_data_with_compute(raw)
    print(f"first frame (incl. kernel build): "
          f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    frame = bf.push_data_with_compute(raw)
    print(f"steady-state frame: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    img = viewer.bmode_image(frame, db_cutoff=-50)
    wx, wz = image_peak_mm(img, p)
    print(f"image peak at ({wx:.2f}, {wz:.2f}) mm; "
          f"target ({target[0] * 1e3:.2f}, {target[2] * 1e3:.2f}) mm")

    out = viewer.save_bmode_png(
        frame, args.out, db_cutoff=-50,
        extent_mm=[0, (C - 1) * PITCH * 1e3, *DEPTH_MM],
        title="FORCES point scatterer (GPU)")
    print("wrote", out)


if __name__ == "__main__":
    main()

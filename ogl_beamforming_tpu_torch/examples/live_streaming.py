"""Live streaming demo: continuous ingest + browser view.

Simulates a scanner streaming FORCES frames of a moving point target into a
:class:`StreamingSession` on the card while a browser ``LiveView`` serves
the B-mode image, compute stats and live controls at
http://localhost:8765/: the reference's live-imaging UI loop.

    python -m ogl_beamforming_tpu_torch.examples.live_streaming \
        [--frames 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..params.enums import (AcquisitionKind, DataKind, InterpolationMode,
                            LiveImagingDirtyFlags, ShaderKind)
from ..params.types import Parameters
from ..pipeline.executor import Beamformer
from ..runtime.streaming import StreamingSession
from ..utils.hadamard import hadamard
from ..utils.transforms import das_transform_2d_xz
from ..viewer_web import LiveView

C, A, S = 32, 16, 1024
FS, SOS, PITCH, F0 = 10e6, 1500.0, 0.3e-3, 2.5e6
LINGER_SECONDS = 30              # the view stays up this long at the end


def frame_for_target(target):
    rx_x = np.arange(C) * PITCH
    tx_x = np.arange(A) * PITCH
    ty = -PITCH * C / 2
    rx_d = np.sqrt((target[0] - rx_x) ** 2 + target[2] ** 2)
    tx_d = np.sqrt(ty ** 2 + target[2] ** 2 + (target[0] - tx_x) ** 2)
    dist = (rx_d[:, None] + tx_d[None, :]).reshape(-1)
    t = np.arange(S) / FS
    arg = t[None, :] - dist[:, None] / SOS
    env = np.exp(-0.5 * (arg / (2 / F0 / 4)) ** 2)
    echo = (env * np.sin(2 * np.pi * F0 * arg)).reshape(C, A, S)
    enc = np.einsum("tj,cts->cjs", hadamard(A), echo)
    return np.clip(enc * 2000, -32768, 32767).astype(np.int16).reshape(C, -1)


def orbit_target(i: int) -> np.ndarray:
    """Frame ``i``'s target, orbiting the image center (30 frames a
    turn)."""
    phase = i / 30 * 2 * np.pi
    return np.array([(C / 2 + 6 * np.cos(phase)) * PITCH, 0.0,
                     4e-3 + 1.5e-3 * np.sin(phase)])


def parameters() -> Parameters:
    return Parameters(
        sample_count=S, channel_count=C, acquisition_count=A,
        sampling_frequency=FS, demodulation_frequency=F0,
        speed_of_sound=SOS, f_number=1.0,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(C - 1) * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([128, 256, 1, 0], np.int32))


def configure(device="cuda") -> Beamformer:
    bf = Beamformer(device=device)
    bf.push_parameters(parameters())
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    return bf


def stream(bf: Beamformer, session: StreamingSession, frames: int,
           out=print):
    """Submit ``frames`` orbiting-target frames, honouring the live
    StopImaging control (throughput.c:558-560); returns the last handle
    (None when no frame was submitted).  The executor's dirty flag is a
    mask of :class:`LiveImagingDirtyFlags`, so StopImaging is tested as a
    bit of it (the JAX example shifts by the mask, as if it were the C
    library's bit index, and never sees the control)."""
    handle = None
    for i in range(frames):
        handle = session.submit(frame_for_target(orbit_target(i)))
        flag = bf.live_parameters_get_dirty_flag()
        if flag & LiveImagingDirtyFlags.StopImaging:
            out("stop requested")
            break
        if i % 10 == 0 and handle.done():
            out(f"frame {i}: "
                f"{bf.stats.average_frame_time() * 1e3:.1f} ms avg")
    return handle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bf = configure(args.device)
    view = LiveView(bf, port=args.port).start()
    print(f"live view at {view.url}")
    try:
        with StreamingSession(bf) as session:
            handle = stream(bf, session, args.frames)
            if handle:
                handle.result(timeout=60)
        print(f"done; view stays up {LINGER_SECONDS} s")
        time.sleep(LINGER_SECONDS)
    finally:
        view.stop()


if __name__ == "__main__":
    main()

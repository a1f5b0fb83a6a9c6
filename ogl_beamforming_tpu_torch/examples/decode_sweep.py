"""Hadamard-decode benchmark sweep: the reference's tests/decode.c.

Per transmit count in the reference's sweep list (tests/decode.c:17-19),
decodes 4096 samples x 256 raw channels of Int16 with a realistic channel
mapping and prints the per-frame average over 32 frames in the same format:

    decode  96 | 32F Average:    1.234 [ms] |   123.4 GB/s

The raw frames are drawn on the device from a seeded generator and mapped
to the canonical layout there (``runtime/upload.prepare_rf_device``, bit
for bit the host's ``prepare_rf``).

Usage: python -m ogl_beamforming_tpu_torch.examples.decode_sweep
       [--warmup N] [--transmits 16,64,96] [--dump DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.decode import decode_hadamard, hadamard_matrix
from ..runtime.upload import mapping_rows, prepare_rf_device
from ..utils.device import resolve_device, sync

AVERAGE_SAMPLES = 32            # stats-table depth (tests/decode.c)
TRANSMIT_COUNTS = [2, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128,
                   160, 192, 256]
SAMPLE_COUNT = 4096
CHANNEL_COUNT = 256


def shuffled_channel_mapping(n: int) -> np.ndarray:
    """A realistic scatter permutation (tests/decode.c:204-222 uses the
    Verasonics ordering; any fixed permutation exercises the same path)."""
    rng = np.random.default_rng(0xC0FFEE)
    return rng.permutation(n).astype(np.int16)


def sweep_input(transmits: int, device="cuda", seed: int = 0,
                channels: int = CHANNEL_COUNT,
                samples: int = SAMPLE_COUNT):
    """One order's canonical int16 RF ``(channels, transmits, samples)``
    and its Hadamard matrix, both on ``device``: a raw frame of values in
    [-2048, 2048) drawn there from ``seed``, its rows gathered through
    :func:`shuffled_channel_mapping`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(-2048, 2048, (channels, samples * transmits),
                        dtype=torch.int16, device=dev, generator=gen)
    rows = torch.from_numpy(mapping_rows(shuffled_channel_mapping(channels),
                                         channels, channels)).to(dev)
    rf = prepare_rf_device(raw, rows, channels, transmits, samples)
    return rf, hadamard_matrix(transmits, dev)


def time_order(rf: torch.Tensor, h: torch.Tensor, warmup: int = 4,
               frames: int = AVERAGE_SAMPLES):
    """Milliseconds per decode, averaged over ``frames`` back-to-back
    decodes and one wait for the last, as tests/decode.c averages them;
    returns it with the last decode's output."""
    for _ in range(warmup):
        sync(decode_hadamard(rf, h))
    t0 = time.perf_counter()
    for _ in range(frames):
        out = decode_hadamard(rf, h)
    sync(out)
    return (time.perf_counter() - t0) / frames * 1e3, out


def rf_gbs(rf: torch.Tensor, avg_ms: float) -> float:
    """GB/s of raw int16 RF decoded (the reference's figure)."""
    return rf.numel() * rf.element_size() / (avg_ms * 1e-3) / 1e9


def order_line(transmits: int, avg_ms: float, gbs: float) -> str:
    return (f"decode {transmits:3d} | {AVERAGE_SAMPLES}F Average: "
            f"{avg_ms:8.3f} [ms] | {gbs:7.1f} GB/s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--transmits", type=str, default="")
    ap.add_argument("--dump", type=str, default="")
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    transmits = ([int(t) for t in args.transmits.split(",") if t]
                 or TRANSMIT_COUNTS)
    dump = {}
    for t in transmits:
        rf, h = sweep_input(t, args.device, seed=t)
        avg_ms, _ = time_order(rf, h, warmup=args.warmup)
        gbs = rf_gbs(rf, avg_ms)
        print(order_line(t, avg_ms, gbs))
        dump[t] = {"ms": avg_ms, "GB/s": gbs}
        del rf, h
        if args.once:
            break

    if args.dump:
        from pathlib import Path
        out_dir = Path(args.dump)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "decode_sweep.json").write_text(json.dumps(dump, indent=1))


if __name__ == "__main__":
    main()

"""Pre-tune the CUDA kernels' launch knobs for the preset configurations on
this card: the counterpart of the JAX package's ``tools/pretune.py``.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python -m ogl_beamforming_tpu_torch.pretune [--only decode,headline]
                                                 [--out DIR]

Each case builds its plan as a user would, makes its input on the card from
a seed, and runs ``das_cuda.autotune_das`` (or ``decode.autotune_decode``)
with the default candidates; it prints each candidate's milliseconds with
the card's name and power limit.  The tables go to
``ogl_beamforming_tpu_torch/data/tuned_h100.json`` and
``decode_tuned_h100.json`` (or under ``--out``) after every case, the whole
table each time, so an interrupted run keeps what it measured.  The cases
carry ``tools/pretune.py``'s names and shapes; the port's own paths follow
where their table key differs (the Quickstart, paths A to C, path E's batch
of four, the throughput chain's FORCES IQ grid, the decode of each path).
Where cases share a table key (it holds no geometry), the key gets the
candidate with the least total time over them.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
from pathlib import Path

import torch

DATA_DIR = Path(__file__).resolve().parent / "data"


def _card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}")


def _plan(params, pipe, filters=None, sparse=None, frame_batch=1):
    """(plan, DAS static, DAS dynamic) of a configuration."""
    from .pipeline.plan import build_plan
    from .utils.filters import make_filter
    plan = build_plan(params, pipe, {slot: make_filter(fp) for slot, fp in
                                     (filters or {}).items()},
                      sparse_elements=sparse, frame_batch=frame_batch)
    sd = next(sd for sd in plan.descriptor.stages if sd.das is not None)
    return plan, sd.das, plan.dyn["das"]


def _kaiser(fs: float, cutoff: float = 2e6, taps: int = 16):
    from .params.types import FilterParameters, KaiserFilterParameters
    from .params.enums import FilterKind
    return FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=fs,
                            kaiser=KaiserFilterParameters(cutoff, 4.0, taps))


def throughput_zbp():
    """The header of the throughput chain's recording: a FORCES
    acquisition, int16 128 channels x 128 transmits x 4096 samples at 40
    MHz, Hadamard-encoded (``chip_smoke.py`` phase 10 writes such a file)."""
    import numpy as np

    from .params.enums import AcquisitionKind, DataKind, DecodeMode
    from .utils.zbp import ZbpFile
    c, a, s, pitch = 128, 128, 4096, 0.3e-3
    return ZbpFile(
        version=(2, 0), raw_data_dimension=(a * s, c, 1, 1),
        data_kind=DataKind.Int16, decode_mode=DecodeMode.Hadamard,
        sampling_mode=0, sampling_frequency=40e6,
        demodulation_frequency=7.8e6, speed_of_sound=1540.0,
        sample_count=s, channel_count=c, receive_event_count=a,
        xdc_transform=np.eye(4, dtype=np.float32),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        time_offset=0.0, acquisition_kind=AcquisitionKind.FORCES,
        emissions=[{"kind": 0, "cycles": 2.0, "frequency": 7.8e6}])


def das_cases():
    """(name, setup, timed calls a candidate): ``setup()`` gives
    ``(plan, static, dynamic)`` on the card."""
    from .models import presets
    from .params.enums import DataKind

    def headline():
        p, pipe = presets.plane_wave_2d(channel_count=256, sample_count=4096,
                                        output_points=(512, 1024))
        plan, st, dyn = _plan(p, pipe)
        return plan, dataclasses.replace(st, iq=True), dyn

    def forces_chain():
        p, pipe = presets.forces_compounding(
            channel_count=128, transmit_count=16, sample_count=2048,
            output_points=(256, 512), demodulate=False)
        return _plan(p, pipe)

    def forces_demod_chain():
        p, pipe = presets.forces_compounding(
            channel_count=128, transmit_count=16, sample_count=2048,
            sampling_frequency=20e6, demodulation_frequency=5e6,
            output_points=(256, 512), demodulate=True)
        return _plan(p, pipe, {0: _kaiser(20e6)})

    def hercules(s):
        return lambda: _plan(*presets.hercules_3d(
            channel_count=128, acquisition_count=128, sample_count=s,
            output_points=(96, 96, 96)))

    def forces_big():
        p, pipe = presets.forces_compounding(
            channel_count=256, transmit_count=16, sample_count=2048,
            output_points=(512, 1024), demodulate=False)
        return _plan(p, pipe)

    def uforces_3d():
        p, pipe, sparse = presets.uforces_volumetric()
        return _plan(p, pipe, sparse=sparse)

    def quickstart():
        return _plan(*presets.forces_compounding(
            channel_count=128, transmit_count=128, sample_count=4096,
            demodulate=False))

    def path_a(frame_batch=1):
        p, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
        return _plan(p, pipe, frame_batch=frame_batch)

    def path_b():
        p, pipe = presets.forces_compounding(
            channel_count=128, transmit_count=128, sample_count=4096)
        return _plan(p, pipe, {0: _kaiser(p.sampling_frequency / 2)})

    def throughput_chain():
        from .examples.throughput import emission_filter
        from .models.presets import from_zbp
        z = throughput_zbp()
        p, pipe = from_zbp(z)
        return _plan(p, pipe, {0: emission_filter(z)})

    return [("plane_wave_headline", headline, 50),
            ("forces_chain", forces_chain, 20),
            ("forces_demod_chain", forces_demod_chain, 20),
            ("hercules_3d", hercules(4096), 6),
            ("forces_big", forces_big, 10),
            ("uforces_3d", uforces_3d, 4),
            ("quickstart", quickstart, 4),
            ("path_a", path_a, 50),
            ("throughput_chain", throughput_chain, 4),
            ("path_b", path_b, 4),
            ("path_c", hercules(2048), 8),
            ("path_e_batch4", lambda: path_a(4), 50)]


def decode_cases():
    """(name, (C, A, S), dtype): the decode sweep's orders at 256 channels x
    4096 samples (tests/decode.c), the demodulate chain's complex frame,
    and each main path's decode."""
    i16, c64 = torch.int16, torch.complex64
    return ([(f"decode{t}", (256, t, 4096), i16) for t in (16, 64, 96, 256)]
            + [("decode_chain", (128, 16, 1024), c64),
               ("decode_quickstart", (128, 128, 4096), i16),
               ("decode_path_b", (128, 128, 2048), c64),
               ("decode_path_c", (128, 128, 2048), i16),
               ("decode_path_d", (256, 64, 2048), i16)])


def device_input(shape, dtype, seed: int) -> torch.Tensor:
    """Input of ``shape`` made on the card from ``seed``: normal float32 or
    complex64, int16 in [-2048, 2048)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if dtype == torch.int16:
        return torch.randint(-2048, 2048, shape, generator=g, device="cuda",
                             dtype=torch.int16)
    x = torch.randn(shape, generator=g, device="cuda")
    if dtype == torch.complex64:
        x = torch.complex(x, torch.randn(shape, generator=g, device="cuda"))
    return x


def das_input(st, seed: int) -> torch.Tensor:
    """A DAS stage's input for ``st``: (B,) C x A x S."""
    lead = (st.frame_batch,) if st.frame_batch > 1 else ()
    return device_input(lead + (st.channel_count, st.acquisition_count,
                                st.sample_count),
                        torch.complex64 if st.iq else torch.float32, seed)


def share_key(key, cases, candidates) -> dict:
    """Install for ``key`` the candidate with the least total time over
    ``cases`` [(name, autotune results)], configurations of one table key
    (the key holds no geometry: the Quickstart-sized FORCES IQ grid of path
    B and of the throughput chain share one), skipping a candidate that
    failed in any; returns it."""
    from .ops import das_cuda
    totals = []
    for i, knobs in enumerate(candidates):
        times = [res.get(repr(knobs)) for _, res in cases]
        if all(t is not None for t in times):
            totals.append((sum(times), i))
    best = dict(candidates[min(totals)[1]]) if totals else {}
    das_cuda.TUNED[key] = best
    print(f"== {key} is the key of {', '.join(n for n, _ in cases)}: "
          f"installed {best}, the least total time " + ", ".join(
              f"{candidates[i]} {t * 1e3:.4f} ms" for t, i in totals),
          flush=True)
    return best


def _print_results(best, results) -> None:
    print(f"   best={best}", flush=True)
    for k, v in results.items():
        print(f"   {k}: {'fail' if v is None else f'{v * 1e3:.4f} ms'}",
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated case-name substrings to run "
                         "(e.g. 'decode', 'headline,uforces'); empty = all")
    ap.add_argument("--out", default=str(DATA_DIR),
                    help="directory of tuned_h100.json and "
                         "decode_tuned_h100.json (default: the package's)")
    cli = ap.parse_args(argv)
    only = [s for s in cli.only.split(",") if s]

    def wanted(name):
        return not only or any(s in name for s in only)

    if not torch.cuda.is_available():
        raise SystemExit("pretune times the CUDA kernels: no GPU")
    from .ops import das_cuda, decode
    out = Path(cli.out)
    out.mkdir(parents=True, exist_ok=True)
    das_path = out / "tuned_h100.json"
    dec_path = out / "decode_tuned_h100.json"
    print(f"{torch.cuda.get_device_name(0)}; {_card_line()}", flush=True)

    shared: dict = {}      # key -> [(case, results)]
    for i, (name, setup, iters) in enumerate(das_cases()):
        if not wanted(name):
            continue
        _, st, dyn = setup()
        key = das_cuda._tune_key(st)
        print(f"== {name}: {key}, {iters} calls a candidate", flush=True)
        best, results = das_cuda.autotune_das(
            das_input(st, i), dyn, st, iters=iters, warmup=1, passes=3)
        _print_results(best, results)
        shared.setdefault(key, []).append((name, results))
        if len(shared[key]) > 1:
            share_key(key, shared[key], das_cuda._default_candidates(st))
        das_cuda.save_tuned(das_path)
        torch.cuda.empty_cache()

    for i, (name, shape, dtype) in enumerate(decode_cases()):
        if not wanted(name):
            continue
        rf = device_input(shape, dtype, 100 + i)
        print(f"== {name}: {tuple(shape)} {dtype}", flush=True)
        best, results = decode.autotune_decode(
            rf, decode.hadamard_matrix(shape[1], rf.device), iters=40,
            warmup=4, passes=3, save_path=dec_path)
        _print_results(best, results)
    print(f"saved {das_path} ({len(das_cuda.TUNED)} entries), {dec_path} "
          f"({len(decode.DECODE_TUNED)} entries); {_card_line()}", flush=True)


if __name__ == "__main__":
    main()

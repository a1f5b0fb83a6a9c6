"""Build the CUDA kernels of ``csrc/`` and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` (with the headers ``csrc/*.cuh``) for
Hopper (``sm_90a``), one process per source, all started together, and
links the objects into one shared library with a plain C interface; nothing
includes PyTorch's headers, so a build takes seconds.  The library goes into
``_build/`` beside this package, named by a hash of the sources, headers and
flags, and is built at first use: the first call of a kernel wrapper (or
:func:`library`) compiles it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
Each kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel, and nowhere else (the plain twins do not count), through
:func:`count_launch`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
"""Kernel launches in this process by kernel name: ``decode_hadamard``,
``das_forces``, ``das_hercules``, ``das_rca`` (and ``das_*_fb4``, a launch
of four frames of a batch), ``demodulate``, ``fir``, and the
microbenchmarks' ``micro_gather`` (K5-K7 and the gather bundle of K8-K9),
``micro_onehot`` (K8-K9) and ``micro_i8`` (K10-K11)."""

KERNEL_LAUNCHES: collections.Counter = collections.Counter()
"""The same launches by the name their kernel shows in a profiler trace (a
piece of it, such as ``das_forces_kernel``), as each launch site gives it
to :func:`count_launch`."""

VARIANT_LAUNCHES: collections.Counter = collections.Counter()
"""The launches of a kernel of one name that takes a variant chosen at
launch, by ``"<LAUNCHES name> <variant>"``: the HERCULES and RCA kernels'
thread shape (``das_hercules thread 2.4.0``), as :func:`count_launch` is
given it."""


_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str, kernel: str | None = None,
                 variant: str | None = None) -> None:
    """Add one to ``LAUNCHES[name]``, where the launch site names the
    kernel as a trace shows it to ``KERNEL_LAUNCHES[kernel]``, and where it
    names the variant it launched to ``VARIANT_LAUNCHES``, under a lock: a
    streaming session's worker thread launches kernels beside the caller's
    thread."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
        if kernel is not None:
            KERNEL_LAUNCHES[kernel] += 1
        if variant is not None:
            VARIANT_LAUNCHES[f"{name} {variant}"] += 1


def kernel_launches() -> dict:
    """A copy of :data:`KERNEL_LAUNCHES`, taken under the same lock."""
    with _LAUNCH_LOCK:
        return dict(KERNEL_LAUNCHES)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

THREAD_SHAPES = {"hercules": ((3, 4, 0), (2, 4, 0)),
                 "rca": ((1, 1, 1), (1, 32, 1))}
"""The HERCULES and RCA kernels' thread shapes (voxels a thread, threads of
a run in a warp, runs first) that ``csrc/das.cu`` instantiates
(``launch_shape``), the default first; the others for single-frame launches
only."""

# C signatures of the entry points (csrc/*.cu): pointers and the stream are
# void*, so ctypes passes them at full width.
SIGNATURES = {
    # rf, h (int8 A x A), out, C, A, S, scale, samples of a tile, warps
    # across H's rows, stream
    "decode_int16": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "decode_f32": [_P, _P, _P, _I, _I, _I, _F, _P],
    # A, samples of a tile, warps across H's rows (int16 kernel), int* fits
    "decode_fits": [_I, _I, _I, _P],
    # family, rf, scalars, RCA table, tx_pos, tx_weight, tx_row, out, inco,
    # channels, channel_count, rf_rows, samples, n_tx,
    # nx, ny, nz, gnx, gny, gnz, mode, iq, coherency, frames,
    # transmits per pass of the FORCES index table, run of equal lateral
    # coordinates and transmit walk (HERCULES, RCA), thread shape (voxels,
    # lanes, runs first; HERCULES, RCA), stream
    "das_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _P],
    # family, mode, iq, coherency, frames, n_tx, transmits per pass,
    # thread shape (voxels, lanes, runs first), int* blocks per SM
    "das_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, phasor (cos | sin per pair), taps (re | im), out,
    # rows, S_in, n_out, L, D, int16 input, complex taps, scale, stream
    "demodulate": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, taps (re | im), out,
    # rows, S, n_out, L, D, complex input, complex taps, stream
    "fir": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # microbenchmarks (experiments/): variant, shared memory, src, src2,
    # idx, w, out, reps, steps, stream
    "micro_gather": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    # variant, shared memory, steps, int* blocks a SM, int* grid
    "micro_gather_grid": [_I, _I, _I, _P, _P],
    # K8 form, shared memory, src, src2, idx, w, out, units, steps, stream
    "micro_gather_hermite": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    # B, K8 form, rf, k, wt, out, units, steps, stream
    "micro_onehot": [_I, _I, _P, _P, _P, _P, _I, _I, _P],
    # body, a (int8 K x K), b, out, K, N, scale, stream
    "micro_i8_mma": [_I, _P, _P, _P, _I, _I, _F, _P],
    # body, h, x, out, K, N, stream
    "micro_i8_elementwise": [_I, _P, _P, _P, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or the build failed (message carries its output)."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
            "CUDA kernels of ogl_beamforming_tpu_torch cannot be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libogl_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is not built yet; return its
    path.  The compiler's report (``-Xptxas -v``) is kept beside it as
    ``.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = ""
    failed = None
    for obj, cmd, proc in jobs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, text)
    objs = [obj for obj, _, _ in jobs]
    try:
        if failed is not None:
            code, cmd, text = failed
            raise KernelBuildError(
                f"nvcc failed (exit {code}):\n{' '.join(cmd)}\n{text}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc link failed (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)         # atomic: concurrent builders agree
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")

"""ctypes bindings for the native shared-memory library: the torch port's
counterpart of ``ogl_beamforming_tpu.runtime.abi``.

Mirrors runtime/native/beamformer_abi.h (the port's byte-for-byte copy of
the JAX package's sources, so that a C or MATLAB client built against
``generated/ogl_beamformer_lib.h`` talks to either server unchanged);
struct layouts are cross-checked against the compiled library's
``bf_abi_sizeof_*`` self-description at load time, so Python and C can
never silently disagree (the single-source-of-truth role the reference
delegates to its .meta metaprogram, reference: build.c:4460-4800).

:func:`build_native` compiles ``native/beamformer_lib.c`` at first use with
the C compiler and the flags of ``native/Makefile`` into
``_build/native/`` beside this package, named by a hash of the sources and
flags (as ``kernels/build.library_path`` names the CUDA library), so that
an edited source builds anew.  ``libogl_beamformer_tpu.so`` there links to
the newest build, for C clients (``-logl_beamformer_tpu``).
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..params.constants import (FILTER_SLOTS, MAX_CHANNEL_COUNT,
                                MAX_COMPUTE_SHADER_STAGES,
                                MAX_EMISSIONS_COUNT)

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = NATIVE_DIR.parent.parent / "_build" / "native"
LIB_NAME = "libogl_beamformer_tpu"
SO_PATH = BUILD_DIR / f"{LIB_NAME}.so"
"""The library a client links: a link to the newest build
(:func:`build_native`), whose own name holds its sources' hash."""

# native/Makefile's CFLAGS and LDFLAGS
CFLAGS = ["-O2", "-g", "-Wall", "-Wextra", "-Wno-unused-parameter", "-fPIC",
          "-fvisibility=hidden", "-std=c11"]
LDFLAGS = ["-shared", "-pthread"]
SOURCES = ("beamformer_lib.c", "beamformer_abi.h")


class V2(ct.Structure):
    _fields_ = [("E", ct.c_float * 2)]


class UV2(ct.Structure):
    _fields_ = [("E", ct.c_uint32 * 2)]


class IV4(ct.Structure):
    _fields_ = [("E", ct.c_int32 * 4)]


class M4(ct.Structure):
    _fields_ = [("E", ct.c_float * 16)]   # column-major (reference math.c)


class SineParameters(ct.Structure):
    _fields_ = [("cycles", ct.c_float), ("frequency", ct.c_float)]


class ChirpParameters(ct.Structure):
    _fields_ = [("duration", ct.c_float), ("min_frequency", ct.c_float),
                ("max_frequency", ct.c_float)]


class _EmissionUnion(ct.Union):
    _fields_ = [("sine", SineParameters), ("chirp", ChirpParameters)]


class EmissionParameters(ct.Structure):
    _anonymous_ = ("u",)
    _fields_ = [("kind", ct.c_uint32), ("u", _EmissionUnion)]


class KaiserFilterParameters(ct.Structure):
    _fields_ = [("cutoff_frequency", ct.c_float), ("beta", ct.c_float),
                ("length", ct.c_uint32)]


class MatchedChirpFilterParameters(ct.Structure):
    _fields_ = [("duration", ct.c_float), ("min_frequency", ct.c_float),
                ("max_frequency", ct.c_float)]


class _FilterUnion(ct.Union):
    _fields_ = [("kaiser", KaiserFilterParameters),
                ("matched_chirp", MatchedChirpFilterParameters)]


class FilterParameters(ct.Structure):
    _anonymous_ = ("u",)
    _fields_ = [("kind", ct.c_uint32), ("sampling_frequency", ct.c_float),
                ("complex", ct.c_uint32), ("u", _FilterUnion)]


_PARAM_FIELDS = [
    ("das_voxel_transform", M4),
    ("xdc_transform", M4),
    ("xdc_element_pitch", V2),
    ("raw_data_dimensions", UV2),
    ("focal_vector", V2),
    ("transmit_receive_orientation", ct.c_uint32),
    ("sample_count", ct.c_uint32),
    ("channel_count", ct.c_uint32),
    ("acquisition_count", ct.c_uint32),
    ("acquisition_kind", ct.c_uint32),
    ("decode_mode", ct.c_uint32),
    ("sampling_mode", ct.c_uint32),
    ("time_offset", ct.c_float),
    ("single_focus", ct.c_uint32),
    ("single_orientation", ct.c_uint32),
    ("output_points", IV4),
    ("sampling_frequency", ct.c_float),
    ("demodulation_frequency", ct.c_float),
    ("speed_of_sound", ct.c_float),
    ("f_number", ct.c_float),
    ("interpolation_mode", ct.c_uint32),
    ("coherency_weighting", ct.c_uint32),
    ("decimation_rate", ct.c_uint32),
    ("contrast_mode", ct.c_uint32),
    ("emission_parameters", EmissionParameters),
    ("readi_group_count", ct.c_uint32),
    ("readi_group", ct.c_uint32),
]


class CParameters(ct.Structure):
    _fields_ = _PARAM_FIELDS


class CSimpleParameters(ct.Structure):
    _fields_ = [
        ("parameters", CParameters),
        ("channel_mapping", ct.c_int16 * MAX_CHANNEL_COUNT),
        ("sparse_elements", ct.c_int16 * MAX_EMISSIONS_COUNT),
        ("transmit_receive_orientations", ct.c_uint8 * MAX_EMISSIONS_COUNT),
        ("steering_angles", ct.c_float * MAX_EMISSIONS_COUNT),
        ("focal_depths", ct.c_float * MAX_EMISSIONS_COUNT),
        ("compute_stages", ct.c_int32 * MAX_COMPUTE_SHADER_STAGES),
        ("compute_stage_parameters", ct.c_int32 * MAX_COMPUTE_SHADER_STAGES),
        ("compute_stages_count", ct.c_uint32),
        ("data_kind", ct.c_uint32),
    ]


class CLiveImagingParameters(ct.Structure):
    _fields_ = [
        ("active", ct.c_uint32),
        ("save_enabled", ct.c_uint32),
        ("save_active", ct.c_uint32),
        ("acquisition_kind", ct.c_uint32),
        ("acquisition_kind_enabled_flags", ct.c_uint64),
        ("transmit_power", ct.c_float),
        ("image_plane_offsets", ct.c_float * 4),
        ("tgc_control_points", ct.c_float * 8),
        ("save_name_tag_length", ct.c_int32),
        ("save_name_tag", ct.c_uint8 * 128),
    ]


class CStatsTable(ct.Structure):
    _fields_ = [
        ("shader_ids", ct.c_int32 * 16),
        ("times", (ct.c_float * 16) * 32),
        ("rf_time_deltas", ct.c_float * 32),
    ]


class CWork(ct.Structure):
    _fields_ = [
        ("kind", ct.c_uint32),
        ("parameter_block", ct.c_uint32),
        ("view_plane", ct.c_uint32),
        ("arg0", ct.c_uint32),
        ("arg1", ct.c_uint64),
    ]


class CParameterBlock(ct.Structure):
    _fields_ = [
        ("parameters", CParameters),
        ("channel_mapping", ct.c_int16 * MAX_CHANNEL_COUNT),
        ("sparse_elements", ct.c_int16 * MAX_EMISSIONS_COUNT),
        ("focal_vectors", (ct.c_float * 2) * MAX_EMISSIONS_COUNT),
        ("transmit_receive_orientations", ct.c_uint8 * MAX_EMISSIONS_COUNT),
        ("pipeline_shaders", ct.c_int32 * MAX_COMPUTE_SHADER_STAGES),
        ("pipeline_parameters", ct.c_int32 * MAX_COMPUTE_SHADER_STAGES),
        ("pipeline_count", ct.c_uint32),
        ("data_kind", ct.c_uint32),
        ("filters", FilterParameters * FILTER_SLOTS),
        ("filter_valid_mask", ct.c_uint32),
        ("dirty_regions", ct.c_uint32),
    ]


class WorkKind:
    NONE = 0
    COMPUTE_INDIRECT = 1
    EXPORT_FRAMES = 2
    EXPORT_STATS = 3
    SHUTDOWN = 4


class Region:
    PARAMETERS = 1 << 0
    CHANNEL_MAPPING = 1 << 1
    SPARSE_ELEMENTS = 1 << 2
    FOCAL_VECTORS = 1 << 3
    ORIENTATIONS = 1 << 4
    PIPELINE = 1 << 5
    FILTERS = 1 << 6


def find_cc() -> str:
    """The C compiler: ``$CC``, else ``cc``, else ``gcc`` on the PATH."""
    for name in (os.environ.get("CC"), "cc", "gcc"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C compiler (neither $CC, cc nor gcc on the "
                       "PATH): the native library cannot be built")


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CFLAGS + LDFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"{LIB_NAME}_{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Path:
    """Compile the library if its sources' build is missing, or with
    ``force`` in any case; return its path.  :data:`SO_PATH` beside it is
    pointed at it."""
    out = library_path()
    if force or not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_cc(), *CFLAGS, str(NATIVE_DIR / "beamformer_lib.c"),
               *LDFLAGS, "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native library build failed (exit "
                               f"{proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)         # atomic: concurrent builds agree
    link = BUILD_DIR / f"{LIB_NAME}.so"       # SO_PATH
    if not link.is_symlink() or os.readlink(link) != out.name:
        tmp_link = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}.link"
        tmp_link.unlink(missing_ok=True)
        tmp_link.symlink_to(out.name)
        os.replace(tmp_link, link)
    return out


def load_library(path: os.PathLike | None = None) -> ct.CDLL:
    lib = ct.CDLL(str(path or build_native()))

    lib.beamformer_get_api_version.restype = ct.c_uint32
    lib.beamformer_get_last_error.restype = ct.c_int32
    lib.beamformer_get_last_error_string.restype = ct.c_char_p
    lib.beamformer_error_string.restype = ct.c_char_p
    lib.beamformer_error_string.argtypes = [ct.c_int32]
    lib.beamformer_maximum_rf_data_size.restype = ct.c_uint64
    lib.beamformer_maximum_frames_for_parameters.restype = ct.c_uint64
    lib.beamformer_maximum_frames_for_parameters.argtypes = [ct.POINTER(CParameters)]
    lib.beamformer_beamform_data.argtypes = [
        ct.POINTER(CSimpleParameters), ct.c_void_p, ct.c_uint32, ct.c_void_p,
        ct.c_int32]
    lib.beamformer_beamform_data.restype = ct.c_uint32
    lib.beamformer_push_data_with_compute.argtypes = [
        ct.c_void_p, ct.c_uint32, ct.c_uint32, ct.c_uint32]
    lib.beamformer_push_data_with_compute.restype = ct.c_uint32
    lib.beamformer_get_last_frames.argtypes = [ct.c_void_p, ct.c_uint64,
                                               ct.c_uint32]
    lib.beamformer_get_last_frames.restype = ct.c_uint32
    lib.beamformer_compute_timings.argtypes = [ct.POINTER(CStatsTable),
                                               ct.c_int32]
    lib.beamformer_compute_timings.restype = ct.c_uint32

    lib.bf_server_create.argtypes = [ct.c_uint64]
    lib.bf_server_create.restype = ct.c_void_p
    lib.bf_server_wait_work.argtypes = [ct.POINTER(CWork), ct.c_int32]
    lib.bf_server_wait_work.restype = ct.c_int32
    lib.bf_server_scratch.argtypes = [ct.POINTER(ct.c_uint64)]
    lib.bf_server_scratch.restype = ct.POINTER(ct.c_uint8)
    lib.bf_server_block.argtypes = [ct.c_uint32]
    lib.bf_server_block.restype = ct.POINTER(CParameterBlock)
    lib.bf_server_take_dirty.argtypes = [ct.c_uint32]
    lib.bf_server_take_dirty.restype = ct.c_uint32
    lib.bf_server_rf_info.restype = ct.c_uint64
    lib.bf_server_set_export.argtypes = [ct.c_uint64, ct.c_int64]
    lib.bf_server_stats.restype = ct.POINTER(CStatsTable)
    lib.beamformer_get_live_parameters.restype = \
        ct.POINTER(CLiveImagingParameters)
    lib.beamformer_set_live_parameters.argtypes = \
        [ct.POINTER(CLiveImagingParameters)]
    lib.beamformer_set_live_parameters.restype = ct.c_uint32
    lib.beamformer_live_parameters_get_dirty_flag.restype = ct.c_int32
    lib.bf_server_live.argtypes = [ct.POINTER(ct.POINTER(ct.c_uint32))]
    lib.bf_server_live.restype = ct.POINTER(CLiveImagingParameters)
    lib.bf_server_mark_live_dirty.argtypes = [ct.c_uint32]

    # ABI consistency: sizes must agree between C and ctypes.
    checks = {
        "bf_abi_sizeof_parameters": CParameters,
        "bf_abi_sizeof_simple_parameters": CSimpleParameters,
        "bf_abi_sizeof_filter_parameters": FilterParameters,
        "bf_abi_sizeof_live_parameters": CLiveImagingParameters,
        "bf_abi_sizeof_stats_table": CStatsTable,
        "bf_abi_sizeof_work": CWork,
        "bf_abi_sizeof_parameter_block": CParameterBlock,
    }
    for fname, struct in checks.items():
        getattr(lib, fname).restype = ct.c_uint64
        c_size = getattr(lib, fname)()
        py_size = ct.sizeof(struct)
        if c_size != py_size:
            raise RuntimeError(
                f"ABI mismatch: {fname} C={c_size} ctypes={py_size}")
    return lib

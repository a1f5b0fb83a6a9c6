"""Client-header code generation: the port's copy of
``ogl_beamforming_tpu.params.codegen``, emitting byte for byte the tracked
``generated/ogl_beamformer_lib.h`` and ``generated/matlab/*.m``.

The reference single-sources its ABI in a ``.meta`` DSL and generates the C
client header + MATLAB bindings (reference: build.c:4460-4800,
beamformer.meta).  Here the Python schema (params/enums.py, params/types.py)
is the single source; this module emits the drop-in C client header
``ogl_beamformer_lib.h`` (same surface as the reference's generated header,
lib/ogl_beamformer_lib_base.h) and MATLAB class wrappers.

Layout correctness is enforced twice: the emitted structs mirror
runtime/native/beamformer_abi.h, and runtime/abi.py cross-checks ctypes
sizes against the compiled library at load time.
"""

from __future__ import annotations

import enum
from pathlib import Path

from . import constants
from .enums import (AcquisitionKind, ContrastMode, DataKind, DecodeMode,
                    EmissionKind, ErrorKind, FilterKind, InterpolationMode,
                    LiveImagingDirtyFlags, RCAOrientation, SamplingMode,
                    ShaderKind, ViewPlaneTag)

_ENUMS = [ShaderKind, DataKind, AcquisitionKind, DecodeMode, SamplingMode,
          ContrastMode, EmissionKind, InterpolationMode, ViewPlaneTag,
          FilterKind, RCAOrientation, ErrorKind]

_CONSTANTS = [
    ("BeamformerChunkChannelCount", constants.CHUNK_CHANNEL_COUNT),
    ("BeamformerFilterSlots", constants.FILTER_SLOTS),
    ("BeamformerMaxBacklogFrames", constants.MAX_BACKLOG_FRAMES),
    ("BeamformerMaxChannelCount", constants.MAX_CHANNEL_COUNT),
    ("BeamformerMaxEmissionsCount", constants.MAX_EMISSIONS_COUNT),
    ("BeamformerMaxComputeShaderStages", constants.MAX_COMPUTE_SHADER_STAGES),
    ("BeamformerMaxParameterBlocks", constants.MAX_PARAMETER_BLOCKS),
    ("BeamformerMaxRawDataFramesInFlight",
     constants.MAX_RAW_DATA_FRAMES_IN_FLIGHT),
    ("BeamformerMaxHadamardElements", constants.MAX_HADAMARD_ELEMENTS),
]

_ENUM_C_NAMES = {
    ShaderKind: "BeamformerShaderKind",
    DataKind: "BeamformerDataKind",
    AcquisitionKind: "BeamformerAcquisitionKind",
    DecodeMode: "BeamformerDecodeMode",
    SamplingMode: "BeamformerSamplingMode",
    ContrastMode: "BeamformerContrastMode",
    EmissionKind: "BeamformerEmissionKind",
    InterpolationMode: "BeamformerInterpolationMode",
    ViewPlaneTag: "BeamformerViewPlaneTag",
    FilterKind: "BeamformerFilterKind",
    RCAOrientation: "BeamformerRCAOrientation",
    ErrorKind: "BeamformerLibErrorKind",
}

# Python member -> reference C member spelling where they differ
_MEMBER_NAMES = {
    "NoDecode": "None", "NoContrast": "None", "NoOrientation": "None",
    "NoError": "None", "X2": "2X", "X4": "4X",
}


def _emit_enum(e) -> str:
    name = _ENUM_C_NAMES[e]
    lines = [f"typedef enum {{"]
    for member in e:
        mname = _MEMBER_NAMES.get(member.name, member.name)
        lines.append(f"\t{name}_{mname} = {int(member)},")
    lines.append(f"\t{name}_Count,")
    lines.append(f"}} {name};")
    return "\n".join(lines)


_STRUCTS = r"""
typedef struct { float cycles; float frequency; } BeamformerSineParameters;
typedef struct { float duration; float min_frequency; float max_frequency; } BeamformerChirpParameters;

typedef struct {
	BeamformerEmissionKind kind;
	union {
		BeamformerSineParameters  sine;
		BeamformerChirpParameters chirp;
	};
} BeamformerEmissionParameters;

typedef struct { float cutoff_frequency; float beta; uint32_t length; } BeamformerKaiserFilterParameters;
typedef struct { float duration; float min_frequency; float max_frequency; } BeamformerMatchedChirpFilterParameters;

typedef struct {
	BeamformerFilterKind kind;
	float                sampling_frequency;
	uint32_t             complex;
	union {
		BeamformerKaiserFilterParameters       kaiser;
		BeamformerMatchedChirpFilterParameters matched_chirp;
	};
} BeamformerFilterParameters;

typedef struct {
	float    das_voxel_transform[16];  /* column major */
	float    xdc_transform[16];        /* column major */
	float    xdc_element_pitch[2];
	uint32_t raw_data_dimensions[2];
	float    focal_vector[2];          /* (degrees, meters); depth = INFINITY -> plane wave */
	uint32_t transmit_receive_orientation;
	uint32_t sample_count;
	uint32_t channel_count;
	uint32_t acquisition_count;
	BeamformerAcquisitionKind acquisition_kind;
	BeamformerDecodeMode      decode_mode;
	BeamformerSamplingMode    sampling_mode;
	float    time_offset;
	uint32_t single_focus;
	uint32_t single_orientation;
	int32_t  output_points[4];         /* (x, y, z, average_frames) */
	float    sampling_frequency;
	float    demodulation_frequency;
	float    speed_of_sound;
	float    f_number;
	BeamformerInterpolationMode interpolation_mode;
	uint32_t coherency_weighting;
	uint32_t decimation_rate;
	BeamformerContrastMode       contrast_mode;
	BeamformerEmissionParameters emission_parameters;
	uint32_t readi_group_count;
	uint32_t readi_group;
} BeamformerParameters;

typedef struct {
	BeamformerParameters parameters;
	int16_t  channel_mapping[BeamformerMaxChannelCount];
	int16_t  sparse_elements[BeamformerMaxEmissionsCount];
	uint8_t  transmit_receive_orientations[BeamformerMaxEmissionsCount];
	float    steering_angles[BeamformerMaxEmissionsCount];
	float    focal_depths[BeamformerMaxEmissionsCount];
	int32_t  compute_stages[BeamformerMaxComputeShaderStages];
	int32_t  compute_stage_parameters[BeamformerMaxComputeShaderStages];
	uint32_t compute_stages_count;
	BeamformerDataKind data_kind;
} BeamformerSimpleParameters;

typedef struct {
	uint32_t active;
	uint32_t save_enabled;
	uint32_t save_active;
	uint32_t acquisition_kind;
	uint64_t acquisition_kind_enabled_flags;
	float    transmit_power;
	float    image_plane_offsets[BeamformerViewPlaneTag_Count];
	float    tgc_control_points[8];
	int32_t  save_name_tag_length;
	uint8_t  save_name_tag[128];
} BeamformerLiveImagingParameters;

typedef struct {
	int32_t shader_ids[16];
	float   times[32][16];
	float   rf_time_deltas[32];
} BeamformerComputeStatsTable;
"""

_PROTOTYPES = r"""
uint32_t beamformer_get_api_version(void);
int32_t  beamformer_get_last_error(void);
const char *beamformer_get_last_error_string(void);
const char *beamformer_error_string(int32_t kind);
void     beamformer_set_global_timeout(uint32_t timeout_ms);

uint64_t beamformer_maximum_frames_for_parameters(BeamformerParameters *);
uint64_t beamformer_maximum_frames_for_simple_parameters(BeamformerSimpleParameters *);
uint64_t beamformer_maximum_rf_data_size(void);

uint32_t beamformer_beamform_data(BeamformerSimpleParameters *bp, void *data,
                                  uint32_t data_size, void *out_data,
                                  int32_t timeout_ms);

uint32_t beamformer_push_data_with_compute(void *data, uint32_t size,
                                           uint32_t image_plane_tag,
                                           uint32_t parameter_slot);
uint32_t beamformer_get_last_frames(void *out_data, uint64_t out_data_size,
                                    uint32_t count);
uint32_t beamformer_compute_timings(BeamformerComputeStatsTable *out,
                                    int32_t timeout_ms);

uint32_t beamformer_reserve_parameter_blocks(uint32_t count);
uint32_t beamformer_set_pipeline_stage_parameters(uint32_t stage_index, int32_t parameter);
uint32_t beamformer_set_pipeline_stage_parameters_at(uint32_t stage_index, int32_t parameter, uint32_t parameter_slot);
uint32_t beamformer_push_pipeline(int32_t *shaders, uint32_t shader_count, uint32_t data_kind);
uint32_t beamformer_push_pipeline_at(int32_t *shaders, uint32_t shader_count, uint32_t data_kind, uint32_t parameter_slot);
uint32_t beamformer_push_simple_parameters(BeamformerSimpleParameters *);
uint32_t beamformer_push_simple_parameters_at(BeamformerSimpleParameters *, uint32_t parameter_slot);
uint32_t beamformer_push_parameters(BeamformerParameters *);
uint32_t beamformer_push_parameters_at(BeamformerParameters *, uint32_t parameter_slot);
uint32_t beamformer_push_channel_mapping(int16_t *mapping, uint32_t count);
uint32_t beamformer_push_channel_mapping_at(int16_t *mapping, uint32_t count, uint32_t parameter_slot);
uint32_t beamformer_push_sparse_elements(int16_t *elements, uint32_t count);
uint32_t beamformer_push_sparse_elements_at(int16_t *elements, uint32_t count, uint32_t parameter_slot);
uint32_t beamformer_push_focal_vectors(float *vectors, uint32_t count);
uint32_t beamformer_push_focal_vectors_at(float *vectors, uint32_t count, uint32_t parameter_slot);
uint32_t beamformer_push_transmit_receive_orientations(uint8_t *values, uint32_t count);
uint32_t beamformer_push_transmit_receive_orientations_at(uint8_t *values, uint32_t count, uint32_t parameter_slot);
uint32_t beamformer_create_filter(BeamformerFilterParameters *filter,
                                  uint8_t filter_slot, uint8_t parameter_block);

int32_t  beamformer_live_parameters_get_dirty_flag(void);
uint32_t beamformer_set_live_parameters(BeamformerLiveImagingParameters *);
BeamformerLiveImagingParameters *beamformer_get_live_parameters(void);
"""


def generate_c_header() -> str:
    parts = [
        "/* ogl_beamforming_tpu client library — GENERATED from the Python",
        " * schema (ogl_beamforming_tpu/params); API-compatible with the",
        " * reference ogl_beamformer_lib surface. */",
        "#ifndef OGL_BEAMFORMER_LIB_H",
        "#define OGL_BEAMFORMER_LIB_H",
        "",
        "#include <stdint.h>",
        "",
    ]
    for name, value in _CONSTANTS:
        parts.append(f"#define {name} ({value})")
    parts.append("")
    for e in _ENUMS:
        parts.append(_emit_enum(e))
        parts.append("")
    parts.append(_STRUCTS)
    parts.append(_PROTOTYPES)
    parts.append("#endif /* OGL_BEAMFORMER_LIB_H */")
    return "\n".join(parts)


def generate_matlab_class(struct_name: str, fields: list[tuple[str, str]]
                          ) -> str:
    lines = [f"classdef {struct_name}", "properties"]
    for fname, init in fields:
        lines.append(f"\t{fname} {init}")
    lines += ["end", "end"]
    return "\n".join(lines)


_MATLAB_SIMPLE_FIELDS = [
    # (name, matlab initializer) — mirrors BeamformerSimpleParameters
    ("das_voxel_transform", "(1,16) single = zeros(1,16,'single')"),
    ("xdc_transform", "(1,16) single = single(reshape(eye(4),1,16))"),
    ("xdc_element_pitch", "(1,2) single = zeros(1,2,'single')"),
    ("raw_data_dimensions", "(1,2) uint32 = zeros(1,2,'uint32')"),
    ("focal_vector", "(1,2) single = zeros(1,2,'single')"),
    ("transmit_receive_orientation", "(1,1) uint32 = 0"),
    ("sample_count", "(1,1) uint32 = 0"),
    ("channel_count", "(1,1) uint32 = 0"),
    ("acquisition_count", "(1,1) uint32 = 0"),
    ("acquisition_kind", "(1,1) uint32 = 0"),
    ("decode_mode", "(1,1) uint32 = 1"),
    ("sampling_mode", "(1,1) uint32 = 0"),
    ("time_offset", "(1,1) single = 0"),
    ("single_focus", "(1,1) uint32 = 1"),
    ("single_orientation", "(1,1) uint32 = 1"),
    ("output_points", "(1,4) int32 = zeros(1,4,'int32')"),
    ("sampling_frequency", "(1,1) single = 0"),
    ("demodulation_frequency", "(1,1) single = 0"),
    ("speed_of_sound", "(1,1) single = 1540"),
    ("f_number", "(1,1) single = 1"),
    ("interpolation_mode", "(1,1) uint32 = 1"),
    ("coherency_weighting", "(1,1) uint32 = 0"),
    ("decimation_rate", "(1,1) uint32 = 1"),
    ("contrast_mode", "(1,1) uint32 = 0"),
    ("emission_kind", "(1,1) uint32 = 0"),
    ("emission_parameters", "(1,3) single = zeros(1,3,'single')"),
    ("readi_group_count", "(1,1) uint32 = 0"),
    ("readi_group", "(1,1) uint32 = 0"),
    ("channel_mapping", "(1,256) int16 = int16(0:255)"),
    ("sparse_elements", "(1,256) int16 = zeros(1,256,'int16')"),
    ("transmit_receive_orientations", "(1,256) uint8 = zeros(1,256,'uint8')"),
    ("steering_angles", "(1,256) single = zeros(1,256,'single')"),
    ("focal_depths", "(1,256) single = zeros(1,256,'single')"),
    ("compute_stages", "(1,16) int32 = zeros(1,16,'int32')"),
    ("compute_stage_parameters", "(1,16) int32 = zeros(1,16,'int32')"),
    ("compute_stages_count", "(1,1) uint32 = 0"),
    ("data_kind", "(1,1) uint32 = 0"),
]


def generate_matlab_bindings() -> dict[str, str]:
    """MATLAB class files mirroring the reference's generated helpers
    (build.c:5178-5237): enum classes, the simple-parameters struct class,
    and a calllib wrapper for the shared library."""
    out = {}
    for e in _ENUMS[:-1]:
        name = "OGLBeamformer" + e.__name__
        lines = [f"classdef {name} < int32", "\tenumeration"]
        for m in e:
            mname = _MEMBER_NAMES.get(m.name, m.name)
            ident = mname if mname[0].isalpha() else "x" + mname
            lines.append(f"\t\t{ident} ({int(m)})")
        lines += ["\tend", "end"]
        out[name + ".m"] = "\n".join(lines)

    lines = ["classdef OGLBeamformerSimpleParameters", "properties"]
    for fname, init in _MATLAB_SIMPLE_FIELDS:
        lines.append(f"\t{fname} {init};")
    lines += ["end", "methods",
              "\tfunction bytes = serialize(obj)",
              "\t\t% Packs fields in BeamformerSimpleParameters layout.",
              "\t\tbytes = [];",
              ]
    for fname, init in _MATLAB_SIMPLE_FIELDS:
        lines.append(f"\t\tbytes = [bytes, typecast(obj.{fname}, 'uint8')];")
    lines += ["\tend", "end", "end"]
    out["OGLBeamformerSimpleParameters.m"] = "\n".join(lines)

    out["OGLBeamformer.m"] = "\n".join([
        "classdef OGLBeamformer < handle",
        "% calllib wrapper over libogl_beamformer_tpu (same API surface as",
        "% the reference's ogl_beamformer MATLAB bindings).",
        "methods (Static)",
        "\tfunction load(libpath, hdrpath)",
        "\t\tif ~libisloaded('libogl_beamformer_tpu')",
        "\t\t\tloadlibrary(libpath, hdrpath, 'alias', 'libogl_beamformer_tpu');",
        "\t\tend",
        "\tend",
        "\tfunction v = api_version()",
        "\t\tv = calllib('libogl_beamformer_tpu', 'beamformer_get_api_version');",
        "\tend",
        "\tfunction ok = beamform_data(sp, data, out)",
        "\t\tok = calllib('libogl_beamformer_tpu', 'beamformer_beamform_data', ...",
        "\t\t\tsp, data, uint32(numel(data) * 2), out, int32(-1));",
        "\tend",
        "\tfunction s = last_error()",
        "\t\ts = calllib('libogl_beamformer_tpu', 'beamformer_get_last_error_string');",
        "\tend",
        "end", "end"])
    return out


def write_generated(directory) -> list[Path]:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    written = []
    header = directory / "ogl_beamformer_lib.h"
    header.write_text(generate_c_header())
    written.append(header)
    matlab_dir = directory / "matlab"
    matlab_dir.mkdir(exist_ok=True)
    for fname, text in generate_matlab_bindings().items():
        p = matlab_dir / fname
        p.write_text(text)
        written.append(p)
    return written


if __name__ == "__main__":
    import sys
    if len(sys.argv) != 2:
        sys.exit("usage: python -m ogl_beamforming_tpu_torch.params.codegen "
                 "DIRECTORY")
    for p in write_generated(sys.argv[1]):
        print(p)

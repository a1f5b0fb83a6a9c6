/* ogl_beamforming_tpu — native shared-memory ABI.
 *
 * Client-facing structs and enums are binary-compatible with the reference
 * ogl_beamformer_lib ABI (reference: generated/beamformer.c, single-sourced
 * from beamformer.meta) so that existing client programs (C, MATLAB) work
 * against this library unchanged.  The shared-memory *internal* layout
 * (BfSharedMemory) is this framework's own, carried behind the same API.
 */
#ifndef BEAMFORMER_TPU_ABI_H
#define BEAMFORMER_TPU_ABI_H

#include <stdint.h>

typedef uint8_t  u8;
typedef int16_t  i16;
typedef uint16_t u16;
typedef int32_t  i32;
typedef uint32_t u32;
typedef int64_t  i64;
typedef uint64_t u64;
typedef float    f32;
typedef u32      b32;

/* ---- constants (beamformer.meta:1-9) ---- */
#define BeamformerChunkChannelCount        (16)
#define BeamformerFilterSlots              (4)
#define BeamformerMaxBacklogFrames         (4096)
#define BeamformerMaxChannelCount          (256)
#define BeamformerMaxEmissionsCount        (256)
#define BeamformerMaxComputeShaderStages   (16)
#define BeamformerMaxParameterBlocks       (16)
#define BeamformerMaxRawDataFramesInFlight (3)
#define BeamformerMaxHadamardElements      (65536)

#define BF_TPU_API_VERSION (34u)

/* ---- enums (values match generated/beamformer.c:16-166) ---- */
typedef enum {
	BeamformerShaderKind_Decode             = 0,
	BeamformerShaderKind_Filter             = 1,
	BeamformerShaderKind_Demodulate         = 2,
	BeamformerShaderKind_DAS                = 3,
	BeamformerShaderKind_Sum                = 4,
	BeamformerShaderKind_MinMax             = 5,
	BeamformerShaderKind_Hilbert            = 6,
	BeamformerShaderKind_CoherencyWeighting = 7,
	BeamformerShaderKind_Reshape            = 8,
	BeamformerShaderKind_RenderBeamformed   = 9,
	BeamformerShaderKind_Count,
} BeamformerShaderKind;

typedef enum {
	BeamformerDataKind_Int16          = 0,
	BeamformerDataKind_Int16Complex   = 1,
	BeamformerDataKind_Float32        = 2,
	BeamformerDataKind_Float32Complex = 3,
	BeamformerDataKind_Float16        = 4,
	BeamformerDataKind_Float16Complex = 5,
	BeamformerDataKind_Count,
} BeamformerDataKind;

typedef enum {
	BeamformerAcquisitionKind_FORCES         = 0,
	BeamformerAcquisitionKind_UFORCES        = 1,
	BeamformerAcquisitionKind_HERCULES       = 2,
	BeamformerAcquisitionKind_RCA_VLS        = 3,
	BeamformerAcquisitionKind_RCA_TPW        = 4,
	BeamformerAcquisitionKind_UHERCULES      = 5,
	BeamformerAcquisitionKind_RACES          = 6,
	BeamformerAcquisitionKind_EPIC_FORCES    = 7,
	BeamformerAcquisitionKind_EPIC_UFORCES   = 8,
	BeamformerAcquisitionKind_EPIC_UHERCULES = 9,
	BeamformerAcquisitionKind_Flash          = 10,
	BeamformerAcquisitionKind_HERO_PA        = 11,
	BeamformerAcquisitionKind_ULM            = 12,
	BeamformerAcquisitionKind_Count,
} BeamformerAcquisitionKind;

typedef enum { BeamformerDecodeMode_None = 0, BeamformerDecodeMode_Hadamard = 1, BeamformerDecodeMode_Walsh = 2 } BeamformerDecodeMode;
typedef enum { BeamformerSamplingMode_2X = 0, BeamformerSamplingMode_4X = 1 } BeamformerSamplingMode;
typedef enum { BeamformerContrastMode_None = 0, BeamformerContrastMode_A1S2 = 1 } BeamformerContrastMode;
typedef enum { BeamformerEmissionKind_Sine = 0, BeamformerEmissionKind_Chirp = 1 } BeamformerEmissionKind;
typedef enum {
	BeamformerInterpolationMode_Nearest = 0,
	BeamformerInterpolationMode_Linear  = 1,
	BeamformerInterpolationMode_Cubic   = 2,
} BeamformerInterpolationMode;
typedef enum {
	BeamformerViewPlaneTag_XZ = 0, BeamformerViewPlaneTag_YZ = 1,
	BeamformerViewPlaneTag_XY = 2, BeamformerViewPlaneTag_Arbitrary = 3,
	BeamformerViewPlaneTag_Count,
} BeamformerViewPlaneTag;
typedef enum { BeamformerFilterKind_Kaiser = 0, BeamformerFilterKind_MatchedChirp = 1 } BeamformerFilterKind;

/* lib/ogl_beamformer_lib_base.h:10-34 */
typedef enum {
	BeamformerLibErrorKind_None                        = 0,
	BeamformerLibErrorKind_VersionMismatch             = 1,
	BeamformerLibErrorKind_InvalidAccess               = 2,
	BeamformerLibErrorKind_ParameterBlockOverflow      = 3,
	BeamformerLibErrorKind_ParameterBlockUnallocated   = 4,
	BeamformerLibErrorKind_ComputeStageOverflow        = 5,
	BeamformerLibErrorKind_InvalidComputeStage         = 6,
	BeamformerLibErrorKind_InvalidStartShader          = 7,
	BeamformerLibErrorKind_InvalidDemodulationDataKind = 8,
	BeamformerLibErrorKind_InvalidImagePlane           = 9,
	BeamformerLibErrorKind_InvalidFilterKind           = 10,
	BeamformerLibErrorKind_InvalidDataKind             = 11,
	BeamformerLibErrorKind_InvalidContrastMode         = 12,
	BeamformerLibErrorKind_BufferOverflow              = 13,
	BeamformerLibErrorKind_DataSizeMismatch            = 14,
	BeamformerLibErrorKind_WorkQueueFull               = 15,
	BeamformerLibErrorKind_ExportSpaceOverflow         = 16,
	BeamformerLibErrorKind_SharedMemory                = 17,
	BeamformerLibErrorKind_SyncVariable                = 18,
	BeamformerLibErrorKind_FrameSizeOverflow           = 19,
	BeamformerLibErrorKind_RFDataSizeOverflow          = 20,
} BeamformerLibErrorKind;

/* ---- vector types (base_types.h layout: plain arrays) ---- */
typedef struct { f32 E[4];  } bf_v4;
typedef struct { f32 E[2];  } bf_v2;
typedef struct { u32 E[2];  } bf_uv2;
typedef struct { i32 E[4];  } bf_iv4;
typedef struct { f32 E[16]; } bf_m4;   /* column-major (math.c m4) */

/* ---- parameter structs (generated/beamformer.c:296-520) ---- */
typedef struct { f32 cycles; f32 frequency; } BeamformerSineParameters;
typedef struct { f32 duration; f32 min_frequency; f32 max_frequency; } BeamformerChirpParameters;

typedef struct {
	u32 kind;                           /* BeamformerEmissionKind */
	union {
		BeamformerSineParameters  sine;
		BeamformerChirpParameters chirp;
	};
} BeamformerEmissionParameters;

typedef struct { f32 cutoff_frequency; f32 beta; u32 length; } BeamformerKaiserFilterParameters;
typedef struct { f32 duration; f32 min_frequency; f32 max_frequency; } BeamformerMatchedChirpFilterParameters;

typedef struct {
	u32 kind;                           /* BeamformerFilterKind */
	f32 sampling_frequency;
	b32 complex;
	union {
		BeamformerKaiserFilterParameters       kaiser;
		BeamformerMatchedChirpFilterParameters matched_chirp;
	};
} BeamformerFilterParameters;

typedef struct {
	bf_m4  das_voxel_transform;
	bf_m4  xdc_transform;
	bf_v2  xdc_element_pitch;
	bf_uv2 raw_data_dimensions;
	bf_v2  focal_vector;
	u32    transmit_receive_orientation;
	u32    sample_count;
	u32    channel_count;
	u32    acquisition_count;
	u32    acquisition_kind;
	u32    decode_mode;
	u32    sampling_mode;
	f32    time_offset;
	b32    single_focus;
	b32    single_orientation;
	bf_iv4 output_points;
	f32    sampling_frequency;
	f32    demodulation_frequency;
	f32    speed_of_sound;
	f32    f_number;
	u32    interpolation_mode;
	b32    coherency_weighting;
	u32    decimation_rate;
	u32    contrast_mode;
	BeamformerEmissionParameters emission_parameters;
	u32    readi_group_count;
	u32    readi_group;
} BeamformerParameters;

typedef struct {
	BeamformerParameters parameters;    /* anonymous-expanded in reference */
	i16 channel_mapping[BeamformerMaxChannelCount];
	i16 sparse_elements[BeamformerMaxEmissionsCount];
	u8  transmit_receive_orientations[BeamformerMaxEmissionsCount];
	f32 steering_angles[BeamformerMaxEmissionsCount];
	f32 focal_depths[BeamformerMaxEmissionsCount];
	i32 compute_stages[BeamformerMaxComputeShaderStages];
	i32 compute_stage_parameters[BeamformerMaxComputeShaderStages];
	u32 compute_stages_count;
	u32 data_kind;
} BeamformerSimpleParameters;

typedef struct {
	u32 active;
	u32 save_enabled;
	u32 save_active;
	u32 acquisition_kind;
	u64 acquisition_kind_enabled_flags;
	f32 transmit_power;
	f32 image_plane_offsets[BeamformerViewPlaneTag_Count];
	f32 tgc_control_points[8];
	i32 save_name_tag_length;
	u8  save_name_tag[128];
} BeamformerLiveImagingParameters;

/* beamformer_compute_stats.c:3-10 */
#define BeamformerComputeStatsFrames (32)
#define BeamformerComputeStatsStages (16)
typedef struct {
	i32 shader_ids[BeamformerComputeStatsStages];
	f32 times[BeamformerComputeStatsFrames][BeamformerComputeStatsStages];
	f32 rf_time_deltas[BeamformerComputeStatsFrames];
} BeamformerComputeStatsTable;

/* ------------------------------------------------------------------ */
/* Internal shared-memory layout (this framework's own, version-tagged) */
/* ------------------------------------------------------------------ */

typedef enum {
	BfWork_None           = 0,
	BfWork_ComputeIndirect = 1,   /* compute using RF in scratch */
	BfWork_ExportFrames    = 2,   /* write last-N frames into scratch */
	BfWork_ExportStats     = 3,   /* write stats table into scratch */
	BfWork_Shutdown        = 4,
} BfWorkKind;

typedef struct {
	u32 kind;
	u32 parameter_block;
	u32 view_plane;
	u32 arg0;                     /* e.g. export frame count */
	u64 arg1;                     /* e.g. rf byte size */
} BfWork;

#define BfWorkQueueCapacity (64)

typedef struct {
	/* widx in high 32 bits, ridx in low 32.  Multi-producer/single-consumer
	 * ring: producers CAS-claim a widx slot, write the entry, then
	 * release-publish commit[slot] = widx + 1; the consumer treats a slot
	 * whose commit value != ridx + 1 as not-yet-written (claim/commit split,
	 * same idea as the reference's beamformer_shared_memory.c:190-218). */
	_Atomic u64 state;
	_Atomic u32 commit[BfWorkQueueCapacity];
	BfWork entries[BfWorkQueueCapacity];
} BfWorkQueue;

typedef enum {
	BfLock_UploadRF        = 0,
	BfLock_ScratchSpace    = 1,
	BfLock_DispatchCompute = 2,   /* futex the server sleeps on */
	BfLock_ExportSync      = 3,
	BfLock_Parameters      = 4,
	BfLock_Live            = 5,
	BfLock_Count,
} BfLockKind;

typedef struct {
	BeamformerParameters parameters;
	i16 channel_mapping[BeamformerMaxChannelCount];
	i16 sparse_elements[BeamformerMaxEmissionsCount];
	f32 focal_vectors[BeamformerMaxEmissionsCount][2];
	u8  transmit_receive_orientations[BeamformerMaxEmissionsCount];
	i32 pipeline_shaders[BeamformerMaxComputeShaderStages];
	i32 pipeline_parameters[BeamformerMaxComputeShaderStages];
	u32 pipeline_count;
	u32 data_kind;
	BeamformerFilterParameters filters[BeamformerFilterSlots];
	u32 filter_valid_mask;
	_Atomic u32 dirty_regions;    /* BfRegion flags */
} BfParameterBlock;

typedef enum {
	BfRegion_Parameters     = 1u << 0,
	BfRegion_ChannelMapping = 1u << 1,
	BfRegion_SparseElements = 1u << 2,
	BfRegion_FocalVectors   = 1u << 3,
	BfRegion_Orientations   = 1u << 4,
	BfRegion_Pipeline       = 1u << 5,
	BfRegion_Filters        = 1u << 6,
} BfRegion;

typedef struct {
	u32 version;
	_Atomic u32 invalid;          /* poisoned on shutdown (beamformer.c:346-374) */
	_Atomic u32 server_alive;
	_Atomic u32 reserved_parameter_blocks;
	struct {
		u32 hilbert;
		u64 max_rf_data_size;
		u64 beamformed_frame_buffer_size;
	} capabilities;

	_Atomic u32 locks[BfLock_Count];
	_Atomic u32 work_futex;       /* incremented per push; server waits */
	_Atomic u32 done_futex;       /* incremented per completed work item */
	_Atomic u64 rf_block_rf_size; /* block << 32 | rf byte size */
	_Atomic u64 export_written;   /* bytes the server wrote into scratch */
	_Atomic i64 export_error;     /* server-side error kind for blocking ops */

	BfWorkQueue queue;

	BeamformerLiveImagingParameters live;
	_Atomic u32 live_dirty;

	BfParameterBlock blocks[BeamformerMaxParameterBlocks];
	BeamformerComputeStatsTable stats;

	u64 scratch_offset;           /* from region base */
	u64 scratch_size;
} BfSharedMemory;

#endif /* BEAMFORMER_TPU_ABI_H */

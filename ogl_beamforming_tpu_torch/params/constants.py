"""Framework-wide constants.

Single source of truth mirroring the reference's ``@Constant`` directives
(reference: beamformer.meta:1-9, generated/beamformer.c:5-14).  These bound
resource allocation everywhere: parameter blocks, filter slots, the frame
backlog ring, and the RF upload ring.
"""

CHUNK_CHANNEL_COUNT = 16
"""Channels processed per pre-DAS pass in the reference (beamformer.meta:1).

On TPU this is a *default* accumulation-chunk size; the planner is free to
choose a larger chunk sized to VMEM/HBM instead of the fixed Vulkan value.
"""

FILTER_SLOTS = 4                  # beamformer.meta:2
MAX_BACKLOG_FRAMES = 4096         # beamformer.meta:3
MAX_CHANNEL_COUNT = 256           # beamformer.meta:4
MAX_EMISSIONS_COUNT = 256         # beamformer.meta:5
MAX_COMPUTE_SHADER_STAGES = 16    # beamformer.meta:6
MAX_PARAMETER_BLOCKS = 16         # beamformer.meta:7
MAX_RAW_DATA_FRAMES_IN_FLIGHT = 3 # beamformer.meta:8
MAX_HADAMARD_ELEMENTS = 65536     # beamformer.meta:9

API_VERSION = 34
"""Shared-memory protocol version (reference: beamformer_shared_memory.c:2)."""

STATS_FRAME_WINDOW = 32
"""Rolling-average window for per-stage timing stats
(reference: beamformer_compute_stats.c:3-10)."""

STATS_MAX_STAGES = 16
"""Max pipeline stages tracked in the stats table
(reference: beamformer_compute_stats.c)."""

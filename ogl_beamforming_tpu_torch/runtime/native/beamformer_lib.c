/* ogl_beamforming_tpu — native shared-memory client library + server glue.
 *
 * Implements the reference's ogl_beamformer_lib client API surface
 * (reference: lib/ogl_beamformer_lib_base.h:37-173) over a POSIX
 * shared-memory region, plus the server-side entry points the Python/TPU
 * process uses to service work (create region, wait for work via futex,
 * read RF from scratch, publish frames/stats, signal completion).
 *
 * Synchronization: one futex word per lock kind (same approach as the
 * reference's Linux path, base_linux.c:198-215); the work queue is a
 * single-producer ring with the write/read indices packed in one atomic u64
 * (idea from beamformer_shared_memory.c:57-218, re-implemented).
 */
#ifndef _WIN32
#define _GNU_SOURCE          /* must precede every libc include (syscall) */
#endif

#include "beamformer_abi.h"

#include <stdatomic.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* platform layer: shared memory + 32-bit address wait/wake            */
/*                                                                     */
/* Everything above this layer (locks, the claim/commit work queue,    */
/* the client/server API) is platform-independent.  Two backends:      */
/*   POSIX: shm_open/mmap + the Linux futex syscall                    */
/*   Win32: CreateFileMapping/MapViewOfFile + WaitOnAddress            */
/*          (reference: base_win32.c, beamformer_shared_memory.c:220)  */
/* ------------------------------------------------------------------ */

#ifdef _WIN32

#ifdef BF_WIN32_SYNTAX_CHECK
#include "win32_check.h"     /* self-declared API subset for -fsyntax-only */
#else
#include <windows.h>
#pragma comment(lib, "synchronization.lib")
#endif

#ifdef BF_WIN32_SYNTAX_CHECK
#define EXPORT               /* gcc has no __declspec */
#else
#define EXPORT __declspec(dllexport)
#endif
#define BF_DEFAULT_SHM_NAME "Local\\ogl_beamformer_tpu_shared_memory"

static int futex_wait(_Atomic u32 *addr, u32 expect, i32 timeout_ms)
{
	u32 cmp = expect;
	/* INFINITE is the documented no-timeout sentinel; do not rely on it
	 * happening to equal (u32)-1 */
	u32 timeout = timeout_ms < 0 ? INFINITE : (u32)timeout_ms;
	if (!WaitOnAddress((volatile void *)addr, &cmp, sizeof(u32), timeout))
		return -1;            /* timeout (GetLastError()==ERROR_TIMEOUT) */
	return 0;
}

static void futex_wake(_Atomic u32 *addr, i32 count)
{
	if (count == 1) WakeByAddressSingle((void *)addr);
	else            WakeByAddressAll((void *)addr);
}

static void *os_shm_map(const char *name, u64 *size_out)
{
	HANDLE h = OpenFileMappingA(FILE_MAP_ALL_ACCESS, 0, name);
	if (!h) return 0;
	void *mem = MapViewOfFile(h, FILE_MAP_ALL_ACCESS, 0, 0, 0);
	CloseHandle(h);           /* view keeps the mapping alive */
	if (!mem) return 0;
	/* A single VirtualQuery RegionSize only covers pages with identical
	 * attributes from the queried base, which can under-report the view;
	 * walk every region belonging to this view's allocation and sum. */
	u64 total = 0;
	u8 *cursor = (u8 *)mem;
	MEMORY_BASIC_INFORMATION info;
	while (VirtualQuery(cursor, &info, sizeof(info)) == sizeof(info) &&
	       info.AllocationBase == mem && info.State != MEM_FREE) {
		total  += (u64)info.RegionSize;
		cursor += info.RegionSize;
	}
	*size_out = total;
	return mem;
}

static void *os_shm_create(const char *name, u64 size)
{
	HANDLE h = CreateFileMappingA(INVALID_HANDLE_VALUE, 0, PAGE_READWRITE,
	                              (u32)(size >> 32), (u32)size, name);
	if (!h) return 0;
	if (GetLastError() == ERROR_ALREADY_EXISTS) {
		/* A previous instance's mapping (possibly a different size)
		 * is still alive; refuse rather than adopt it (the POSIX path
		 * unlinks + retruncates — sections cannot be resized). */
		CloseHandle(h);
		return 0;
	}
	void *mem = MapViewOfFile(h, FILE_MAP_ALL_ACCESS, 0, 0, 0);
	/* NOTE: the mapping handle is intentionally leaked for the server's
	 * lifetime (named mappings vanish when all handles close). */
	if (!mem) { CloseHandle(h); return 0; }
	return mem;
}

static void os_shm_unmap(void *mem, u64 size)
{
	(void)size;
	UnmapViewOfFile(mem);
}

static void os_shm_unlink(const char *name)
{
	(void)name;               /* named mappings die with their handles */
}

#else  /* POSIX */

#include <errno.h>
#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#define EXPORT __attribute__((visibility("default")))
#define BF_DEFAULT_SHM_NAME "/ogl_beamformer_tpu_shared_memory"

static int futex_wait(_Atomic u32 *addr, u32 expect, i32 timeout_ms)
{
	struct timespec ts, *tsp = 0;
	if (timeout_ms >= 0) {
		ts.tv_sec  = timeout_ms / 1000;
		ts.tv_nsec = (timeout_ms % 1000) * 1000000L;
		tsp = &ts;
	}
	long r = syscall(SYS_futex, (u32 *)addr, FUTEX_WAIT, expect, tsp, 0, 0);
	if (r == -1 && errno == ETIMEDOUT) return -1;
	return 0;
}

static void futex_wake(_Atomic u32 *addr, i32 count)
{
	syscall(SYS_futex, (u32 *)addr, FUTEX_WAKE, count, 0, 0, 0);
}

static void *os_shm_map(const char *name, u64 *size_out)
{
	int fd = shm_open(name, O_RDWR, S_IRUSR | S_IWUSR);
	if (fd == -1) return 0;
	struct stat st;
	if (fstat(fd, &st) == -1 || (u64)st.st_size < sizeof(BfSharedMemory)) {
		close(fd);
		return 0;
	}
	void *mem = mmap(0, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
	                 fd, 0);
	close(fd);
	if (mem == MAP_FAILED) return 0;
	*size_out = st.st_size;
	return mem;
}

static void *os_shm_create(const char *name, u64 size)
{
	shm_unlink(name);
	int fd = shm_open(name, O_CREAT | O_RDWR, S_IRUSR | S_IWUSR);
	if (fd == -1) return 0;
	if (ftruncate(fd, size) == -1) { close(fd); return 0; }
	void *mem = mmap(0, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
	close(fd);
	if (mem == MAP_FAILED) return 0;
	return mem;
}

static void os_shm_unmap(void *mem, u64 size)
{
	munmap(mem, size);
}

static void os_shm_unlink(const char *name)
{
	shm_unlink(name);
}

#endif /* _WIN32 */

#define BF_DEFAULT_SHM_SIZE (2ull << 30)

static i64 os_monotonic_ms(void)
{
#ifdef _WIN32
	return (i64)GetTickCount64();
#else
	struct timespec now;
	clock_gettime(CLOCK_MONOTONIC, &now);
	return now.tv_sec * 1000ll + now.tv_nsec / 1000000ll;
#endif
}

/* Simple futex lock: 0 free, 1 held, 2 held-with-waiters. */
static int bf_lock_acquire(_Atomic u32 *lock, i32 timeout_ms)
{
	u32 expected = 0;
	if (atomic_compare_exchange_strong(lock, &expected, 1))
		return 1;
	i64 end_ms = os_monotonic_ms() + timeout_ms;
	for (;;) {
		expected = 0;
		if (atomic_compare_exchange_strong(lock, &expected, 2))
			return 1;
		atomic_exchange(lock, 2);
		if (timeout_ms < 0) {
			futex_wait(lock, 2, -1);
		} else {
			i64 left = end_ms - os_monotonic_ms();
			if (left <= 0) return 0;
			if (futex_wait(lock, 2, (i32)left) == -1)
				return 0;
		}
	}
}

static void bf_lock_release(_Atomic u32 *lock)
{
	if (atomic_exchange(lock, 0) == 2)
		futex_wake(lock, 1);
}

/* ------------------------------------------------------------------ */
/* library context                                                     */
/* ------------------------------------------------------------------ */

typedef struct {
	BfSharedMemory *shm;
	u64             shm_size;
	u32             timeout_ms;
	b32             is_server;
} BfContext;

static BfContext g_ctx = {.timeout_ms = 0};

/* Thread-local: clients may push from several threads concurrently and each
 * must see its own failure kind (TSan-verified by queue_stress.c). */
static _Thread_local i32 g_last_error;

static void set_error(i32 kind) { g_last_error = kind; }

static const char *bf_error_strings[] = {
	"None",
	"host-library version mismatch",
	"library in invalid state",
	"parameter block count overflow",
	"push to unallocated parameter block",
	"compute stage overflow",
	"invalid compute shader stage",
	"starting shader not Decode or Demodulate",
	"data kind for demodulation not Int16 or Float",
	"invalid image plane",
	"invalid filter kind",
	"invalid data kind",
	"invalid contrast mode",
	"passed buffer size exceeds available space",
	"data size doesn't match the size specified in parameters",
	"work queue full",
	"not enough space for data export",
	"failed to open shared memory region",
	"failed to acquire lock within timeout period",
	"maximum frame size exceeded",
	"raw rf size exceeds available GPU space",
};

static const char *bf_shm_name(void)
{
	const char *name = getenv("OGL_BEAMFORMER_SHM_NAME");
	return name ? name : BF_DEFAULT_SHM_NAME;
}

static u8 bf_data_kind_byte_size[] = {2, 4, 4, 8, 2, 4};

static int check_shared_memory(void)
{
	if (!g_ctx.shm) {
		u64 size = 0;
		void *mem = os_shm_map(bf_shm_name(), &size);
		if (!mem || size < sizeof(BfSharedMemory)) {
			set_error(BeamformerLibErrorKind_SharedMemory);
			return 0;
		}
		g_ctx.shm      = (BfSharedMemory *)mem;
		g_ctx.shm_size = size;
	}
	if (g_ctx.shm->version != BF_TPU_API_VERSION) {
		set_error(BeamformerLibErrorKind_VersionMismatch);
		return 0;
	}
	if (atomic_load(&g_ctx.shm->invalid)) {
		set_error(BeamformerLibErrorKind_InvalidAccess);
		return 0;
	}
	return 1;
}

static BfParameterBlock *get_block(u32 block)
{
	if (block >= BeamformerMaxParameterBlocks) {
		set_error(BeamformerLibErrorKind_ParameterBlockOverflow);
		return 0;
	}
	if (block >= atomic_load(&g_ctx.shm->reserved_parameter_blocks) && block != 0) {
		set_error(BeamformerLibErrorKind_ParameterBlockUnallocated);
		return 0;
	}
	return &g_ctx.shm->blocks[block];
}

static void mark_dirty(BfParameterBlock *b, u32 region)
{
	atomic_fetch_or(&b->dirty_regions, region);
}

/* ------------------------------------------------------------------ */
/* work queue (single shared producer lock, single consumer)           */
/* ------------------------------------------------------------------ */

static int queue_push(BfWork w)
{
	BfWorkQueue *q = &g_ctx.shm->queue;
	for (;;) {
		u64 state = atomic_load(&q->state);
		u32 widx = (u32)(state >> 32), ridx = (u32)state;
		if (widx - ridx >= BfWorkQueueCapacity) {
			set_error(BeamformerLibErrorKind_WorkQueueFull);
			return 0;
		}
		u64 next = ((u64)(widx + 1) << 32) | ridx;
		if (atomic_compare_exchange_strong(&q->state, &state, next)) {
			/* Slot claimed; write the payload *before* publishing it.
			 * Consumers ignore the slot until commit == widx + 1
			 * (unique per slot generation: slot reused every
			 * Capacity pushes, commit values s+1, s+Cap+1, ...). */
			u32 slot = widx % BfWorkQueueCapacity;
			q->entries[slot] = w;
			atomic_store_explicit(&q->commit[slot], widx + 1,
			                      memory_order_release);
			atomic_fetch_add(&g_ctx.shm->work_futex, 1);
			futex_wake(&g_ctx.shm->work_futex, 1);
			return 1;
		}
	}
}

static int queue_pop(BfWork *out)
{
	BfWorkQueue *q = &g_ctx.shm->queue;
	for (;;) {
		u64 state = atomic_load(&q->state);
		u32 widx = (u32)(state >> 32), ridx = (u32)state;
		if (widx == ridx) return 0;
		u32 slot = ridx % BfWorkQueueCapacity;
		if (atomic_load_explicit(&q->commit[slot],
		                         memory_order_acquire) != ridx + 1)
			return 0;  /* claimed but not yet committed */
		/* Safe to read before the CAS: single consumer, and producers
		 * can't reuse the slot until ridx advances past it. */
		*out = q->entries[slot];
		u64 next = ((u64)widx << 32) | (ridx + 1);
		/* CAS (not store): producers may bump widx concurrently and a
		 * plain store would erase their claim. */
		if (atomic_compare_exchange_strong(&q->state, &state, next))
			return 1;
	}
}

/* wait until the done counter advances past `target`; returns 0 on timeout */
static int wait_done(u32 target, i32 timeout_ms)
{
	for (;;) {
		u32 cur = atomic_load(&g_ctx.shm->done_futex);
		if ((i32)(cur - target) >= 0) return 1;
		if (atomic_load(&g_ctx.shm->invalid)) {
			set_error(BeamformerLibErrorKind_InvalidAccess);
			return 0;
		}
		if (futex_wait(&g_ctx.shm->done_futex, cur, timeout_ms) == -1) {
			set_error(BeamformerLibErrorKind_SyncVariable);
			return 0;
		}
	}
}

/* ------------------------------------------------------------------ */
/* client API — reference surface                                      */
/* ------------------------------------------------------------------ */

EXPORT u32 beamformer_get_api_version(void) { return BF_TPU_API_VERSION; }

EXPORT i32 beamformer_get_last_error(void) { return g_last_error; }

EXPORT const char *beamformer_error_string(i32 kind)
{
	if (kind < 0 || kind >= (i32)(sizeof(bf_error_strings) / sizeof(*bf_error_strings)))
		return "invalid error kind";
	return bf_error_strings[kind];
}

EXPORT const char *beamformer_get_last_error_string(void)
{
	return beamformer_error_string(g_last_error);
}

EXPORT void beamformer_set_global_timeout(u32 timeout_ms)
{
	g_ctx.timeout_ms = timeout_ms;
}

EXPORT u32 beamformer_reserve_parameter_blocks(u32 count)
{
	if (!check_shared_memory()) return 0;
	if (count > BeamformerMaxParameterBlocks) {
		set_error(BeamformerLibErrorKind_ParameterBlockOverflow);
		return 0;
	}
	atomic_store(&g_ctx.shm->reserved_parameter_blocks, count);
	return 1;
}

EXPORT u64 beamformer_maximum_rf_data_size(void)
{
	if (!check_shared_memory()) return ~0ull;
	return g_ctx.shm->capabilities.max_rf_data_size;
}

static int validate_pipeline_c(i32 *shaders, u32 count, u32 data_kind)
{
	if (data_kind >= BeamformerDataKind_Count) {
		set_error(BeamformerLibErrorKind_InvalidDataKind);
		return 0;
	}
	if (count > BeamformerMaxComputeShaderStages) {
		set_error(BeamformerLibErrorKind_ComputeStageOverflow);
		return 0;
	}
	for (u32 i = 0; i < count; i++) {
		if (shaders[i] < BeamformerShaderKind_Decode ||
		    shaders[i] > BeamformerShaderKind_Hilbert)
		{
			set_error(BeamformerLibErrorKind_InvalidComputeStage);
			return 0;
		}
		b32 complex = data_kind == BeamformerDataKind_Int16Complex ||
		              data_kind == BeamformerDataKind_Float32Complex ||
		              data_kind == BeamformerDataKind_Float16Complex;
		if (shaders[i] == BeamformerShaderKind_Demodulate && complex) {
			set_error(BeamformerLibErrorKind_InvalidDemodulationDataKind);
			return 0;
		}
	}
	if (count == 0 || (shaders[0] != BeamformerShaderKind_Decode &&
	                   shaders[0] != BeamformerShaderKind_Demodulate))
	{
		set_error(BeamformerLibErrorKind_InvalidStartShader);
		return 0;
	}
	return 1;
}

EXPORT u32 beamformer_push_pipeline_at(i32 *shaders, u32 shader_count,
                                       u32 data_kind, u32 block)
{
	if (!check_shared_memory()) return 0;
	if (!validate_pipeline_c(shaders, shader_count, data_kind)) return 0;
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	memcpy(b->pipeline_shaders, shaders, shader_count * sizeof(i32));
	b->pipeline_count = shader_count;
	b->data_kind = data_kind;
	mark_dirty(b, BfRegion_Pipeline);
	return 1;
}

EXPORT u32 beamformer_push_pipeline(i32 *shaders, u32 shader_count, u32 data_kind)
{
	return beamformer_push_pipeline_at(shaders, shader_count, data_kind, 0);
}

EXPORT u32 beamformer_set_pipeline_stage_parameters_at(u32 stage_index,
                                                       i32 parameter, u32 block)
{
	if (!check_shared_memory()) return 0;
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	if (stage_index >= BeamformerMaxComputeShaderStages) {
		set_error(BeamformerLibErrorKind_ComputeStageOverflow);
		return 0;
	}
	b->pipeline_parameters[stage_index] = parameter;
	mark_dirty(b, BfRegion_Pipeline);
	return 1;
}

EXPORT u32 beamformer_set_pipeline_stage_parameters(u32 stage_index, i32 parameter)
{
	return beamformer_set_pipeline_stage_parameters_at(stage_index, parameter, 0);
}

EXPORT u32 beamformer_push_parameters_at(BeamformerParameters *p, u32 block)
{
	if (!check_shared_memory()) return 0;
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	if (p->contrast_mode > BeamformerContrastMode_A1S2) {
		set_error(BeamformerLibErrorKind_InvalidContrastMode);
		return 0;
	}
	b->parameters = *p;
	mark_dirty(b, BfRegion_Parameters);
	return 1;
}

EXPORT u32 beamformer_push_parameters(BeamformerParameters *p)
{
	return beamformer_push_parameters_at(p, 0);
}

EXPORT u32 beamformer_push_channel_mapping_at(i16 *mapping, u32 count, u32 block)
{
	if (!check_shared_memory()) return 0;
	if (count > BeamformerMaxChannelCount) {
		set_error(BeamformerLibErrorKind_BufferOverflow);
		return 0;
	}
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	memcpy(b->channel_mapping, mapping, count * sizeof(i16));
	mark_dirty(b, BfRegion_ChannelMapping);
	return 1;
}

EXPORT u32 beamformer_push_channel_mapping(i16 *mapping, u32 count)
{
	return beamformer_push_channel_mapping_at(mapping, count, 0);
}

EXPORT u32 beamformer_push_sparse_elements_at(i16 *elements, u32 count, u32 block)
{
	if (!check_shared_memory()) return 0;
	if (count > BeamformerMaxEmissionsCount) {
		set_error(BeamformerLibErrorKind_BufferOverflow);
		return 0;
	}
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	memcpy(b->sparse_elements, elements, count * sizeof(i16));
	mark_dirty(b, BfRegion_SparseElements);
	return 1;
}

EXPORT u32 beamformer_push_sparse_elements(i16 *elements, u32 count)
{
	return beamformer_push_sparse_elements_at(elements, count, 0);
}

EXPORT u32 beamformer_push_focal_vectors_at(f32 *vectors, u32 count, u32 block)
{
	if (!check_shared_memory()) return 0;
	if (count > BeamformerMaxEmissionsCount) {
		set_error(BeamformerLibErrorKind_BufferOverflow);
		return 0;
	}
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	memcpy(b->focal_vectors, vectors, count * 2 * sizeof(f32));
	mark_dirty(b, BfRegion_FocalVectors);
	return 1;
}

EXPORT u32 beamformer_push_focal_vectors(f32 *vectors, u32 count)
{
	return beamformer_push_focal_vectors_at(vectors, count, 0);
}

EXPORT u32 beamformer_push_transmit_receive_orientations_at(u8 *values, u32 count,
                                                            u32 block)
{
	if (!check_shared_memory()) return 0;
	if (count > BeamformerMaxEmissionsCount) {
		set_error(BeamformerLibErrorKind_BufferOverflow);
		return 0;
	}
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	memcpy(b->transmit_receive_orientations, values, count);
	mark_dirty(b, BfRegion_Orientations);
	return 1;
}

EXPORT u32 beamformer_push_transmit_receive_orientations(u8 *values, u32 count)
{
	return beamformer_push_transmit_receive_orientations_at(values, count, 0);
}

EXPORT u32 beamformer_create_filter(BeamformerFilterParameters *fp,
                                    u8 filter_slot, u8 parameter_block)
{
	if (!check_shared_memory()) return 0;
	if (fp->kind > BeamformerFilterKind_MatchedChirp) {
		set_error(BeamformerLibErrorKind_InvalidFilterKind);
		return 0;
	}
	if (filter_slot >= BeamformerFilterSlots) {
		set_error(BeamformerLibErrorKind_InvalidFilterKind);
		return 0;
	}
	BfParameterBlock *b = get_block(parameter_block);
	if (!b) return 0;
	b->filters[filter_slot] = *fp;
	b->filter_valid_mask |= 1u << filter_slot;
	mark_dirty(b, BfRegion_Filters);
	return 1;
}

/* ---- data push ---- */

static u8 *scratch_base(void)
{
	return (u8 *)g_ctx.shm + g_ctx.shm->scratch_offset;
}

static u32 push_data_base(void *data, u32 data_size, i32 timeout_ms, u32 block)
{
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	BeamformerParameters *p = &b->parameters;

	u32 element_size = bf_data_kind_byte_size[b->data_kind % BeamformerDataKind_Count];
	u64 rf_size  = (u64)p->acquisition_count * p->sample_count
	             * p->channel_count * element_size;
	u64 raw_size = (u64)p->raw_data_dimensions.E[0] * p->raw_data_dimensions.E[1]
	             * element_size;
	if (raw_size == 0) raw_size = data_size;

	if (rf_size > g_ctx.shm->scratch_size) {
		set_error(BeamformerLibErrorKind_BufferOverflow);
		return 0;
	}
	if (rf_size > g_ctx.shm->capabilities.max_rf_data_size) {
		set_error(BeamformerLibErrorKind_RFDataSizeOverflow);
		return 0;
	}
	if (data_size != raw_size) {
		set_error(BeamformerLibErrorKind_DataSizeMismatch);
		return 0;
	}

	if (!bf_lock_acquire(&g_ctx.shm->locks[BfLock_UploadRF], timeout_ms)) {
		set_error(BeamformerLibErrorKind_SyncVariable);
		return 0;
	}
	if (!bf_lock_acquire(&g_ctx.shm->locks[BfLock_ScratchSpace], timeout_ms)) {
		bf_lock_release(&g_ctx.shm->locks[BfLock_UploadRF]);
		set_error(BeamformerLibErrorKind_SyncVariable);
		return 0;
	}
	/* NOTE: the channel-mapping permutation and contrast reduction run on
	 * the server (runtime/upload.py prepare_rf) — the raw scanner layout is
	 * shipped as-is. */
	memcpy(scratch_base(), data, data_size);
	atomic_store(&g_ctx.shm->rf_block_rf_size,
	             ((u64)block << 32) | (u64)data_size);
	bf_lock_release(&g_ctx.shm->locks[BfLock_ScratchSpace]);
	/* UploadRF released by the server once it has consumed the scratch. */
	return 1;
}

EXPORT u32 beamformer_push_data_with_compute(void *data, u32 data_size,
                                             u32 image_plane_tag, u32 parameter_slot)
{
	if (!check_shared_memory()) return 0;
	if (image_plane_tag >= BeamformerViewPlaneTag_Count) {
		set_error(BeamformerLibErrorKind_InvalidImagePlane);
		return 0;
	}
	if (!push_data_base(data, data_size, (i32)g_ctx.timeout_ms, parameter_slot))
		return 0;
	BfWork w = {.kind = BfWork_ComputeIndirect, .parameter_block = parameter_slot,
	            .view_plane = image_plane_tag, .arg1 = data_size};
	return queue_push(w);
}

/* ---- export ---- */

EXPORT u32 beamformer_get_last_frames(void *out_data, u64 out_data_size, u32 count)
{
	if (!check_shared_memory()) return 0;
	u32 start = atomic_load(&g_ctx.shm->done_futex);
	BfWork w = {.kind = BfWork_ExportFrames, .arg0 = count, .arg1 = out_data_size};
	if (!bf_lock_acquire(&g_ctx.shm->locks[BfLock_ExportSync], (i32)g_ctx.timeout_ms)) {
		set_error(BeamformerLibErrorKind_SyncVariable);
		return 0;
	}
	u32 result = 0;
	if (queue_push(w) && wait_done(start + 1, g_ctx.timeout_ms ? (i32)g_ctx.timeout_ms : -1)) {
		i64 err = atomic_load(&g_ctx.shm->export_error);
		if (err) {
			set_error((i32)err);
		} else {
			u64 written = atomic_load(&g_ctx.shm->export_written);
			if (written > out_data_size) written = out_data_size;
			memcpy(out_data, scratch_base(), written);
			result = 1;
		}
	}
	bf_lock_release(&g_ctx.shm->locks[BfLock_ExportSync]);
	return result;
}

EXPORT u32 beamformer_compute_timings(BeamformerComputeStatsTable *output,
                                      i32 timeout_ms)
{
	(void)timeout_ms;
	if (!check_shared_memory()) return 0;
	*output = g_ctx.shm->stats;
	return 1;
}

/* ---- simple API ---- */

EXPORT u32 beamformer_push_simple_parameters_at(BeamformerSimpleParameters *bp,
                                                u32 block)
{
	if (!check_shared_memory()) return 0;
	if (!validate_pipeline_c(bp->compute_stages, bp->compute_stages_count,
	                         bp->data_kind))
		return 0;
	BfParameterBlock *b = get_block(block);
	if (!b) return 0;
	b->parameters = bp->parameters;
	memcpy(b->channel_mapping, bp->channel_mapping, sizeof(b->channel_mapping));
	memcpy(b->sparse_elements, bp->sparse_elements, sizeof(b->sparse_elements));
	for (u32 i = 0; i < BeamformerMaxEmissionsCount; i++) {
		b->focal_vectors[i][0] = bp->steering_angles[i];
		b->focal_vectors[i][1] = bp->focal_depths[i];
		b->transmit_receive_orientations[i] = bp->transmit_receive_orientations[i];
	}
	memcpy(b->pipeline_shaders, bp->compute_stages, sizeof(b->pipeline_shaders));
	memcpy(b->pipeline_parameters, bp->compute_stage_parameters,
	       sizeof(b->pipeline_parameters));
	b->pipeline_count = bp->compute_stages_count;
	b->data_kind = bp->data_kind;
	mark_dirty(b, BfRegion_Parameters | BfRegion_ChannelMapping |
	              BfRegion_SparseElements | BfRegion_FocalVectors |
	              BfRegion_Orientations | BfRegion_Pipeline);
	return 1;
}

EXPORT u32 beamformer_push_simple_parameters(BeamformerSimpleParameters *bp)
{
	return beamformer_push_simple_parameters_at(bp, 0);
}

EXPORT u64 beamformer_maximum_frames_for_parameters(BeamformerParameters *p)
{
	if (!check_shared_memory()) return ~0ull;
	u64 frame_size = (u64)(p->output_points.E[0] > 1 ? p->output_points.E[0] : 1)
	               * (u64)(p->output_points.E[1] > 1 ? p->output_points.E[1] : 1)
	               * (u64)(p->output_points.E[2] > 1 ? p->output_points.E[2] : 1) * 8;
	if (!frame_size) return 0;
	return g_ctx.shm->capabilities.beamformed_frame_buffer_size / frame_size;
}

EXPORT u64 beamformer_maximum_frames_for_simple_parameters(BeamformerSimpleParameters *bp)
{
	return beamformer_maximum_frames_for_parameters(&bp->parameters);
}

EXPORT u32 beamformer_beamform_data(BeamformerSimpleParameters *bp, void *data,
                                    u32 data_size, void *out_data, i32 timeout_ms)
{
	if (!check_shared_memory()) return 0;
	u32 saved_timeout = g_ctx.timeout_ms;
	g_ctx.timeout_ms = timeout_ms < 0 ? 0 : (u32)timeout_ms;
	u32 result = 0;
	if (beamformer_push_simple_parameters(bp) &&
	    beamformer_push_data_with_compute(data, data_size, 0, 0))
	{
		if (out_data) {
			u64 points = (u64)(bp->parameters.output_points.E[0] > 1 ? bp->parameters.output_points.E[0] : 1)
			           * (u64)(bp->parameters.output_points.E[1] > 1 ? bp->parameters.output_points.E[1] : 1)
			           * (u64)(bp->parameters.output_points.E[2] > 1 ? bp->parameters.output_points.E[2] : 1);
			u64 out_size = points * 8; /* Float32Complex worst case */
			if (timeout_ms < 0) g_ctx.timeout_ms = 0;
			else                g_ctx.timeout_ms = (u32)timeout_ms;
			result = beamformer_get_last_frames(out_data, out_size, 1);
		} else {
			result = 1;
		}
	}
	g_ctx.timeout_ms = saved_timeout;
	return result;
}

/* ---- live imaging ---- */

EXPORT i32 beamformer_live_parameters_get_dirty_flag(void)
{
	if (!check_shared_memory()) return -1;
	u32 flags = atomic_exchange(&g_ctx.shm->live_dirty, 0);
	if (!flags) return -1;
	/* return lowest set flag index (reference returns one flag at a time) */
	i32 idx = __builtin_ctz(flags);
	atomic_fetch_or(&g_ctx.shm->live_dirty, flags & ~(1u << idx));
	return idx;
}

EXPORT BeamformerLiveImagingParameters *beamformer_get_live_parameters(void)
{
	if (!check_shared_memory()) return 0;
	return &g_ctx.shm->live;
}

EXPORT u32 beamformer_set_live_parameters(BeamformerLiveImagingParameters *live)
{
	if (!check_shared_memory()) return 0;
	if (!bf_lock_acquire(&g_ctx.shm->locks[BfLock_Live], (i32)g_ctx.timeout_ms)) {
		set_error(BeamformerLibErrorKind_SyncVariable);
		return 0;
	}
	g_ctx.shm->live = *live;
	bf_lock_release(&g_ctx.shm->locks[BfLock_Live]);
	return 1;
}

/* ------------------------------------------------------------------ */
/* server API (used by the Python/TPU process via ctypes)              */
/* ------------------------------------------------------------------ */

EXPORT void *bf_server_create(u64 total_size)
{
	if (total_size < sizeof(BfSharedMemory) + (1u << 20))
		total_size = BF_DEFAULT_SHM_SIZE;
	void *mem = os_shm_create(bf_shm_name(), total_size);
	if (!mem) return 0;
	memset(mem, 0, sizeof(BfSharedMemory));

	BfSharedMemory *shm = (BfSharedMemory *)mem;
	shm->version = BF_TPU_API_VERSION;
	atomic_store(&shm->reserved_parameter_blocks, 1);
	shm->scratch_offset = (sizeof(BfSharedMemory) + 4095) & ~4095ull;
	shm->scratch_size   = total_size - shm->scratch_offset;
	shm->capabilities.hilbert = 1;
	shm->capabilities.max_rf_data_size = shm->scratch_size;
	shm->capabilities.beamformed_frame_buffer_size = shm->scratch_size;
	atomic_store(&shm->server_alive, 1);

	g_ctx.shm       = shm;
	g_ctx.shm_size  = total_size;
	g_ctx.is_server = 1;
	return mem;
}

EXPORT void *bf_server_attach_existing(void)
{
	if (check_shared_memory()) return g_ctx.shm;
	return 0;
}

EXPORT void bf_server_destroy(void)
{
	if (g_ctx.shm) {
		/* Poison so blocked clients error out instead of hanging hardware
		 * (reference: beamformer.c:346-374). */
		atomic_store(&g_ctx.shm->invalid, 1);
		atomic_store(&g_ctx.shm->server_alive, 0);
		atomic_fetch_add(&g_ctx.shm->done_futex, 1);
		futex_wake(&g_ctx.shm->done_futex, 0x7fffffff);
		os_shm_unmap((void *)g_ctx.shm, g_ctx.shm_size);
		g_ctx.shm = 0;
		os_shm_unlink(bf_shm_name());
	}
}

/* Blocks until work is available (or timeout); returns 1 and fills *out. */
EXPORT i32 bf_server_wait_work(BfWork *out, i32 timeout_ms)
{
	BfSharedMemory *shm = g_ctx.shm;
	for (;;) {
		if (queue_pop(out)) return 1;
		u32 seq = atomic_load(&shm->work_futex);
		if (queue_pop(out)) return 1;
		if (futex_wait(&shm->work_futex, seq, timeout_ms) == -1)
			return 0;
	}
}

EXPORT void bf_server_complete_work(void)
{
	atomic_fetch_add(&g_ctx.shm->done_futex, 1);
	futex_wake(&g_ctx.shm->done_futex, 0x7fffffff);
}

EXPORT void bf_server_release_upload(void)
{
	bf_lock_release(&g_ctx.shm->locks[BfLock_UploadRF]);
}

EXPORT u8 *bf_server_scratch(u64 *size)
{
	if (size) *size = g_ctx.shm->scratch_size;
	return scratch_base();
}

EXPORT BfParameterBlock *bf_server_block(u32 i)
{
	return &g_ctx.shm->blocks[i];
}

EXPORT u32 bf_server_take_dirty(u32 block)
{
	return atomic_exchange(&g_ctx.shm->blocks[block].dirty_regions, 0);
}

EXPORT u64 bf_server_rf_info(void)
{
	return atomic_exchange(&g_ctx.shm->rf_block_rf_size, 0);
}

EXPORT void bf_server_set_export(u64 written, i64 error)
{
	atomic_store(&g_ctx.shm->export_written, written);
	atomic_store(&g_ctx.shm->export_error, error);
}

EXPORT BeamformerComputeStatsTable *bf_server_stats(void)
{
	return &g_ctx.shm->stats;
}

EXPORT BeamformerLiveImagingParameters *bf_server_live(u32 **dirty)
{
	if (dirty) *dirty = (u32 *)&g_ctx.shm->live_dirty;
	return &g_ctx.shm->live;
}

EXPORT void bf_server_mark_live_dirty(u32 flags)
{
	atomic_fetch_or(&g_ctx.shm->live_dirty, flags);
}

/* ---- ABI self-description (consistency checks from Python) ---- */

EXPORT u64 bf_abi_sizeof_parameters(void)        { return sizeof(BeamformerParameters); }
EXPORT u64 bf_abi_sizeof_simple_parameters(void) { return sizeof(BeamformerSimpleParameters); }
EXPORT u64 bf_abi_sizeof_filter_parameters(void) { return sizeof(BeamformerFilterParameters); }
EXPORT u64 bf_abi_sizeof_live_parameters(void)   { return sizeof(BeamformerLiveImagingParameters); }
EXPORT u64 bf_abi_sizeof_stats_table(void)       { return sizeof(BeamformerComputeStatsTable); }
EXPORT u64 bf_abi_sizeof_shared_memory(void)     { return sizeof(BfSharedMemory); }
EXPORT u64 bf_abi_sizeof_work(void)              { return sizeof(BfWork); }
EXPORT u64 bf_abi_sizeof_parameter_block(void)   { return sizeof(BfParameterBlock); }

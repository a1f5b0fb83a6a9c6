/* Multi-producer / single-consumer stress test for the shared-memory work
 * queue (the claim/commit protocol in beamformer_lib.c:queue_push/queue_pop).
 *
 * Exercises the exact race the round-1 review flagged: a consumer polling
 * while producers publish.  Every BfWork payload is self-checking (arg1 is
 * a mix of the other fields) so torn reads are detected, and per-producer
 * sequence numbers verify exactly-once FIFO delivery.
 *
 * Build + run (also under -fsanitize=thread / address,undefined):
 *   make stress && ./queue_stress
 */
#include "beamformer_lib.c"

#include <pthread.h>
#include <stdio.h>

#define N_PRODUCERS 8
#define PUSHES_PER_PRODUCER 20000

static u64 work_mix(const BfWork *w)
{
	u64 h = 0x9e3779b97f4a7c15ull;
	h ^= (u64)w->kind * 0xff51afd7ed558ccdull;
	h ^= (u64)w->parameter_block * 0xc4ceb9fe1a85ec53ull;
	h ^= (u64)w->view_plane * 0x2545f4914f6cdd1dull;
	h ^= (u64)w->arg0 * 0x9e3779b97f4a7c15ull;
	return h;
}

static _Atomic u32 g_consumed_total;
static _Atomic u32 g_errors;
static u32 g_seen[N_PRODUCERS];     /* consumer-only: next expected seq */

static void *producer(void *arg)
{
	u32 id = (u32)(uintptr_t)arg;
	for (u32 seq = 0; seq < PUSHES_PER_PRODUCER; seq++) {
		BfWork w;
		w.kind = BfWork_ComputeIndirect;
		w.parameter_block = id;
		w.view_plane = seq;
		w.arg0 = id * 0x10001u + seq;
		w.arg1 = work_mix(&w);
		while (!queue_push(w))
			sched_yield();      /* queue full: retry */
	}
	return 0;
}

static void *consumer(void *arg)
{
	(void)arg;
	u32 total = N_PRODUCERS * PUSHES_PER_PRODUCER;
	while (atomic_load(&g_consumed_total) < total) {
		BfWork w;
		if (!queue_pop(&w)) {
			sched_yield();
			continue;
		}
		if (w.arg1 != work_mix(&w)) {
			fprintf(stderr, "TORN payload: pb=%u vp=%u\n",
			        w.parameter_block, w.view_plane);
			atomic_fetch_add(&g_errors, 1);
		} else if (w.parameter_block >= N_PRODUCERS) {
			fprintf(stderr, "BAD producer id %u\n", w.parameter_block);
			atomic_fetch_add(&g_errors, 1);
		} else if (w.view_plane != g_seen[w.parameter_block]) {
			fprintf(stderr, "OUT OF ORDER: producer %u seq %u expected %u\n",
			        w.parameter_block, w.view_plane,
			        g_seen[w.parameter_block]);
			atomic_fetch_add(&g_errors, 1);
			g_seen[w.parameter_block] = w.view_plane + 1;
		} else {
			g_seen[w.parameter_block]++;
		}
		atomic_fetch_add(&g_consumed_total, 1);
	}
	return 0;
}

int main(void)
{
	static BfSharedMemory shm;      /* in-process region: TSan can see it */
	g_ctx.shm = &shm;
	g_ctx.shm_size = sizeof(shm);
	shm.version = BF_TPU_API_VERSION;

	pthread_t threads[N_PRODUCERS + 1];
	pthread_create(&threads[N_PRODUCERS], 0, consumer, 0);
	for (u32 i = 0; i < N_PRODUCERS; i++)
		pthread_create(&threads[i], 0, producer, (void *)(uintptr_t)i);
	for (u32 i = 0; i <= N_PRODUCERS; i++)
		pthread_join(threads[i], 0);

	u32 errors = atomic_load(&g_errors);
	for (u32 i = 0; i < N_PRODUCERS; i++) {
		if (g_seen[i] != PUSHES_PER_PRODUCER) {
			fprintf(stderr, "LOST work: producer %u delivered %u/%u\n",
			        i, g_seen[i], PUSHES_PER_PRODUCER);
			errors++;
		}
	}
	printf("queue_stress: %u items, %u errors\n",
	       N_PRODUCERS * PUSHES_PER_PRODUCER, errors);
	return errors ? 1 : 0;
}

// probe_insert: batched claim-first-non-LIVE insert, in place.
//
// Replaces the TPU kernel _probe_insert_kernel (src/repro/kernels/probe.py)
// AND the cross-tile claim resolution its wrapper did afterwards.  The TPU
// version claimed slots on a private copy of a table window, one tile of
// sorted queries at a time, so which query got a contested slot depended on
// the tiling.  This kernel gives the placement of the plain oracle
// (probe_insert_ref / linear_insert) slot for slot:
//
//   * presence is proved against the table as it was before the batch;
//   * then rounds p = 0 .. max_probes-1 run in lock step over the batch: in
//     round p every pending query looks at slot (h0 + p) mod C; a slot that
//     is not LIVE at the start of the round goes to the LOWEST batch index
//     that wants it; the winner writes key, value and LIVE; the others move
//     on to the next slot.
//
// A round has two phases with a grid-wide barrier between them — every
// candidate does atomicMin(claim[slot], index), then the query whose index
// is in the claim word writes — and one more barrier before the next round
// reads the states.  The barriers are cooperative_groups grid syncs, so the
// kernel is launched cooperatively with no more blocks than can be resident
// at once, and the blocks walk the batch with a grid-stride loop.  Nothing
// depends on the order in which threads run, so the result is deterministic.
// States and claim words that other blocks write between barriers are read
// with __ldcg (from L2, past the SM's own L1).
//
// The claim words (int32 [C], all INT_MAX between launches) are allocated
// once with the table; a winner restores the word it took, so no launch ever
// fills the whole array.  `remaining` counts pending queries; the rounds stop
// as soon as it reaches zero.
//
// Bound: neither bytes nor operations but the barriers — up to
// 1 + 2 * max_probes grid syncs a launch, each a round trip through global
// memory across all blocks, for a few bytes a query a round.  The design
// keeps the grid small (one block of 256 threads for every 256 queries, at
// most what is co-resident) so a barrier is cheap, and ends the rounds early.
//
// Caller contract (as the reference): mask is winner-filtered, at most one
// set entry for each distinct key.
#include <cooperative_groups.h>
#include <limits.h>

#include "dhash_common.cuh"

namespace cg = cooperative_groups;

__global__ void probe_insert_kernel(
    int* __restrict__ tk, int* __restrict__ tv, int* __restrict__ ts,
    int* __restrict__ claim, int C, const int* __restrict__ h0,
    const int* __restrict__ keys, const int* __restrict__ vals,
    const uint8_t* __restrict__ mask, int Q, int max_probes,
    uint8_t* __restrict__ okf, uint8_t* __restrict__ present,
    uint8_t* __restrict__ pend, int* __restrict__ remaining) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  // phase 0: presence on the table as it was before the batch
  for (int i = tid; i < Q; i += stride) {
    bool there = false;
    bool todo = false;
    if (mask[i]) {
      int v, l;
      there =
          dhash_probe_one(tk, tv, ts, C, h0[i], keys[i], max_probes, &v, &l);
      todo = !there;
    }
    present[i] = there ? 1 : 0;
    pend[i] = todo ? 1 : 0;
    okf[i] = 0;
    if (todo) atomicAdd(remaining, 1);
  }
  grid.sync();

  volatile int* rem = remaining;
  for (int p = 0; p < max_probes; ++p) {
    if (*rem == 0) break;
    // phase A: every pending query bids for its round-p slot if it is free
    for (int i = tid; i < Q; i += stride) {
      if (!pend[i]) continue;
      int pos = (int)(((long long)h0[i] + p) % C);
      if (__ldcg(&ts[pos]) != DHASH_LIVE) atomicMin(&claim[pos], i);
    }
    grid.sync();
    // phase B: the lowest bidder writes and restores the claim word
    for (int i = tid; i < Q; i += stride) {
      if (!pend[i]) continue;
      int pos = (int)(((long long)h0[i] + p) % C);
      if (__ldcg(&claim[pos]) == i) {
        tk[pos] = keys[i];
        tv[pos] = vals[i];
        ts[pos] = DHASH_LIVE;
        claim[pos] = INT_MAX;
        pend[i] = 0;
        okf[i] = 1;
        atomicSub(remaining, 1);
      }
    }
    grid.sync();
  }
}

// co-resident blocks of the kernel, for each device that has launched it
#define DHASH_MAX_DEVICES 64
static int g_max_blocks[DHASH_MAX_DEVICES];

extern "C" int dhash_probe_insert(
    int* tk, int* tv, int* ts, int* claim, int C, const int* h0,
    const int* keys, const int* vals, const uint8_t* mask, int Q,
    int max_probes, uint8_t* okf, uint8_t* present, uint8_t* pend,
    int* remaining, void* stream) {
  const int threads = 256;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= DHASH_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_max_blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_insert_kernel, threads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    g_max_blocks[dev] = sms * per_sm;
  }
  int blocks = (Q + threads - 1) / threads;
  if (blocks > g_max_blocks[dev]) blocks = g_max_blocks[dev];
  void* args[] = {&tk,   &tv,   &ts,   &claim,      &C,   &h0,
                  &keys, &vals, &mask, &Q,          &max_probes,
                  &okf,  &present, &pend, &remaining};
  e = cudaLaunchCooperativeKernel(
      (void*)probe_insert_kernel, dim3(blocks), dim3(threads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// tc_insert: batched claim-a-lane two-row insert (twochoice and cuckoo), in
// place.
//
// Replaces the TPU kernel _tc_insert_kernel (src/repro/kernels/probe.py) AND
// what its wrapper did after it (src/repro/kernels/ops.py, twochoice_insert:
// the a-claim shadowing the b-claim of a query, the first-claimant
// resolution of slots claimed from two tiles, and the gated fallback to the
// plain oracle).  The TPU version claimed lanes on a private copy of a
// two-row-block window, one tile of row-sorted entries at a time, so which
// query got a contested lane depended on the tiling.  This kernel gives the
// placement of the plain oracle (tc_insert_ref / buckets.twochoice_insert)
// lane for lane:
//
//   * presence is proved in both rows on the table as it was before the
//     batch;
//   * then rounds r = 0 .. max_rounds-1 run in lock step over the batch:
//     round r looks at row a if r is even, else row b, and takes the row's
//     first lane that is not LIVE at the start of the round; the LOWEST batch
//     index that wants a lane gets it; the winner writes key, value and LIVE.
//
// The rounds run over the grid: a round has two phases with a grid-wide
// barrier between them — every pending query picks its lane and does
// atomicMin(claim[slot], index), then the query whose index is in the claim
// word writes and restores the word to INT_MAX — and one more barrier before
// the next round reads the states.  The kernel is launched cooperatively
// with no more blocks than can be resident at once; the blocks walk the
// batch with a grid-stride loop, so each query stays with one thread.
// States and claim words that other blocks write between barriers are read
// with __ldcg (from L2, past the SM's own L1); a row is read as 16-byte
// loads where W allows.  Nothing depends on the order in which threads run,
// so the result is deterministic.  The claim words (int32 [rows * W], all
// INT_MAX between launches) are allocated once with the table; `slot` is a
// per-query scratch holding the lane bid of the round (-1: none, -2: not
// pending); `remaining` counts pending queries, and the rounds stop as soon
// as it reaches zero.
//
// Bound: neither bytes nor operations but the barriers, two a round:
// up to 1 + 2 * max_rounds grid syncs a launch (17 for twochoice, 5 for
// cuckoo) for a few sectors a query a round.  The grid is kept small (one
// block of 256 threads for every 256 queries, at most what is co-resident)
// so that a barrier is cheap, and the rounds end early.
//
// Caller contract (as the reference): mask is winner-filtered, at most one
// set entry for each distinct key.
#include <cooperative_groups.h>
#include <limits.h>

#include "dhash_common.cuh"

namespace cg = cooperative_groups;

// First lane of `row` that is not LIVE, read from L2, or -1.
template <bool VEC>
__device__ __forceinline__ int row_first_free(const int* ts, long long row,
                                              int W) {
  const long long base = row * W;
  if (VEC) {
    for (int l = 0; l < W; l += 4) {
      const int4 s = __ldcg(reinterpret_cast<const int4*>(ts + base + l));
      if (s.x != DHASH_LIVE) return l;
      if (s.y != DHASH_LIVE) return l + 1;
      if (s.z != DHASH_LIVE) return l + 2;
      if (s.w != DHASH_LIVE) return l + 3;
    }
  } else {
    for (int l = 0; l < W; ++l)
      if (__ldcg(ts + base + l) != DHASH_LIVE) return l;
  }
  return -1;
}

template <bool VEC>
__global__ void tc_insert_kernel(
    int* __restrict__ tk, int* __restrict__ tv, int* __restrict__ ts,
    int* __restrict__ claim, int W, const int* __restrict__ rows_a,
    const int* __restrict__ rows_b, const int* __restrict__ keys,
    const int* __restrict__ vals, const uint8_t* __restrict__ mask, int Q,
    int max_rounds, uint8_t* __restrict__ okf, uint8_t* __restrict__ present,
    int* __restrict__ slot, int* __restrict__ remaining) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  // phase 0: presence in either row, on the table as it was before the batch
  for (int i = tid; i < Q; i += stride) {
    bool there = false;
    bool todo = false;
    if (mask[i]) {
      const int key = keys[i];
      there = dhash_row_find<VEC>(tk, ts, rows_a[i], W, key) >= 0 ||
              dhash_row_find<VEC>(tk, ts, rows_b[i], W, key) >= 0;
      todo = !there;
    }
    present[i] = there ? 1 : 0;
    okf[i] = 0;
    slot[i] = todo ? -1 : -2;
    if (todo) atomicAdd(remaining, 1);
  }
  grid.sync();

  volatile int* rem = remaining;
  for (int r = 0; r < max_rounds; ++r) {
    if (*rem == 0) break;
    // phase A: every pending query bids for the first free lane of its row
    for (int i = tid; i < Q; i += stride) {
      if (slot[i] == -2) continue;
      const long long row = (r & 1) ? rows_b[i] : rows_a[i];
      const int lane = row_first_free<VEC>(ts, row, W);
      int s = -1;
      if (lane >= 0) {
        s = (int)(row * W + lane);
        atomicMin(&claim[s], i);
      }
      slot[i] = s;
    }
    grid.sync();
    // phase B: the lowest bidder writes and restores the claim word
    for (int i = tid; i < Q; i += stride) {
      const int s = slot[i];
      if (s < 0) continue;
      if (__ldcg(&claim[s]) == i) {
        tk[s] = keys[i];
        tv[s] = vals[i];
        ts[s] = DHASH_LIVE;
        claim[s] = INT_MAX;
        slot[i] = -2;
        okf[i] = 1;
        atomicSub(remaining, 1);
      }
    }
    grid.sync();
  }
}

// co-resident blocks of each instance of the kernel, for each device that
// has launched it
#define DHASH_MAX_DEVICES 64
static int g_max_blocks[DHASH_MAX_DEVICES][2];

extern "C" int dhash_tc_insert(
    int* tk, int* tv, int* ts, int* claim, int W, const int* rows_a,
    const int* rows_b, const int* keys, const int* vals, const uint8_t* mask,
    int Q, int max_rounds, uint8_t* okf, uint8_t* present, int* slot,
    int* remaining, void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const bool vec = dhash_rows_vec_ok(W, tk, ts);
  void* fn = vec ? (void*)tc_insert_kernel<true> : (void*)tc_insert_kernel<false>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= DHASH_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int& max_blocks = g_max_blocks[dev][vec ? 1 : 0];
  if (max_blocks == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    max_blocks = sms * per_sm;
  }
  int blocks = (Q + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  void* args[] = {&tk,     &tv,   &ts,   &claim, &W,          &rows_a,
                  &rows_b, &keys, &vals, &mask,  &Q,          &max_rounds,
                  &okf,    &present, &slot, &remaining};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

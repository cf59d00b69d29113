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
// In one round every query aimed at a row bids for the same lane (the
// row's first free one), so arbitration is one claim word a ROW, not a slot.
// No grid-wide barrier: the rounds are split where the work is.
//
//   1. tc_insert_bid, over the grid, one query a thread: presence in both
//      rows, and for a pending query round 0's bid — the first free lane of
//      row a, atomicMin(claim[row a], index).  It reads only the table
//      before the batch, as round 0 must.
//   2. tc_insert_resolve, over the grid (the launch boundary is the round's
//      barrier): the bidder whose index is in its row's word writes the lane
//      and restores the word to INT_MAX; the others still pending (losers,
//      and queries whose row a was full) go to a list in device memory, in
//      no particular order — the lowest index wins by atomicMin whatever the
//      order; a few percent of the batch at the main path's load.  Each
//      block then fences its writes and counts itself done, and the block
//      that counts last runs rounds 1 .. max_rounds-1 over the list
//      (tc_rounds): a block's barriers between a round's bids, its reads of
//      the claim words and its writes.  The rounds end when no query is
//      pending, or when two rounds in a row (one on rows a, one on rows b)
//      found no free lane for any query: rows only fill, so no later round
//      can place one.
//
// (One block for the whole batch, presence, the list and every round, was
// timed against this split and was 5-6x slower at the main path's Q; PERF.md
// keeps its times.)  States, claim words and list entries that
// another block or launch wrote are read with __ldcg (from L2); a row is
// read as 16-byte loads where W allows.  Nothing depends on the order in
// which threads run, so the result is deterministic.  The claim words
// (int32 a row, all INT_MAX between launches) are allocated once with the
// table; `slot` (a query's round-0 bid, then a listed query's bid), `list`
// and `count` (the list's length and the count of blocks done) are scratch.
//
// Bound: latency.  The bytes are a few rows a query (0.00047 ms at the main
// path's Q = 8192); the time is two launches back to back and the last
// block's rounds, where one SM sends every scattered load and atomic of the
// queries still pending: a few percent of the batch on twochoice, about
// one in seven on cuckoo (half the rows a side), so there the rounds cost
// more than the two launches.
//
// Caller contract (as the reference): mask is winner-filtered, at most one
// set entry for each distinct key.
#include <limits.h>

#include "dhash_common.cuh"

#define TC_THREADS 256
#define TC_RESOLVE_THREADS 256

// slot values of a query after the bid: not pending, or pending without a
// lane in row a
#define TC_IDLE -2
#define TC_NO_LANE -1

template <bool VEC>
__device__ __forceinline__ bool tc_present(const int* tk, const int* ts,
                                           int ra, int rb, int W, int key) {
  return dhash_row_find<VEC>(tk, ts, ra, W, key) >= 0 ||
         dhash_row_find<VEC>(tk, ts, rb, W, key) >= 0;
}

template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS) tc_insert_bid(
    const int* __restrict__ tk, const int* __restrict__ ts, int* claim, int W,
    const int* __restrict__ rows_a, const int* __restrict__ rows_b,
    const int* __restrict__ keys, const uint8_t* __restrict__ mask, int Q,
    int max_rounds, uint8_t* __restrict__ okf, uint8_t* __restrict__ present,
    int* __restrict__ slot, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) count[0] = count[1] = 0;
  if (i >= Q) return;
  bool there = false;
  int s = TC_IDLE;
  if (mask[i]) {
    const int ra = rows_a[i];
    there = tc_present<VEC>(tk, ts, ra, rows_b[i], W, keys[i]);
    if (!there && max_rounds > 0) {
      const int lane = dhash_row_first_free<VEC>(ts, ra, W);
      s = TC_NO_LANE;
      if (lane >= 0) {
        s = ra * W + lane;
        atomicMin(&claim[ra], i);
      }
    }
  }
  present[i] = there ? 1 : 0;
  okf[i] = 0;
  slot[i] = s;
}

// Rounds [first, max_rounds) over the n listed queries, by one block: bids
// on the table as the last round left it, the lowest bidder of each row
// marked by flipping its list entry, then the writes, with a barrier
// between each; every claim word a bid took is restored.  Ends when no
// query is pending, or after two rounds in a row (one on rows a, one on
// rows b) without a bid: rows only fill, so no later round can place one.
// The counts ride on the barriers (__syncthreads_or), not on shared atomics.
template <bool VEC>
__device__ __forceinline__ void tc_rounds(
    int* tk, int* tv, int* ts, int* claim, int W,
    const int* __restrict__ rows_a, const int* __restrict__ rows_b,
    const int* __restrict__ keys, const int* __restrict__ vals, int n,
    int first, int max_rounds, uint8_t* okf, int* bid, int* list) {
  const int t = threadIdx.x;
  int dry = 0;
  for (int r = first; r < max_rounds; ++r) {
    int mine = 0;
    for (int j = t; j < n; j += blockDim.x) {
      const int i = __ldcg(&list[j]);
      int s = -1;
      if (i >= 0) {
        const int row = (r & 1) ? rows_b[i] : rows_a[i];
        const int lane = dhash_row_first_free<VEC>(ts, row, W);
        if (lane >= 0) {
          s = row * W + lane;
          atomicMin(&claim[row], i);
          mine = 1;
        }
      }
      bid[j] = s;
    }
    const int bids = __syncthreads_or(mine);
    for (int j = t; j < n; j += blockDim.x) {
      const int i = list[j];
      const int s = bid[j];
      if (i >= 0 && s >= 0 && __ldcg(&claim[s / W]) == i) list[j] = ~i;
    }
    __syncthreads();
    int left = 0;
    for (int j = t; j < n; j += blockDim.x) {
      const int s = bid[j];
      const int e = list[j];
      if (s >= 0) claim[s / W] = INT_MAX;
      if (e >= 0) {
        left = 1;
        continue;
      }
      if (s < 0) continue;         // placed in an earlier round
      const int i = ~e;
      tk[s] = keys[i];
      tv[s] = vals[i];
      ts[s] = DHASH_LIVE;
      okf[i] = 1;
      list[j] = INT_MIN;           // placed: skipped from now on
    }
    dry = bids ? 0 : dry + 1;
    if (!__syncthreads_or(left) || dry >= 2) break;
  }
}

// Round 0's resolve over the grid, then rounds 1.. in the last block to
// finish (a block fences its writes and counts itself done; the one that
// counts last has every block's writes and list entries in view).
template <bool VEC>
__global__ void __launch_bounds__(TC_RESOLVE_THREADS) tc_insert_resolve(
    int* tk, int* tv, int* ts, int* claim, int W,
    const int* __restrict__ rows_a, const int* __restrict__ rows_b,
    const int* __restrict__ keys, const int* __restrict__ vals, int Q,
    int max_rounds, uint8_t* okf, int* slot, int* list, int* count) {
  __shared__ int last_sh;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = i < Q ? slot[i] : TC_IDLE;
  bool keep = false;
  if (s >= 0 && __ldcg(&claim[s / W]) == i) {
    tk[s] = keys[i];
    tv[s] = vals[i];
    ts[s] = DHASH_LIVE;
    claim[s / W] = INT_MAX;
    okf[i] = 1;
  } else if (s != TC_IDLE && max_rounds > 1) {
    keep = true;
  }
  // one atomic a warp for the list positions
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31;
  if (ballot) {
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&count[0], __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (keep) list[base + __popc(ballot & ((1u << lane) - 1u))] = i;
  }
  if (max_rounds < 2) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_sh = atomicAdd(&count[1], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last_sh) return;
  __threadfence();
  const int n = atomicAdd(&count[0], 0);
  if (n == 0) return;
  tc_rounds<VEC>(tk, tv, ts, claim, W, rows_a, rows_b, keys, vals, n, 1,
                 max_rounds, okf, slot, list);
}

extern "C" int dhash_tc_insert(
    int* tk, int* tv, int* ts, int* claim, int W, const int* rows_a,
    const int* rows_b, const int* keys, const int* vals, const uint8_t* mask,
    int Q, int max_rounds, uint8_t* okf, uint8_t* present, int* slot,
    int* list, int* count, void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (Q < 1) return (int)cudaSuccess;
  const bool vec = dhash_rows_vec_ok(W, tk, ts);
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (Q + TC_THREADS - 1) / TC_THREADS;
  if (vec)
    tc_insert_bid<true><<<blocks, TC_THREADS, 0, s>>>(
        tk, ts, claim, W, rows_a, rows_b, keys, mask, Q, max_rounds, okf,
        present, slot, count);
  else
    tc_insert_bid<false><<<blocks, TC_THREADS, 0, s>>>(
        tk, ts, claim, W, rows_a, rows_b, keys, mask, Q, max_rounds, okf,
        present, slot, count);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rblocks = (Q + TC_RESOLVE_THREADS - 1) / TC_RESOLVE_THREADS;
  if (vec)
    tc_insert_resolve<true><<<rblocks, TC_RESOLVE_THREADS, 0, s>>>(
        tk, tv, ts, claim, W, rows_a, rows_b, keys, vals, Q, max_rounds, okf,
        slot, list, count);
  else
    tc_insert_resolve<false><<<rblocks, TC_RESOLVE_THREADS, 0, s>>>(
        tk, tv, ts, claim, W, rows_a, rows_b, keys, vals, Q, max_rounds, okf,
        slot, list, count);
  return (int)cudaGetLastError();
}

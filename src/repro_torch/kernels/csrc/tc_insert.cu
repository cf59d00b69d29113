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
// With max_kick > 0 (the cuckoo insert) the same last block then runs the
// bounded kick-out over the same list (dhash_kick_rounds in
// dhash_common.cuh, the body the standalone cuckoo_kick kernel shares):
// after the rounds the list's entries >= 0 are exactly the queries the
// kick-out takes, winner & ~ok & ~present (a placed entry is INT_MIN); the
// last round's writes gather them into `work` as they pass, and the claim
// words are the kick-out's row locks.  A cuckoo insert is these two launches; with
// nothing left after the rounds the kick-out costs nothing.
//
// (One block for the whole batch, presence, the list and every round, was
// timed against this split and was 5-6x slower at the main path's Q; the
// kick-out as a third kernel, a programmatic dependent of the resolve, was
// timed against the fold; PERF.md keeps both times.)  States, claim words and list entries that
// another block or launch wrote are read with __ldcg (from L2); a row is
// read as 16-byte loads where W allows.  Nothing depends on the order in
// which threads run, so the result is deterministic.  The claim words
// (int32 a row, all INT_MAX between launches) are allocated once with the
// table.  Everything else lives in one int32 scratch the C entry carves:
// `slot` (a query's round-0 bid, then a listed query's bid) at [0, Q),
// `list` at [Q, 2Q), `count` (the list's length and the count of blocks
// done) at [2Q, 2Q + 2), and for the kick-out `work` (the queries the
// rounds leave) at [2Q + 2, 3Q + 2) and `plan` (three words a query of
// `work`) at [3Q + 2, 6Q + 2):
// scratch: 2 * Q + 2 + 4 * Q * (max_kick > 0) int32 words
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
// Returns whether a listed query may be left unplaced (1 where no round
// ran).  GATHER (the kick-out's rounds): the round that ends the rounds
// also gathers the queries it leaves unplaced into `work`, in no order
// (one shared atomic a query), and the call returns their count.
template <bool VEC, bool GATHER>
__device__ __forceinline__ int tc_rounds(
    int* tk, int* tv, int* ts, int* claim, int W,
    const int* __restrict__ rows_a, const int* __restrict__ rows_b,
    const int* __restrict__ keys, const int* __restrict__ vals, int n,
    int first, int max_rounds, uint8_t* okf, int* bid, int* list,
    int* work) {
  __shared__ int m_sh;
  const int t = threadIdx.x;
  if (GATHER && t == 0) m_sh = 0;
  if (GATHER && first >= max_rounds) {      // no round: every entry left
    __syncthreads();
    for (int j = t; j < n; j += blockDim.x) {
      const int e = __ldcg(&list[j]);
      if (e >= 0) work[atomicAdd(&m_sh, 1)] = e;
    }
    __syncthreads();
    return m_sh;
  }
  int dry = 0, any_left = 1;
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
    dry = bids ? 0 : dry + 1;
    const bool last = r == max_rounds - 1 || dry >= 2;
    int left = 0;
    for (int j = t; j < n; j += blockDim.x) {
      const int s = bid[j];
      const int e = list[j];
      if (s >= 0) claim[s / W] = INT_MAX;
      if (e >= 0) {
        left = 1;
        if (GATHER && last) work[atomicAdd(&m_sh, 1)] = e;
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
    any_left = __syncthreads_or(left);
    if (!any_left || dry >= 2) break;
  }
  if (GATHER) return any_left ? m_sh : 0;
  return any_left;
}

// Round 0's resolve over the grid, then rounds 1.. and the kick-out in the
// last block to finish (a block fences its writes and counts itself done;
// the one that counts last has every block's writes and list entries in
// view).  KICK compiles the kick-out in (max_kick > 0); the twochoice
// insert's resolve is built without it.
template <bool VEC, bool KICK>
__global__ void __launch_bounds__(TC_RESOLVE_THREADS) tc_insert_resolve(
    int* tk, int* tv, int* ts, int* claim, int W,
    const int* __restrict__ rows_a, const int* __restrict__ rows_b,
    const int* __restrict__ keys, const int* __restrict__ vals, int Q,
    int max_rounds, uint8_t* okf, int* slot, int* list, int* count,
    int max_kick, int nbuckets, const long long* __restrict__ seeds_a,
    int kind_a, const long long* __restrict__ seeds_b, int kind_b, int* work,
    int* plan, int* tally) {
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
  } else if (s != TC_IDLE && (max_rounds > 1 || KICK)) {
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
  if (max_rounds < 2 && !KICK) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_sh = atomicAdd(&count[1], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last_sh) return;
  __threadfence();
  const int n = atomicAdd(&count[0], 0);
  // with the kick-out: the queries the rounds leave, gathered into `work`
  const int m = n > 0 ? tc_rounds<VEC, KICK>(tk, tv, ts, claim, W, rows_a,
                                             rows_b, keys, vals, n, 1,
                                             max_rounds, okf, slot, list,
                                             work)
                      : 0;
  if (KICK && m > 0)
    dhash_kick_rounds<VEC>(
        tk, tv, ts, W, nbuckets, rows_a, rows_b, keys, vals, okf, max_kick,
        seeds_a, kind_a, seeds_b, kind_b, claim, work, m, plan, tally);
}

extern "C" int dhash_tc_insert(
    int* tk, int* tv, int* ts, int* claim, int W, const int* rows_a,
    const int* rows_b, const int* keys, const int* vals, const uint8_t* mask,
    int Q, int max_rounds, uint8_t* okf, uint8_t* present, int* scratch,
    int max_kick, int nbuckets, const long long* seeds_a, int kind_a,
    const long long* seeds_b, int kind_b, int* tally, void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (Q < 1) return (int)cudaSuccess;
  if (max_kick < 0) max_kick = 0;
  int* slot = scratch;
  int* list = scratch + Q;
  int* count = scratch + 2 * (long long)Q;
  int* work = max_kick > 0 ? count + 2 : nullptr;
  int* plan = max_kick > 0 ? work + Q : nullptr;
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
#define TC_RESOLVE(V, K)                                                     \
  tc_insert_resolve<V, K><<<rblocks, TC_RESOLVE_THREADS, 0, s>>>(             \
      tk, tv, ts, claim, W, rows_a, rows_b, keys, vals, Q, max_rounds, okf,  \
      slot, list, count, max_kick, nbuckets, seeds_a, kind_a, seeds_b,       \
      kind_b, work, plan, tally)
  if (vec && max_kick > 0)
    TC_RESOLVE(true, true);
  else if (vec)
    TC_RESOLVE(true, false);
  else if (max_kick > 0)
    TC_RESOLVE(false, true);
  else
    TC_RESOLVE(false, false);
#undef TC_RESOLVE
  return (int)cudaGetLastError();
}

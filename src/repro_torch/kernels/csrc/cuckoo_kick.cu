// cuckoo_kick: the cuckoo insert's bounded kick-out, one guarded launch, in
// place.
//
// Replaces no Pallas kernel: the reference runs it as XLA code behind
// lax.cond(maybe.any(), kick, ...) (src/repro/core/backend.py,
// cuckoo_insert_fused) around the fori_loop of kernels/ref.py
// cuckoo_kick_ref.  The placement is cuckoo_kick_ref's over the whole batch
// for max_kick iterations, slot for slot:
//
//   * the pending queries are the winners that the claim kernel left
//     unplaced and that were not present (winner & ~ok & ~present);
//   * in iteration `it` each pending query forms one plan on the table as
//     it is at the start of the iteration: plan A, the first free lane of
//     row a, else of row b; plan B (both rows full), the first LIVE victim
//     among the 2W lanes (row a's, then row b's) scanned from lane it mod 2W
//     whose occupant's alternate row (the other side, under the other hash
//     function) has a free lane;
//   * a per-row lock goes to the lowest batch index among the plans that
//     touch the row (plan A its target row, plan B the victim's row and
//     the alternate row); a query acts only if it holds every row its plan
//     touches: plan A writes the key into its lane, plan B moves the victim
//     into the alternate row's first free lane and writes the key into the
//     lane it vacated.
//
// One block of 1024 threads runs it all: an ordered compaction of the
// pending indices into `list` (a query that takes no part in an iteration
// changes nothing, so only the pending ones are walked), then the
// iterations (dhash_kick_rounds in dhash_common.cuh, the body this kernel
// shares with tc_insert's resolve, which runs the kick-out of the cuckoo
// insert itself: this kernel serves callers that have no resolve).  The
// row locks are the table's claim words (one int32 a row, INT_MAX between
// launches, shared with tc_insert).  With nothing pending the launch reads
// the Q flags once and returns: that is the guard.
//
// Bound: latency, not bytes — a few rows a pending query an iteration, each
// iteration three block barriers and one round trip to L2 for the locks.
// `tally` (optional) accumulates launches that found work, iterations run
// and pending queries taken, for a harness to read.
#include "dhash_common.cuh"

#define KICK_THREADS 1024

template <bool VEC>
__global__ void __launch_bounds__(KICK_THREADS) cuckoo_kick_kernel(
    int* tk, int* tv, int* ts, int W, int nbuckets,
    const int* __restrict__ rows_a, const int* __restrict__ rows_b,
    const int* __restrict__ keys, const int* __restrict__ vals,
    const uint8_t* __restrict__ winner, uint8_t* ok,
    const uint8_t* __restrict__ present, int Q, int max_kick,
    const long long* __restrict__ seeds_a, int kind_a,
    const long long* __restrict__ seeds_b, int kind_b, int* lock, int* list,
    int* plan, int* tally) {
  __shared__ int warp_tot[32];
  __shared__ int n_sh[2];
  if (threadIdx.x == 0) n_sh[0] = 0;
  __syncthreads();
  dhash_block_compact(
      Q, [&](int i) { return winner[i] && !ok[i] && !present[i]; }, list,
      warp_tot, n_sh);
  const int n = n_sh[0];
  if (n == 0) return;
  dhash_kick_rounds<VEC>(
      tk, tv, ts, W, nbuckets, rows_a, rows_b, keys, vals, ok, max_kick,
      seeds_a, kind_a, seeds_b, kind_b, lock, list, n, plan, tally);
}

extern "C" int dhash_cuckoo_kick(
    int* tk, int* tv, int* ts, int W, int nbuckets, const int* rows_a,
    const int* rows_b, const int* keys, const int* vals, const uint8_t* winner,
    uint8_t* ok, const uint8_t* present, int Q, int max_kick,
    const long long* seeds_a, int kind_a, const long long* seeds_b,
    int kind_b, int* lock, int* list, int* plan, int* tally, void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (Q < 1) return (int)cudaSuccess;
  const bool vec = dhash_rows_vec_ok(W, tk, ts);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    cuckoo_kick_kernel<true><<<1, KICK_THREADS, 0, s>>>(
        tk, tv, ts, W, nbuckets, rows_a, rows_b, keys, vals, winner, ok,
        present, Q, max_kick, seeds_a, kind_a, seeds_b, kind_b, lock, list,
        plan, tally);
  else
    cuckoo_kick_kernel<false><<<1, KICK_THREADS, 0, s>>>(
        tk, tv, ts, W, nbuckets, rows_a, rows_b, keys, vals, winner, ok,
        present, Q, max_kick, seeds_a, kind_a, seeds_b, kind_b, lock, list,
        plan, tally);
  return (int)cudaGetLastError();
}

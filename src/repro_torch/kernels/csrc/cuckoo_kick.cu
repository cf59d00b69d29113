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
// iterations in lock step with barriers between the plan, the lock read and
// the writes.  The row locks are the table's claim words (one int32 a row,
// INT_MAX between launches, shared with tc_insert), taken with atomicMin in
// L2 and restored by every query that took one.  The iterations end early
// on the device when no query is pending, or when no pending query could
// form a plan (then none ever can: the table did not change); both counts
// ride on the barriers (__syncthreads_or).  With nothing
// pending the launch reads the Q flags once and returns: that is the guard.
//
// Bound: latency, not bytes — a few rows a pending query an iteration, each
// iteration three block barriers and one round trip to L2 for the locks.
// `tally` (optional) accumulates launches that found work, iterations run
// and pending queries taken, for a harness to read.
#include <limits.h>

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
  const int t = threadIdx.x;
  if (t == 0) n_sh[0] = 0;
  __syncthreads();
  dhash_block_compact(
      Q, [&](int i) { return winner[i] && !ok[i] && !present[i]; }, list,
      warp_tot, n_sh);
  const int n = n_sh[0];
  if (n == 0) return;
  int it = 0;
  while (it < max_kick) {
    // plan: on the table as it is at the start of the iteration
    int planned = 0;
    for (int j = t; j < n; j += blockDim.x) {
      const int i = list[j];
      if (i < 0) continue;
      const int ra = rows_a[i], rb = rows_b[i];
      int kind = 0, slot = 0, row2 = 0;
      const int la = dhash_row_first_free<VEC>(ts, ra, W);
      const int lb = la >= 0 ? -1 : dhash_row_first_free<VEC>(ts, rb, W);
      if (la >= 0 || lb >= 0) {
        kind = 1;
        slot = la >= 0 ? ra * W + la : rb * W + lb;
      } else {
        for (int r = 0; r < 2 * W; ++r) {
          const int l = (r + it) % (2 * W);
          const int vrow = l < W ? ra : rb;
          const int vs = vrow * W + (l % W);
          if (__ldcg(ts + vs) != DHASH_LIVE) continue;
          const int vkey = __ldcg(tk + vs);
          const int alt = l < W
              ? nbuckets + dhash_bucket_of(kind_b, seeds_b, vkey, nbuckets)
              : dhash_bucket_of(kind_a, seeds_a, vkey, nbuckets);
          if (dhash_row_first_free<VEC>(ts, alt, W) >= 0) {
            kind = 2;
            slot = vs;
            row2 = alt;
            break;
          }
        }
      }
      plan[3 * j] = kind;
      plan[3 * j + 1] = slot;
      plan[3 * j + 2] = row2;
      if (kind) {
        atomicMin(&lock[slot / W], i);
        if (kind == 2) atomicMin(&lock[row2], i);
        planned = 1;
      }
    }
    if (!__syncthreads_or(planned)) break;   // no plan now, none ever: stop
    ++it;
    // the locks: a plan acts only on rows it holds
    for (int j = t; j < n; j += blockDim.x) {
      const int i = list[j];
      const int kind = plan[3 * j];
      if (i < 0 || kind == 0) continue;
      const bool own = __ldcg(&lock[plan[3 * j + 1] / W]) == i &&
                       (kind != 2 || __ldcg(&lock[plan[3 * j + 2]]) == i);
      if (own) plan[3 * j] = kind + 2;
    }
    __syncthreads();
    // the writes, each in rows its query holds; every lock taken restored
    int left = 0;
    for (int j = t; j < n; j += blockDim.x) {
      const int i = list[j];
      const int kind = plan[3 * j];
      if (i < 0) continue;
      left |= kind <= 2;
      if (kind == 0) continue;
      const int slot = plan[3 * j + 1], row2 = plan[3 * j + 2];
      const bool b = kind == 2 || kind == 4;
      lock[slot / W] = INT_MAX;
      if (b) lock[row2] = INT_MAX;
      if (kind <= 2) continue;
      if (b) {
        const int alt = row2 * W + dhash_row_first_free<VEC>(ts, row2, W);
        tk[alt] = tk[slot];
        tv[alt] = tv[slot];
        ts[alt] = DHASH_LIVE;
      }
      tk[slot] = keys[i];
      tv[slot] = vals[i];
      ts[slot] = DHASH_LIVE;
      ok[i] = 1;
      list[j] = -1;
    }
    if (!__syncthreads_or(left)) break;      // every key placed
  }
  if (t == 0 && tally != nullptr) {
    atomicAdd(&tally[0], 1);
    atomicAdd(&tally[1], it);
    atomicAdd(&tally[2], n);
  }
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

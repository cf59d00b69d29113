// probe_lookup: batched linear-probe lookup, one thread a query.
//
// Replaces the TPU kernel _probe_kernel (src/repro/kernels/probe.py), which
// sorted the queries by start slot and probed a two-block window of a padded
// table copy held in fast memory.  Here a thread gathers straight from global
// memory: a table of 2^21 slots (24 MiB) stays in the 50 MB L2, and a larger
// one costs a few 32-byte sectors a window.  The hit's slot is emitted so
// that a delete is this kernel plus one scatter.
//
// Bound: latency.  The bytes are a few sectors a query (0.0007 ms at the
// main path's Q = 65536); the time is the walk's round trips to L2, which
// run one behind another in a thread.  The walk of a slot by slot design
// was h0, then the state, then the key behind the branch, then the next
// slot, then the value: about seven round trips a query on a table with
// TOMB and MIGRATED runs (2.3 slots a query).  This design cuts them:
//
//   * the start slot comes either from h0[] or from the key itself, hashed
//     in the kernel (dhash_bucket_of, core/hashing.py's bucket_of bit for
//     bit, given the table's seeds and kind), so the caller issues no
//     hashing ops and the kernel no h0 load behind the key's;
//   * the walk reads aligned windows of 4 slots: the states, keys and
//     values of the window that holds the current slot as three 16-byte
//     loads issued together, then tests the window's slots from the
//     current one in order, stopping at the first hit or EMPTY slot and
//     after max_probes slots, wrapping at C.  A run of 2-3 slots costs one
//     round trip, or two where it crosses a window's edge.
//
// The windowed walk needs C a multiple of 4 and 16-byte aligned arrays (a
// table's own tensors always are); elsewhere a thread walks slot by slot
// (dhash_probe_one, shared with probe2).
#include "dhash_common.cuh"

#define LOOKUP_THREADS 256

// One query's walk from `pos` in windows of 4 slots (C % 4 == 0, aligned).
__device__ __forceinline__ bool probe_walk_windows(
    const int* __restrict__ tk, const int* __restrict__ tv,
    const int* __restrict__ ts, int C, int pos, int key, int max_probes,
    int* val, int* loc) {
  int p = 0;
  while (true) {
    const int base = pos & ~3;
    const int off = pos - base;
    const int4 s = __ldg(reinterpret_cast<const int4*>(ts + base));
    const int4 k = __ldg(reinterpret_cast<const int4*>(tk + base));
    const int4 v = __ldg(reinterpret_cast<const int4*>(tv + base));
    const int ss[4] = {s.x, s.y, s.z, s.w};
    const int kk[4] = {k.x, k.y, k.z, k.w};
    const int vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < off) continue;
      if (p == max_probes || ss[j] == DHASH_EMPTY) {
        *val = 0;
        *loc = -1;
        return false;
      }
      if (ss[j] == DHASH_LIVE && kk[j] == key) {
        *val = vv[j];
        *loc = base + j;
        return true;
      }
      ++p;
    }
    pos = base + 4 == C ? 0 : base + 4;
  }
}

// h0 == nullptr: the start slot is bucket_of(key) under (kind, seeds).
template <bool VEC>
__global__ void __launch_bounds__(LOOKUP_THREADS) probe_lookup_kernel(
    const int* __restrict__ tk, const int* __restrict__ tv,
    const int* __restrict__ ts, int C, const int* __restrict__ h0,
    const long long* __restrict__ seeds, int kind,
    const int* __restrict__ qk, int Q, int max_probes,
    uint8_t* __restrict__ found, int* __restrict__ val,
    int* __restrict__ loc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int key = qk[i];
  const int start = h0 != nullptr ? h0[i]
                                  : dhash_bucket_of(kind, seeds, key, C);
  int v, l;
  const bool f =
      VEC ? probe_walk_windows(tk, tv, ts, C, start, key, max_probes, &v, &l)
          : dhash_probe_one(tk, tv, ts, C, start, key, max_probes, &v, &l);
  found[i] = f ? 1 : 0;
  val[i] = v;
  loc[i] = l;
}

extern "C" int dhash_probe_lookup(
    const int* tk, const int* tv, const int* ts, int C, const int* h0,
    const long long* seeds, int kind, const int* qk, int Q, int max_probes,
    uint8_t* found, int* val, int* loc, void* stream) {
  if (Q < 1) return (int)cudaSuccess;
  if (h0 == nullptr && seeds == nullptr) return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && dhash_rows_vec_ok(4, tk, tv, ts);
  const int blocks = (Q + LOOKUP_THREADS - 1) / LOOKUP_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    probe_lookup_kernel<true><<<blocks, LOOKUP_THREADS, 0, s>>>(
        tk, tv, ts, C, h0, seeds, kind, qk, Q, max_probes, found, val, loc);
  else
    probe_lookup_kernel<false><<<blocks, LOOKUP_THREADS, 0, s>>>(
        tk, tv, ts, C, h0, seeds, kind, qk, Q, max_probes, found, val, loc);
  return (int)cudaGetLastError();
}

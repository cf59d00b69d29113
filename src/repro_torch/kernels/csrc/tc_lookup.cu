// tc_lookup: batched two-row lookup (twochoice and cuckoo), a pair of lanes
// a query, the rows given or hashed in the kernel.
//
// Replaces the TPU kernel _tc_lookup_kernel (src/repro/kernels/probe.py,
// with its row probe _tc_row_probe) AND the recombine its wrapper did after
// it (src/repro/kernels/ops.py, twochoice_lookup).  The TPU version expanded
// every query into two entries (one per candidate row), sorted the 2Q entries
// by row, padded the table to whole row blocks and gathered from a window of
// two resident blocks a tile, flagging entries whose row escaped the window
// for a fallback pass; the wrapper then unsorted the entries and merged the
// two of each query with a-row priority.  Here the rows are read where they
// lie in global memory: a table of 2^18 x 8 slots (24 MiB) stays in the
// 50 MB L2.  Results come back in query order, one a query, with loc = row *
// W + lane, the flat slot.  Cuckoo tables use the same kernel with
// side-offset rows.
//
// Bound: bytes at the HBM rate (chip_smoke.py counts them from its inputs:
// the keys of each row read, the state of each lane whose key matches up to
// the first LIVE one, a value a hit, and a query's inputs and outputs).  The
// main path's tables sit in L2, and the time is round trips to it.  The
// first design gave a query one thread that read row a's states
// and keys, and only on a miss row b's, then the hit's value: three or four
// dependent round trips, with the rows computed by the caller (two
// bucket_of calls, ~50 PyTorch ops each, on every steady lookup and delete).
// Reading both rows' states and keys at once from one thread was slower at
// 65536 queries (twice the row bytes), and so was reading the values with
// the rows.  This design:
//
//   * the rows come from rows_a[] / rows_b[] or from the key itself, hashed
//     in the kernel (dhash_bucket_of, core/hashing.py's bucket_of bit for
//     bit, given both hash functions' kinds and seeds, the bucket count and
//     row b's offset: 0 on twochoice, the bucket count on cuckoo), so the
//     caller issues no hashing ops;
//   * a query is a pair of lanes, the even one on row a and the odd one on
//     row b, so both rows are in flight at once and a small batch fills
//     twice the threads; where rb == ra the odd lane reads nothing;
//   * a lane reads its row's keys first (two 16-byte loads at W = 8), then
//     the state and value of each lane whose key is the query's, loaded
//     together, until one is LIVE: a key in neither row reads no state
//     (two round trips), a hit one sector of states and one of values more
//     (three);
//   * the pair's answer, row a's hit else row b's, goes to the even lane by
//     two shuffles.
//
// Keys are read as 16-byte loads where W is a multiple of 4 and the key
// array is 16-byte aligned, else lane by lane.
#include "dhash_common.cuh"

#define TC_LOOKUP_THREADS 256

// The lanes of a 4-lane chunk whose key is `key`, as bits.
__device__ __forceinline__ unsigned tc_equal4(int4 k, int key) {
  return (unsigned)(k.x == key) | (unsigned)(k.y == key) << 1 |
         (unsigned)(k.z == key) << 2 | (unsigned)(k.w == key) << 3;
}

// The flat slot of the first lane of the row at `base` that holds `key`
// LIVE, or -1; its value in *val.  The row's keys are read G 16-byte chunks
// a step (G = 0: lane by lane), then the state and value of each lane whose
// key matches, in lane order.
template <int G>
__device__ __forceinline__ int tc_row_lookup(const int* __restrict__ tk,
                                             const int* __restrict__ tv,
                                             const int* __restrict__ ts,
                                             int W, long long base, int key,
                                             int* val) {
  unsigned m = 0;
  if constexpr (G == 0) {
    for (int l = 0; l < W; ++l)
      m |= (unsigned)(__ldg(tk + base + l) == key) << l;
  } else {
    for (int l = 0; l < W; l += 4 * G) {
      int4 k[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        k[g] = __ldg(reinterpret_cast<const int4*>(tk + base + l + 4 * g));
#pragma unroll
      for (int g = 0; g < G; ++g) m |= tc_equal4(k[g], key) << (l + 4 * g);
    }
  }
  for (; m; m &= m - 1) {
    const long long slot = base + __ffs(m) - 1;
    const int st = __ldg(ts + slot), v = __ldg(tv + slot);
    if (st == DHASH_LIVE) {
      *val = v;
      return (int)slot;
    }
  }
  return -1;
}

// A query's rows: given, or bucket_of under the table's two hash functions,
// row b offset by b_off.
struct TcRows {
  const int* a;        // nullptr: hashed
  const int* b;
  const long long* seeds_a;
  const long long* seeds_b;
  int kind_a, kind_b, nbuckets, b_off;
};

template <int G>
__global__ void __launch_bounds__(TC_LOOKUP_THREADS) tc_lookup_kernel(
    const int* __restrict__ tk, const int* __restrict__ tv,
    const int* __restrict__ ts, int W, TcRows rows,
    const int* __restrict__ qk, int Q, uint8_t* __restrict__ found,
    int* __restrict__ val, int* __restrict__ loc) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int i = (int)(t >> 1);
  const bool side_b = t & 1;
  const bool active = i < Q;
  int key = 0, row = 0;
  if (active) {
    key = qk[i];
    if (rows.a != nullptr)
      row = side_b ? rows.b[i] : rows.a[i];
    else
      row = side_b ? rows.b_off + dhash_bucket_of(rows.kind_b, rows.seeds_b,
                                                  key, rows.nbuckets)
                   : dhash_bucket_of(rows.kind_a, rows.seeds_a, key,
                                     rows.nbuckets);
  }
  // every lane of the warp takes part in the shuffles
  const int other = __shfl_xor_sync(0xffffffffu, row, 1);
  int v = 0, slot = -1;
  if (active && !(side_b && row == other))
    slot = tc_row_lookup<G>(tk, tv, ts, W, (long long)row * W, key, &v);
  const int o_slot = __shfl_xor_sync(0xffffffffu, slot, 1);
  const int o_v = __shfl_xor_sync(0xffffffffu, v, 1);
  if (!active || side_b) return;
  if (slot < 0) {
    slot = o_slot;
    v = o_v;
  }
  found[i] = slot >= 0 ? 1 : 0;
  val[i] = slot >= 0 ? v : 0;
  loc[i] = slot;
}

template <int G>
static void tc_launch(const int* tk, const int* tv, const int* ts, int W,
                      const TcRows& rows, const int* qk, int Q,
                      uint8_t* found, int* val, int* loc, cudaStream_t s) {
  const long long lanes = 2LL * Q;
  const int blocks =
      (int)((lanes + TC_LOOKUP_THREADS - 1) / TC_LOOKUP_THREADS);
  tc_lookup_kernel<G><<<blocks, TC_LOOKUP_THREADS, 0, s>>>(
      tk, tv, ts, W, rows, qk, Q, found, val, loc);
}

// rows_a and rows_b given, or both nullptr and the rows hashed in the
// kernel: row a = bucket_of(kind_a, seeds_a) over nbuckets, row b =
// b_offset + bucket_of(kind_b, seeds_b).
extern "C" int dhash_tc_lookup(
    const int* tk, const int* tv, const int* ts, int W, const int* rows_a,
    const int* rows_b, const long long* seeds_a, int kind_a,
    const long long* seeds_b, int kind_b, int nbuckets, int b_offset,
    const int* qk, int Q, uint8_t* found, int* val, int* loc, void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if ((rows_a == nullptr) != (rows_b == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows_a == nullptr &&
      (seeds_a == nullptr || seeds_b == nullptr || nbuckets < 1))
    return (int)cudaErrorInvalidValue;
  if (Q < 1) return (int)cudaSuccess;
  const TcRows rows{rows_a, rows_b, seeds_a, seeds_b,
                    kind_a, kind_b, nbuckets, b_offset};
  cudaStream_t s = (cudaStream_t)stream;
  if (dhash_rows_vec_ok(W, tk, nullptr))
    (W % 8 == 0 ? tc_launch<2> : tc_launch<1>)(tk, tv, ts, W, rows, qk, Q,
                                               found, val, loc, s);
  else
    tc_launch<0>(tk, tv, ts, W, rows, qk, Q, found, val, loc, s);
  return (int)cudaGetLastError();
}

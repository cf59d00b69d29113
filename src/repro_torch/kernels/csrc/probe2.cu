// probe2: the rebuild-epoch ordered check in one pass, one thread a query.
//
// Replaces the TPU kernel _probe2_kernel (src/repro/kernels/probe.py): old
// table probe, then the hazard buffer, then the new table probe, with the
// priority old > hazard > new (the paper's Lemma 4.1).  The TPU version kept
// windows of both tables resident through a two-level tile map and merged
// partial results over a second grid axis; here both tables are gathered in
// place, so there is no tile map, no merge round and no `complete` output.
//
// Bound: bytes -- the two probe runs (a few scattered sectors a query), the
// hazard buffer once, six outputs.  The hazard lookup is a staged set
// (dhash_set_stage / dhash_set_find in dhash_common.cuh), as in tc_probe2.cu:
// each block copies the buffer's keys into shared memory once and builds a
// hashed index over its live entries, so a query the old table did not
// resolve finds the lowest live hazard index holding its key in a few
// shared-memory loads; a hit reads its value from device memory.  (The first
// design staged keys, values and live flags in every 256-thread block and
// compared a query with every live entry up to its first match: 0.124 ms for
// 65536 queries on chip_smoke.py's phase-2 input.)  The grid is at most one
// block of 1024 threads an SM (dhash_set_grid), so the set is built once an
// SM and its cost is shared by all the SM's queries, which come as runs of
// 32 dealt round-robin to the blocks (dhash_set_first); 36 KiB of shared
// memory at chunk = 4096, no opt-in.  Contract: chunk <= 4096 (what the
// extract kernel fills), refused above.
//
// Outputs: found, val, and the ordered-delete components f_old, loc_old
// (slot in the old table), hz_idx (hazard index, only where the old table
// did not resolve the query), loc_new (slot in the new table, only where
// neither the old table nor the hazard buffer resolved it); -1 = none.
//
// A table stack: T tables in one launch, table t on the blocks of grid row
// blockIdx.y, its arrays at row t of the stacked [T, ...] inputs (old
// tables [T, Co], new [T, Cn], hazard [T, chunk], queries and outputs
// [T, Q]).  `rb` (one byte a table, or null: every table) says which
// tables are mid-rebuild; a table whose byte is 0 answers from its old
// table alone (the reference's steady branch, lookup_fused(d.old)) and
// stages no hazard set.  A row takes ceil(SMs / T) blocks at most, so the
// stack's sets are built about once an SM.  One table (T = 1, no flag)
// takes the kernel's STACK = false instance: the code it always was.
#include "dhash_common.cuh"

template <bool STACK>
__global__ void __launch_bounds__(DHASH_SET_THREADS) probe2_kernel(
    const int* __restrict__ ok, const int* __restrict__ ov,
    const int* __restrict__ os, int Co, const int* __restrict__ nk,
    const int* __restrict__ nv, const int* __restrict__ ns, int Cn,
    const int* __restrict__ hk, const int* __restrict__ hv,
    const uint8_t* __restrict__ hl, int chunk, const int* __restrict__ h0o,
    const int* __restrict__ h0n, const int* __restrict__ qk, int Q,
    int max_probes, uint8_t* __restrict__ found, int* __restrict__ val,
    uint8_t* __restrict__ f_old, int* __restrict__ loc_old,
    int* __restrict__ hz_idx, int* __restrict__ loc_new,
    const uint8_t* __restrict__ rb) {
  bool rebuilding = true;
  if (STACK) {
    // table t of the stack: its rows of every input and output
    const int t = blockIdx.y;
    const long long to = (long long)t * Co, tn = (long long)t * Cn,
                    th = (long long)t * chunk, tq = (long long)t * Q;
    ok += to; ov += to; os += to;
    nk += tn; nv += tn; ns += tn;
    hk += th; hv += th; hl += th;
    h0o += tq; h0n += tq; qk += tq;
    found += tq; val += tq; f_old += tq; loc_old += tq; hz_idx += tq;
    loc_new += tq;
    // uniform over the block: the steady branch stages nothing
    rebuilding = rb == nullptr || rb[t] != 0;
  }
  const DhashSet hz_set = dhash_set_at(0, chunk);
  if (rebuilding)
    dhash_set_stage(hz_set, [&](int j, int* k) {
      *k = hk[j];
      return hl[j] != 0;
    });

  for (int i = dhash_set_first(); i < Q; i += dhash_set_stride()) {
    const int key = qk[i];
    int v, lo, hz = -1, ln = -1;
    bool fo = dhash_probe_one(ok, ov, os, Co, h0o[i], key, max_probes, &v,
                              &lo);
    bool f = fo;
    if (!f && rebuilding) {
      hz = dhash_set_find(hz_set, key);
      f = hz >= 0;
      if (f) v = hv[hz];
    }
    if (!f && rebuilding)
      f = dhash_probe_one(nk, nv, ns, Cn, h0n[i], key, max_probes, &v, &ln);
    found[i] = f ? 1 : 0;
    val[i] = v;
    f_old[i] = fo ? 1 : 0;
    loc_old[i] = lo;
    hz_idx[i] = hz;
    loc_new[i] = ln;
  }
}

extern "C" int dhash_probe2(
    const int* ok, const int* ov, const int* os, int Co, const int* nk,
    const int* nv, const int* ns, int Cn, const int* hk, const int* hv,
    const uint8_t* hl, int chunk, const int* h0o, const int* h0n,
    const int* qk, int Q, int max_probes, uint8_t* found, int* val,
    uint8_t* f_old, int* loc_old, int* hz_idx, int* loc_new, int T,
    const uint8_t* rb, void* stream) {
  if (chunk < 0 || chunk > DHASH_MAX_CHUNK || T < 1 || T > 65535)
    return (int)cudaErrorInvalidValue;
  int blocks = 0, sms = 0;
  cudaError_t e = dhash_set_grid(Q, &blocks);
  if (e == cudaSuccess) e = dhash_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int row = (sms + T - 1) / T;
  if (blocks > row) blocks = row;
  const size_t bytes = (size_t)dhash_set_words(chunk) * 4;
  auto kernel = T > 1 || rb != nullptr ? probe2_kernel<true>
                                       : probe2_kernel<false>;
  kernel<<<dim3(blocks, T), DHASH_SET_THREADS, bytes, (cudaStream_t)stream>>>(
      ok, ov, os, Co, nk, nv, ns, Cn, hk, hv, hl, chunk, h0o, h0n, qk, Q,
      max_probes, found, val, f_old, loc_old, hz_idx, loc_new, rb);
  return (int)cudaGetLastError();
}

// tc_probe2: the twochoice / cuckoo rebuild-epoch ordered check in one pass,
// one thread a query.
//
// Replaces the TPU kernel _tc_probe2_kernel (src/repro/kernels/probe.py) AND
// the recombine its wrapper did after it (_tc_ordered_combine in
// src/repro/kernels/ops.py): old rows a then b, then the hazard buffer, then
// new rows a then b, with the priority old > hazard > new (the paper's Lemma
// 4.1).  The TPU version sorted 2Q row entries by old row, padded both
// tables to row blocks, kept a two-level map of resident new-table blocks,
// merged partial results over a second grid axis and flagged escaped rows
// for a fallback; here both tables are read in place, one result a query.
//
// Bound: bytes -- four rows (a few sectors) a query for the two tables, the
// hazard buffer once, six outputs.  The hazard lookup is a staged set
// (dhash_set_stage / dhash_set_find in dhash_common.cuh): each block copies
// the buffer's keys into shared memory once and builds a hashed index over
// its live entries, so a query the old table did not resolve finds the
// lowest live hazard index holding its key in a few shared-memory loads
// (the first design compared it with every live entry, serially: 75 M
// compares for 65536 queries on chip_smoke.py's phase-2 input).  A hit reads
// its value from device memory.  The grid is at most one block of 1024
// threads an SM (dhash_set_grid), so the set is built once an SM and its
// cost is shared by all the SM's queries, which come as runs of 32 dealt
// round-robin to the blocks (dhash_set_first); 36 KiB of shared memory at
// chunk = 4096, no opt-in, one block an SM resident (its threads are the
// limit).  The rows are read as 16-byte loads as in tc_lookup.  Contract:
// chunk <= 4096, refused above.
//
// Outputs, with the meaning of the linear probe2's: found, val, f_old,
// loc_old (flat slot in the old table), hz_idx (only where the old table did
// not resolve the query), loc_new (flat slot in the new table, only where
// neither the old table nor the hazard buffer resolved it); -1 = none.  The
// two tables have the same width and any row counts.
#include "dhash_common.cuh"

template <bool VEC>
__global__ void __launch_bounds__(DHASH_SET_THREADS) tc_probe2_kernel(
    const int* __restrict__ ok, const int* __restrict__ ov,
    const int* __restrict__ os, const int* __restrict__ nk,
    const int* __restrict__ nv, const int* __restrict__ ns, int W,
    const int* __restrict__ hk, const int* __restrict__ hv,
    const uint8_t* __restrict__ hl, int chunk,
    const int* __restrict__ rao, const int* __restrict__ rbo,
    const int* __restrict__ ran, const int* __restrict__ rbn,
    const int* __restrict__ qk, int Q, uint8_t* __restrict__ found,
    int* __restrict__ val, uint8_t* __restrict__ f_old,
    int* __restrict__ loc_old, int* __restrict__ hz_idx,
    int* __restrict__ loc_new) {
  const DhashSet hz_set = dhash_set_at(0, chunk);
  dhash_set_stage(hz_set, [&](int j, int* k) {
    *k = hk[j];
    return hl[j] != 0;
  });

  for (int i = dhash_set_first(); i < Q; i += dhash_set_stride()) {
    const int key = qk[i];
    int v, lo, hz = -1, ln = -1;
    bool fo = dhash_two_row_lookup<VEC>(ok, ov, os, W, rao[i], rbo[i], key,
                                        &v, &lo);
    bool f = fo;
    if (!f) {
      hz = dhash_set_find(hz_set, key);
      f = hz >= 0;
      if (f) v = hv[hz];
    }
    if (!f)
      f = dhash_two_row_lookup<VEC>(nk, nv, ns, W, ran[i], rbn[i], key, &v,
                                    &ln);
    found[i] = f ? 1 : 0;
    val[i] = v;
    f_old[i] = fo ? 1 : 0;
    loc_old[i] = lo;
    hz_idx[i] = hz;
    loc_new[i] = ln;
  }
}

extern "C" int dhash_tc_probe2(
    const int* ok, const int* ov, const int* os, const int* nk,
    const int* nv, const int* ns, int W, const int* hk, const int* hv,
    const uint8_t* hl, int chunk, const int* rao, const int* rbo,
    const int* ran, const int* rbn, const int* qk, int Q, uint8_t* found,
    int* val, uint8_t* f_old, int* loc_old, int* hz_idx, int* loc_new,
    void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH || chunk < 0 || chunk > DHASH_MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = dhash_set_grid(Q, &blocks);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)dhash_set_words(chunk) * 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (dhash_rows_vec_ok(W, ok, os, nk, ns))
    tc_probe2_kernel<true><<<blocks, DHASH_SET_THREADS, bytes, s>>>(
        ok, ov, os, nk, nv, ns, W, hk, hv, hl, chunk, rao, rbo, ran, rbn, qk,
        Q, found, val, f_old, loc_old, hz_idx, loc_new);
  else
    tc_probe2_kernel<false><<<blocks, DHASH_SET_THREADS, bytes, s>>>(
        ok, ov, os, nk, nv, ns, W, hk, hv, hl, chunk, rao, rbo, ran, rbn, qk,
        Q, found, val, f_old, loc_old, hz_idx, loc_new);
  return (int)cudaGetLastError();
}

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
// Bound: operations, as for the linear probe2: the hazard check compares a
// query with every live hazard entry, up to Q x chunk compares, against four
// rows (a few sectors) a query for the two tables.  The hazard stage is the
// linear probe2's (dhash_hazard_stage / dhash_hazard_find in
// dhash_common.cuh): the buffer is staged in shared memory once a block, a
// query the old table resolved skips the scan, and the scan stops at the
// first live match and at the last live entry.  The rows are read as 16-byte
// loads as in tc_lookup.  Contract: chunk <= 4096, refused above.
//
// Outputs, with the meaning of the linear probe2's: found, val, f_old,
// loc_old (flat slot in the old table), hz_idx (only where the old table did
// not resolve the query), loc_new (flat slot in the new table, only where
// neither the old table nor the hazard buffer resolved it); -1 = none.  The
// two tables have the same width and any row counts.
#include "dhash_common.cuh"

template <bool VEC>
__global__ void tc_probe2_kernel(
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
  extern __shared__ int smem[];
  __shared__ int hz_end;   // 1 + index of the last live hazard entry
  const int n_hz = dhash_hazard_stage(hk, hv, hl, chunk, smem, &hz_end);

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int key = qk[i];
  int v, lo, hz = -1, ln = -1;
  bool fo = dhash_two_row_lookup<VEC>(ok, ov, os, W, rao[i], rbo[i], key, &v,
                                      &lo);
  bool f = fo;
  if (!f) {
    hz = dhash_hazard_find(smem, chunk, n_hz, key, &v);
    f = hz >= 0;
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

extern "C" int dhash_tc_probe2(
    const int* ok, const int* ov, const int* os, const int* nk,
    const int* nv, const int* ns, int W, const int* hk, const int* hv,
    const uint8_t* hl, int chunk, const int* rao, const int* rbo,
    const int* ran, const int* rbn, const int* qk, int Q, uint8_t* found,
    int* val, uint8_t* f_old, int* loc_old, int* hz_idx, int* loc_new,
    void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH || chunk > DHASH_MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (Q + threads - 1) / threads;
  size_t bytes = dhash_hazard_smem_bytes(chunk);
  cudaStream_t s = (cudaStream_t)stream;
  if (dhash_rows_vec_ok(W, ok, os, nk, ns))
    tc_probe2_kernel<true><<<blocks, threads, bytes, s>>>(
        ok, ov, os, nk, nv, ns, W, hk, hv, hl, chunk, rao, rbo, ran, rbn, qk,
        Q, found, val, f_old, loc_old, hz_idx, loc_new);
  else
    tc_probe2_kernel<false><<<blocks, threads, bytes, s>>>(
        ok, ov, os, nk, nv, ns, W, hk, hv, hl, chunk, rao, rbo, ran, rbn, qk,
        Q, found, val, f_old, loc_old, hz_idx, loc_new);
  return (int)cudaGetLastError();
}

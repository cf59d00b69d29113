// chain_probe: the chain lookup over the bucket-sorted arena, one thread a
// query.
//
// Replaces the TPU kernel _chain_probe_kernel (src/repro/kernels/probe.py,
// its loop _chain_window_probe) AND what its wrapper did around it
// (_chain_run and the gated fallback of chain_lookup_fused in
// src/repro/kernels/ops.py): the scan of the bucket's sorted segment
// [bstart[b], bstart[b] + blen[b]) for a LIVE node with the key, the lookup
// in the arena's dirty tail (the lowest live tail node holding the key, as
// the dense compare's argmax gives it), and, for a query found nowhere whose
// absence is not proven (a segment longer than max_chain, or a tail longer
// than the window), the reference's bounded walk from heads[b] along next.
// The TPU version sorted the queries, padded the arena, probed a two-block
// window of it in fast memory and sent every query that escaped the window,
// the tail or the bound to a second pass; here a thread reads its segment in
// place and resolves every query itself, so there is no sort, no padded
// copy, no `complete` output and no host read.
//
// Bound: bytes.  A lookup reads two words of its bucket, a segment of a few
// nodes (keys and states as 16-byte loads where the arena is aligned) and
// the value of a hit; the arena of 2^20 nodes (16 MiB with the links)
// stays in the 50 MB L2.  The dirty tail (at most DHASH_MAX_DIRTY = 512
// nodes) is a staged set in shared memory (dhash_set_* in dhash_common.cuh,
// as chain_probe2 stages its two tails): each block copies the window's
// keys once and indexes its live nodes, so a query its segment does not
// settle costs a few shared-memory loads, where the first design staged
// the window in every block of 256 threads and scanned it serially, up to
// its last live node, for each such query.  The grid is at most one block of 1024 threads an SM
// (dhash_set_grid), so the set is built once an SM, and the queries come as
// runs of 32 dealt round-robin to the blocks (dhash_set_first), so that
// the keys of one flooded bucket, whose segment scans are long, spread over
// every SM.  Right after a compaction the tail is empty.
//
// Outputs: found, val (0 on a miss), loc (the hit's node index, or -1), so
// that a delete is this kernel plus one scatter.
#include "dhash_common.cuh"

__global__ void __launch_bounds__(DHASH_SET_THREADS) chain_probe_kernel(
    DhashArena a, const int* __restrict__ su, const int* __restrict__ dirty,
    const int* __restrict__ bq, const int* __restrict__ qk, int Q,
    int max_chain, int wsize, uint8_t* __restrict__ found,
    int* __restrict__ val, int* __restrict__ loc) {
  const DhashSetTail t = dhash_tail_set_fill(a, *su, *dirty, wsize, 0);
  __syncthreads();
  dhash_set_index(t.set);
  __syncthreads();

  for (int i = dhash_set_first(); i < Q; i += dhash_set_stride()) {
    const int key = qk[i], b = bq[i];
    int v = 0, l = -1;
    bool complete;
    bool f = dhash_chain_fast(a, t, b, key, max_chain, &v, &l, &complete);
    if (!f && !complete) f = dhash_chain_walk(a, b, key, max_chain, &v, &l);
    found[i] = f ? 1 : 0;
    val[i] = v;
    loc[i] = l;
  }
}

extern "C" int dhash_chain_probe(
    const int* ak, const int* av, const int* as, const int* an,
    const int* heads, int N, const int* bstart, const int* blen,
    const int* su, const int* dirty, const int* bq, const int* qk, int Q,
    int max_chain, int wsize, uint8_t* found, int* val, int* loc,
    void* stream) {
  if (wsize < 1 || wsize > DHASH_MAX_DIRTY || wsize > N)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = dhash_set_grid(Q, &blocks);
  if (e != cudaSuccess) return (int)e;
  DhashArena a = {ak, av, as, an, heads, bstart, blen, N,
                  dhash_arena_vec(ak, as, N)};
  chain_probe_kernel<<<blocks, DHASH_SET_THREADS, dhash_set_words(wsize) * 4,
                       (cudaStream_t)stream>>>(a, su, dirty, bq, qk, Q,
                                               max_chain, wsize, found, val,
                                               loc);
  return (int)cudaGetLastError();
}

// chain_probe2: the chain rebuild-epoch ordered check in one pass, one
// thread a query.
//
// Replaces the TPU kernel _chain_probe2_kernel (src/repro/kernels/probe.py)
// AND what its wrappers did around it (_chain_probe2_run and the gated
// fallbacks of chain_ordered_lookup / chain_ordered_delete in
// src/repro/kernels/ops.py): the old arena's sorted segment and dirty tail,
// the hazard buffer, the new arena's segment and tail, with the priority
// old > hazard > new (the paper's Lemma 4.1).  A
// query is settled by the fast path when the old arena holds it, or when the
// old arena proves its absence (segment scanned, tail covered) and the
// hazard buffer holds it or the new arena holds it or proves its absence.
// Any other query takes the reference's fallback, in its order: the bounded
// walk of the old arena, the hazard buffer, the bounded walk of the new
// arena.  The TPU version sorted the queries, kept windows of both padded
// arenas resident through a two-level tile map, merged partial results over
// a second grid axis and left the windows, the tails and the fallback to its
// wrapper; here every query is resolved in the kernel, one result a query.
//
// Bound: bytes -- a key and two buckets a query, a segment of a few nodes
// in each arena, the hazard buffer once, six outputs.  The hazard buffer
// and both arenas' dirty-tail windows are staged sets (dhash_set_* in
// dhash_common.cuh): each block copies their keys into shared memory once
// and builds a hashed index over their live entries, so each of the three
// lookups of a query is a few shared-memory loads (the lowest live index,
// as the dense compare's argmax gives it), where the first design compared
// the query serially with every live hazard entry and every live tail node
// (150 M hazard compares for 65536 queries on chip_smoke.py's phase-2
// input).  A hit reads its value from the arena or the hazard buffer in
// device memory.  The three sets are filled, then indexed, with two
// barriers in all: 36 + 2 x 4.5 KiB = 45 KiB of shared memory at
// chunk = 4096 and windows of 512 nodes, no opt-in; the grid is at most one
// block of 1024 threads an SM (dhash_set_grid), so the sets are built once
// an SM, and the queries come as runs of 32 dealt round-robin to the blocks
// (dhash_set_first), so that the keys of one flooded bucket, whose segment
// scans are long, spread over every SM.  A query the old arena resolved
// skips the hazard set and the new arena.  Contract: chunk <= 4096 and dirty window <= 512, refused above.
//
// Outputs, with the meaning of probe2's: found, val, f_old, loc_old (node of
// the old arena), hz_idx (only where the old arena did not resolve the
// query), loc_new (node of the new arena, only where neither the old arena
// nor the hazard buffer resolved it); -1 = none.
#include "dhash_common.cuh"

__global__ void __launch_bounds__(DHASH_SET_THREADS) chain_probe2_kernel(
    DhashArena o, const int* __restrict__ o_su,
    const int* __restrict__ o_dirty, DhashArena n,
    const int* __restrict__ n_su, const int* __restrict__ n_dirty,
    const int* __restrict__ hk, const int* __restrict__ hv,
    const uint8_t* __restrict__ hl, int chunk, const int* __restrict__ bqo,
    const int* __restrict__ bqn, const int* __restrict__ qk, int Q,
    int max_chain, int wsize_o, int wsize_n, uint8_t* __restrict__ found,
    int* __restrict__ val, uint8_t* __restrict__ f_old,
    int* __restrict__ loc_old, int* __restrict__ hz_idx,
    int* __restrict__ loc_new) {
  const DhashSet hz_set = dhash_set_at(0, chunk);
  const int off_old = dhash_set_words(chunk);
  const int off_new = off_old + dhash_set_words(wsize_o);
  dhash_set_fill(hz_set, [&](int j, int* k) {
    *k = hk[j];
    return hl[j] != 0;
  });
  const DhashSetTail to = dhash_tail_set_fill(o, *o_su, *o_dirty, wsize_o,
                                              off_old);
  const DhashSetTail tn = dhash_tail_set_fill(n, *n_su, *n_dirty, wsize_n,
                                              off_new);
  __syncthreads();
  dhash_set_index(hz_set);
  dhash_set_index(to.set);
  dhash_set_index(tn.set);
  __syncthreads();

  for (int i = dhash_set_first(); i < Q; i += dhash_set_stride()) {
    const int key = qk[i], bo = bqo[i], bn = bqn[i];
    int vo = 0, lo = -1, vh = 0, hz = -1, vn = 0, ln = -1;
    bool co, cn = false;
    bool fo = dhash_chain_fast(o, to, bo, key, max_chain, &vo, &lo, &co);
    bool fn = false;
    if (!fo) {
      hz = dhash_set_find(hz_set, key);
      if (hz >= 0) vh = hv[hz];
      if (co && hz < 0)
        fn = dhash_chain_fast(n, tn, bn, key, max_chain, &vn, &ln, &cn);
      if (!(co && (hz >= 0 || fn || cn))) {
        // not settled: the reference's fallback, old walk -> hazard -> new
        // walk
        fo = dhash_chain_walk(o, bo, key, max_chain, &vo, &lo);
        vn = 0;
        ln = -1;
        fn = !fo && hz < 0 &&
             dhash_chain_walk(n, bn, key, max_chain, &vn, &ln);
      }
    }
    if (fo) hz = -1;
    if (fo || hz >= 0) ln = -1;
    found[i] = (fo || hz >= 0 || fn) ? 1 : 0;
    val[i] = fo ? vo : (hz >= 0 ? vh : (fn ? vn : 0));
    f_old[i] = fo ? 1 : 0;
    loc_old[i] = lo;
    hz_idx[i] = hz;
    loc_new[i] = ln;
  }
}

extern "C" int dhash_chain_probe2(
    const int* oak, const int* oav, const int* oas, const int* onext,
    const int* oheads, int No, const int* obstart, const int* oblen,
    const int* osu, const int* odirty, const int* nak, const int* nav,
    const int* nas, const int* nnext, const int* nheads, int Nn,
    const int* nbstart, const int* nblen, const int* nsu, const int* ndirty,
    const int* hk, const int* hv, const uint8_t* hl, int chunk,
    const int* bqo, const int* bqn, const int* qk, int Q, int max_chain,
    int wsize_o, int wsize_n, uint8_t* found, int* val, uint8_t* f_old,
    int* loc_old, int* hz_idx, int* loc_new, void* stream) {
  if (chunk < 0 || chunk > DHASH_MAX_CHUNK || wsize_o < 1 ||
      wsize_o > DHASH_MAX_DIRTY || wsize_o > No || wsize_n < 1 ||
      wsize_n > DHASH_MAX_DIRTY || wsize_n > Nn)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = dhash_set_grid(Q, &blocks);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = ((size_t)dhash_set_words(chunk) +
                        dhash_set_words(wsize_o) + dhash_set_words(wsize_n)) *
                       4;
  DhashArena o = {oak, oav, oas, onext, oheads, obstart, oblen, No,
                  dhash_arena_vec(oak, oas, No)};
  DhashArena n = {nak, nav, nas, nnext, nheads, nbstart, nblen, Nn,
                  dhash_arena_vec(nak, nas, Nn)};
  chain_probe2_kernel<<<blocks, DHASH_SET_THREADS, bytes,
                        (cudaStream_t)stream>>>(
      o, osu, odirty, n, nsu, ndirty, hk, hv, hl, chunk, bqo, bqn, qk, Q,
      max_chain, wsize_o, wsize_n, found, val, f_old, loc_old, hz_idx,
      loc_new);
  return (int)cudaGetLastError();
}

// chain_probe2: the chain rebuild-epoch ordered check in one pass, one
// thread a query.
//
// Replaces the TPU kernel _chain_probe2_kernel (src/repro/kernels/probe.py)
// AND what its wrappers did around it (_chain_probe2_run and the gated
// fallbacks of chain_ordered_lookup / chain_ordered_delete in
// src/repro/kernels/ops.py): the old arena's sorted segment and dirty tail,
// the dense compare against the hazard buffer, the new arena's segment and
// tail, with the priority old > hazard > new (the paper's Lemma 4.1).  A
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
// Bound: operations, as for probe2: the hazard check compares a query with
// every live hazard entry, up to Q x chunk compares, against a few nodes of
// two arenas.  The hazard stage is probe2's (dhash_hazard_stage /
// dhash_hazard_find), and both arenas' dirty tails are staged the same way
// (dhash_tail_stage, at most 512 nodes each): 36 + 2 x 4.5 KiB of shared
// memory at chunk = 4096, inside the 48 KiB a block gets without opting in.
// A query the old arena resolved skips the hazard scan and the new arena.
// Contract: chunk <= 4096 and dirty window <= 512, refused above.
//
// Outputs, with the meaning of probe2's: found, val, f_old, loc_old (node of
// the old arena), hz_idx (only where the old arena did not resolve the
// query), loc_new (node of the new arena, only where neither the old arena
// nor the hazard buffer resolved it); -1 = none.
#include "dhash_common.cuh"

__global__ void chain_probe2_kernel(
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
  extern __shared__ int smem[];
  __shared__ int hz_end, old_end, new_end;   // 1 + last live index of each
  const int n_hz = dhash_hazard_stage(hk, hv, hl, chunk, smem, &hz_end);
  int* s_old = smem + dhash_stage_words(chunk);
  int* s_new = s_old + dhash_stage_words(wsize_o);
  const DhashTail to = dhash_tail_stage(o, *o_su, *o_dirty, wsize_o, s_old,
                                        &old_end);
  const DhashTail tn = dhash_tail_stage(n, *n_su, *n_dirty, wsize_n, s_new,
                                        &new_end);

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int key = qk[i], bo = bqo[i], bn = bqn[i];
  int vo = 0, lo = -1, vh = 0, hz = -1, vn = 0, ln = -1;
  bool co, cn = false;
  bool fo = dhash_chain_fast(o, to, bo, key, max_chain, &vo, &lo, &co);
  bool fn = false;
  if (!fo) {
    hz = dhash_hazard_find(smem, chunk, n_hz, key, &vh);
    if (co && hz < 0)
      fn = dhash_chain_fast(n, tn, bn, key, max_chain, &vn, &ln, &cn);
    if (!(co && (hz >= 0 || fn || cn))) {
      // not settled: the reference's fallback, old walk -> hazard -> new walk
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
  if (chunk > DHASH_MAX_CHUNK || wsize_o < 1 || wsize_o > DHASH_MAX_DIRTY ||
      wsize_o > No || wsize_n < 1 || wsize_n > DHASH_MAX_DIRTY || wsize_n > Nn)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (Q + threads - 1) / threads;
  size_t bytes = ((size_t)dhash_stage_words(chunk) +
                  dhash_stage_words(wsize_o) + dhash_stage_words(wsize_n)) * 4;
  DhashArena o = {oak, oav, oas, onext, oheads, obstart, oblen, No};
  DhashArena n = {nak, nav, nas, nnext, nheads, nbstart, nblen, Nn};
  chain_probe2_kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(
      o, osu, odirty, n, nsu, ndirty, hk, hv, hl, chunk, bqo, bqn, qk, Q,
      max_chain, wsize_o, wsize_n, found, val, f_old, loc_old, hz_idx,
      loc_new);
  return (int)cudaGetLastError();
}

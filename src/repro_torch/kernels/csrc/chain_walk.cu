// chain_walk and chain_tail: the bounded pointer walks of the plain chain
// ops, one thread a query (a bucket).
//
// Replace no Pallas kernel: the reference computes both as XLA loops.
//
// * chain_walk is buckets.chain_lookup (src/repro/core/buckets.py): the
//   lock-step walk from heads[b] along next, at most max_chain nodes, that
//   ends once no walk is left.  A thread walks its own query from the head
//   of the bucket the caller gives (hashed for HT-Xu and HT-RHT, key &
//   (nactive - 1) for HT-Split) to the first LIVE node holding its key.
//   The plain chain ops that the paper's comparison tables share (lookup,
//   the presence walk of insert, delete) run it on the card, so that every
//   contender pays the same hop.  Outputs: found, val (0 on a miss), loc
//   (the hit's node index, or -1).
// * chain_tail is the tail walk of baselines.rht_rebuild_chunk
//   (src/repro/core/baselines.py): for each of the bchunk buckets from the
//   cursor on (wrapping at the bucket count), the last node its walk
//   reaches within max_chain hops and the node before it (-1 where none).
//   The cursor is read on the device.
//
// Bound: latency.  A hop is one load that depends on the one before it
// (state and next of a node in one 32-byte sector, the key beside them);
// the arenas the comparison drives (2^21 nodes of four words) stay in the
// 50 MB L2, so a hop costs an L2 round trip and a warp waits for its
// longest walk.  A simple kernel: no warp-cooperative walk, no prefetch.
#include "dhash_common.cuh"

#define CHAIN_WALK_THREADS 256

__global__ void __launch_bounds__(CHAIN_WALK_THREADS) chain_walk_kernel(
    DhashArena a, const int* __restrict__ bq, const int* __restrict__ qk,
    int Q, int max_chain, uint8_t* __restrict__ found, int* __restrict__ val,
    int* __restrict__ loc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  int v = 0, l = -1;
  const bool f = dhash_chain_walk(a, bq[i], qk[i], max_chain, &v, &l);
  found[i] = f ? 1 : 0;
  val[i] = v;
  loc[i] = l;
}

__global__ void __launch_bounds__(CHAIN_WALK_THREADS) chain_tail_kernel(
    const int* __restrict__ heads, int nb, const int* __restrict__ next,
    const int* __restrict__ cursor, int bchunk, int max_chain,
    int* __restrict__ tail, int* __restrict__ prev) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bchunk) return;
  const int b = (int)(((long long)*cursor + i) % nb);
  int cur = heads[b], before = -1;
  for (int p = 0; p < max_chain && cur >= 0; ++p) {
    const int nxt = next[cur];
    if (nxt < 0) break;
    before = cur;
    cur = nxt;
  }
  tail[i] = cur;
  prev[i] = before;
}

extern "C" int dhash_chain_walk(const int* ak, const int* av, const int* as,
                                const int* an, const int* heads, int N,
                                const int* bq, const int* qk, int Q,
                                int max_chain, uint8_t* found, int* val,
                                int* loc, void* stream) {
  if (Q <= 0 || max_chain < 0) return (int)cudaErrorInvalidValue;
  DhashArena a = {ak, av, as, an, heads, nullptr, nullptr, N, false};
  const int blocks = (Q + CHAIN_WALK_THREADS - 1) / CHAIN_WALK_THREADS;
  chain_walk_kernel<<<blocks, CHAIN_WALK_THREADS, 0, (cudaStream_t)stream>>>(
      a, bq, qk, Q, max_chain, found, val, loc);
  return (int)cudaGetLastError();
}

extern "C" int dhash_chain_tail(const int* heads, int nb, const int* an,
                                const int* cursor, int bchunk, int max_chain,
                                int* tail, int* prev, void* stream) {
  if (bchunk <= 0 || nb <= 0 || max_chain < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (bchunk + CHAIN_WALK_THREADS - 1) / CHAIN_WALK_THREADS;
  chain_tail_kernel<<<blocks, CHAIN_WALK_THREADS, 0, (cudaStream_t)stream>>>(
      heads, nb, an, cursor, bchunk, max_chain, tail, prev);
  return (int)cudaGetLastError();
}

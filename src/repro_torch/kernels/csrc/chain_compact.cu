// chain_compact: the chain arena's compaction, guarded on the device, in
// place.
//
// Replaces no Pallas kernel: the reference computes it as XLA code behind
// lax.cond (src/repro/core/backend.py, chain_maybe_compact: dirty tail
// longer than dirty_cap; and the freeze of the old arena at a rebuild's
// start), one stable sort of the arena keyed on (bucket, arena index) with
// dead nodes after every bucket (src/repro/kernels/ops.py,
// chain_compact_fused).  Eager PyTorch computes that sort on every call and
// selects it; this launch returns at once where its guard is off:
//
//   run = (where is null || *where) && (dirty_cap < 0 || dirty > dirty_cap)
//   dirty = arena - free_top - sorted_upto
//
// What it writes where it runs is the plain version's, word for word: the
// live nodes packed to the front in (bucket, arena index) order, every other
// node EMPTY with key, value 0 and link -1; node i linked to i + 1 within its
// bucket; per bucket its start (the live nodes of the buckets below it),
// length, and head (its start, or -1 when empty); the free stack n - 1 - i,
// free_top = n - live, sorted_upto = live.
//
// No sort of the arena.  It uses the layout the last compaction left (and
// that inserts, deletes and the extract keep): bucket b's nodes of the
// sorted prefix [0, sorted_upto) are the run [bstart[b], bstart[b] +
// blen[b]), in arena order; every node allocated since lies in the dirty
// tail [sorted_upto, arena - free_top), and b's tail nodes are the nodes of
// b's chain in front of its run (each insert links its nodes at the head).
// So a live node's place is start[b] + its rank among the live nodes of its
// run, or start[b] + the run's live count + its rank, by arena index, among
// b's live tail nodes:
//
//   1. cc_buckets, a thread a bucket: the guard (written once for the
//      launches after), each live run node's rank, then a walk of the
//      chain's tail part; up to CC_SMALL live tail nodes (within CC_WALK
//      nodes) are sorted by arena index in the thread and ranked; a bucket
//      with more is listed for step 2;
//   2. cc_tail, one block: each listed bucket's live tail nodes found by
//      one ordered pass over the tail (hashing each key) and ranked; then
//      one exclusive scan of the bucket totals (starts, and the live count);
//   3. cc_gather, a thread a node: each live node copied to its place in a
//      scratch arena (key, value, bucket);
//   4. cc_write, a thread a node and a bucket: the scratch copied back, the
//      links, the free stack, the bucket offsets and the two scalars.
//
// Bound: bytes, about 13 words a node when it runs (step 1 reads a state
// word; step 3 reads key, value and state and writes three scratch words;
// step 4 reads three and writes five): ~52 MiB for an arena of 2^20, ~16 us
// at 3.35 TB/s; otherwise launch latency.  A flooded bucket costs one pass
// of the block over the tail (step 2), and its run is one thread's serial
// loop (step 1).
#include "dhash_common.cuh"

#define CC_THREADS 256
#define CC_TAIL_THREADS 1024
#define CC_SMALL 16       // live tail nodes a bucket's thread ranks itself
#define CC_WALK 64        // tail nodes, live or dead, it walks at most

// Exclusive sum over the block; *total gets the block's sum.  `warp_tot`
// is 32 words of shared scratch.  Every thread of the block must call it.
__device__ __forceinline__ int cc_block_exclusive_sum(int v, int* warp_tot,
                                                      int* total) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? warp_tot[lane] : 0;
    int wi = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += u;
    }
    if (lane < nwarps) warp_tot[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  return warp_tot[warp] + incl - v;
}

__global__ void __launch_bounds__(CC_THREADS) cc_buckets(
    const int* __restrict__ astate, const int* __restrict__ anext,
    const int* __restrict__ heads, const int* __restrict__ bstart,
    const int* __restrict__ blen, const int* free_top,
    const int* sorted_upto, int n, int nb, const uint8_t* where,
    int dirty_cap, int* __restrict__ go, int* __restrict__ big,
    int* __restrict__ nbig, int* __restrict__ tot, int* __restrict__ srank,
    int* __restrict__ trank) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int su = *sorted_upto;
  const int dirty = n - *free_top - su;
  const bool run = (where == nullptr || *where) &&
                   (dirty_cap < 0 || dirty > dirty_cap);
  if (b == 0) go[0] = run ? 1 : 0;
  if (!run || b >= nb) return;
  const int s = bstart[b], e = s + blen[b];
  int c = 0;
  for (int i = s; i < e; ++i)
    if (astate[i] == DHASH_LIVE) srank[i] = c++;
  // the chain's tail part: newest batch first, each batch in arena order
  int mine[CC_SMALL];
  int m = 0, hops = 0;
  bool over = false;
  for (int v = heads[b]; v >= su; v = anext[v]) {
    if (++hops > CC_WALK) {
      over = true;
      break;
    }
    if (astate[v] != DHASH_LIVE) continue;
    if (m == CC_SMALL) {
      over = true;
      break;
    }
    mine[m++] = v;
  }
  tot[b] = c;
  if (over) {                      // step 2 ranks this bucket's tail
    big[atomicAdd(nbig, 1)] = b;
    return;
  }
  for (int x = 1; x < m; ++x) {    // by arena index
    const int v = mine[x];
    int y = x - 1;
    while (y >= 0 && mine[y] > v) {
      mine[y + 1] = mine[y];
      --y;
    }
    mine[y + 1] = v;
  }
  for (int r = 0; r < m; ++r) trank[mine[r] - su] = c + r;
  tot[b] = c + m;
}

__global__ void __launch_bounds__(CC_TAIL_THREADS) cc_tail(
    const int* __restrict__ akey, const int* __restrict__ astate,
    const int* free_top, const int* sorted_upto, int n, int nb, int kind,
    const long long* __restrict__ seeds, const int* __restrict__ go,
    const int* __restrict__ big, const int* __restrict__ nbig, int* tot,
    int* __restrict__ trank, int* __restrict__ list,
    int* __restrict__ start, int* __restrict__ total) {
  __shared__ int warp_tot[32];
  __shared__ int n_sh[2];
  if (!go[0]) return;
  const int t = threadIdx.x;
  const int su = *sorted_upto, tail = n - *free_top - su;
  const int listed = *nbig;
  for (int k = 0; k < listed; ++k) {
    const int b = big[k];
    if (t == 0) n_sh[0] = 0;
    __syncthreads();
    dhash_block_compact(
        tail,
        [&](int j) {
          return astate[su + j] == DHASH_LIVE &&
                 dhash_bucket_of(kind, seeds, akey[su + j], nb) == b;
        },
        list, warp_tot, n_sh);
    const int m = n_sh[0], c = tot[b];
    for (int r = t; r < m; r += blockDim.x) trank[list[r]] = c + r;
    __syncthreads();
    if (t == 0) tot[b] = c + m;
    __syncthreads();
  }
  // the exclusive scan of the bucket totals, a contiguous share a thread
  const int per = (nb + CC_TAIL_THREADS - 1) / CC_TAIL_THREADS;
  const int lo = min(nb, t * per), hi = min(nb, lo + per);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += tot[b];
  int before = cc_block_exclusive_sum(sum, warp_tot, &n_sh[1]);
  for (int b = lo; b < hi; ++b) {
    start[b] = before;
    before += tot[b];
  }
  if (t == 0) total[0] = n_sh[1];
}

__global__ void __launch_bounds__(CC_THREADS) cc_gather(
    const int* __restrict__ akey, const int* __restrict__ aval,
    const int* __restrict__ astate, const int* free_top,
    const int* sorted_upto, int n, int nb, int kind,
    const long long* __restrict__ seeds, const int* __restrict__ go,
    const int* __restrict__ srank, const int* __restrict__ trank,
    const int* __restrict__ start, int* __restrict__ out_key,
    int* __restrict__ out_val, int* __restrict__ out_b) {
  if (!go[0]) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int su = *sorted_upto;
  if (i >= n - *free_top || astate[i] != DHASH_LIVE) return;
  const int key = akey[i];
  const int b = dhash_bucket_of(kind, seeds, key, nb);
  const int dst = start[b] + (i < su ? srank[i] : trank[i - su]);
  out_key[dst] = key;
  out_val[dst] = aval[i];
  out_b[dst] = b;
}

__global__ void __launch_bounds__(CC_THREADS) cc_write(
    int* __restrict__ akey, int* __restrict__ aval, int* __restrict__ astate,
    int* __restrict__ anext, int* __restrict__ heads,
    int* __restrict__ free_stack, int* free_top, int* __restrict__ bstart,
    int* __restrict__ blen, int* sorted_upto, int n, int nb,
    const int* __restrict__ go, const int* __restrict__ tot,
    const int* __restrict__ start, const int* __restrict__ total,
    const int* __restrict__ out_key,
    const int* __restrict__ out_val, const int* __restrict__ out_b) {
  if (!go[0]) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int live = total[0];
  if (i < n) {
    const bool on = i < live;
    akey[i] = on ? out_key[i] : 0;
    aval[i] = on ? out_val[i] : 0;
    astate[i] = on ? DHASH_LIVE : DHASH_EMPTY;
    anext[i] = (on && i + 1 < live && out_b[i + 1] == out_b[i]) ? i + 1 : -1;
    free_stack[i] = n - 1 - i;
  }
  if (i < nb) {
    const int c = tot[i];
    bstart[i] = start[i];
    blen[i] = c;
    heads[i] = c > 0 ? start[i] : -1;
  }
  if (i == 0) {
    *free_top = n - live;
    *sorted_upto = live;
  }
}

// scratch: 3 + 3 * nb + 5 * n int32 words (go, total, the listed count;
// tot, start, the list of buckets; srank, trank, out_key (also step 2's
// list of tail positions), out_val, out_b), no initial contents needed
extern "C" int dhash_chain_compact(
    int* akey, int* aval, int* astate, int* anext, int* heads,
    int* free_stack, int* free_top, int* bstart, int* blen, int* sorted_upto,
    int n, int nb, int kind, const long long* seeds, const uint8_t* where,
    int dirty_cap, int* scratch, void* stream) {
  if (n < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* go = scratch;
  int* total = scratch + 1;
  int* nbig = scratch + 2;
  int* tot = scratch + 3;
  int* start = tot + nb;
  int* big = start + nb;
  int* srank = big + nb;
  int* trank = srank + n;
  int* out_key = trank + n;
  int* out_val = out_key + n;
  int* out_b = out_val + n;
  cudaError_t e = cudaMemsetAsync(nbig, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  cc_buckets<<<(nb + CC_THREADS - 1) / CC_THREADS, CC_THREADS, 0, s>>>(
      astate, anext, heads, bstart, blen, free_top, sorted_upto, n, nb, where,
      dirty_cap, go, big, nbig, tot, srank, trank);
  cc_tail<<<1, CC_TAIL_THREADS, 0, s>>>(akey, astate, free_top, sorted_upto,
                                        n, nb, kind, seeds, go, big, nbig,
                                        tot, trank, out_key, start, total);
  cc_gather<<<(n + CC_THREADS - 1) / CC_THREADS, CC_THREADS, 0, s>>>(
      akey, aval, astate, free_top, sorted_upto, n, nb, kind, seeds, go,
      srank, trank, start, out_key, out_val, out_b);
  const int most = n > nb ? n : nb;
  cc_write<<<(most + CC_THREADS - 1) / CC_THREADS, CC_THREADS, 0, s>>>(
      akey, aval, astate, anext, heads, free_stack, free_top, bstart, blen,
      sorted_upto, n, nb, go, tot, start, total, out_key, out_val, out_b);
  return (int)cudaGetLastError();
}

// chain_compact: the chain arena's compaction, guarded on the device, in
// place.
//
// Replaces no Pallas kernel: the reference computes it as XLA code behind
// lax.cond (src/repro/core/backend.py, chain_maybe_compact: dirty tail
// longer than dirty_cap; and the freeze of the old arena at a rebuild's
// start), one stable sort of the arena keyed on (bucket, arena index) with
// dead nodes after every bucket (src/repro/kernels/ops.py,
// chain_compact_fused).  Eager PyTorch computes that sort on every call and
// selects it; these launches return at once where the guard is off:
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
// b's live tail nodes.  The buckets are cut into tiles of CC_THREADS:
//
//   1. cc_scan, a block a tile, a thread a bucket: the guard (written once
//      for the launches after), each live run node's rank, then a walk of
//      the chain's tail part; up to CC_SMALL live tail nodes (within CC_WALK
//      nodes) are sorted by arena index in the thread and ranked.  A bucket
//      with more is listed in its tile's block, which ranks its live tail
//      nodes by one ordered pass over the tail (hashing each key) once the
//      threads are done, so a flood of several buckets in several tiles
//      runs on several SMs.  Then the block's exclusive scan of its bucket
//      totals (each bucket's start within the tile) and the tile's sum;
//   2. cc_gather, a thread a node (grid-stride): the first block to arrive
//      (a ticket from a counter cc_scan zeroed) scans the tile sums into
//      each tile's start and the live count and raises a flag, which the
//      other blocks wait for; then each live node is copied to its place in
//      a scratch arena (key, value, bucket);
//   3. cc_write, a thread a node and a bucket (grid-stride): the scratch
//      copied back, the links, the free stack, the bucket offsets and the
//      two scalars.
//
// Nothing carries over between calls: the counter and the flag live in the
// call's scratch and are zeroed by cc_scan, an earlier launch of the same
// call, so the call needs no memset and stays capturable in a CUDA graph;
// a launch whose guard is off reads the guard (cc_scan) or the word cc_scan
// wrote (cc_gather, cc_write) and returns.  No block waits on a block that
// has not started: the scanning block is the first to take a ticket.
//
// Bound: bytes, about 13 words a node when it runs (step 1 reads a state
// word and writes a rank; step 2 reads key, value, state and rank and
// writes three scratch words; step 3 reads three and writes five): ~52 MiB
// for an arena of 2^20, ~16 us at 3.35 TB/s; otherwise launch latency.  A
// listed bucket costs its tile's block one pass over the tail; a bucket's
// run is one thread's serial loop (step 1).
#include "dhash_common.cuh"

#define CC_THREADS 256    // threads of every block, and buckets of a tile
#define CC_SMALL 16       // live tail nodes a bucket's thread ranks itself
#define CC_WALK 64        // tail nodes, live or dead, it walks at most

// the control words at the head of the scratch
#define CC_GO 0           // the guard, written by cc_scan's first thread
#define CC_TICKET 1       // cc_gather's block counter
#define CC_READY 2        // set once the tile starts are written
#define CC_LIVE 3         // the live count

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

__global__ void __launch_bounds__(CC_THREADS) cc_scan(
    const int* __restrict__ akey, const int* __restrict__ astate,
    const int* __restrict__ anext, const int* __restrict__ heads,
    const int* __restrict__ bstart, const int* __restrict__ blen,
    const int* free_top, const int* sorted_upto, int n, int nb, int kind,
    const long long* __restrict__ seeds, const uint8_t* where,
    int dirty_cap, int* __restrict__ ctl, int* __restrict__ tsum,
    int* __restrict__ tot, int* __restrict__ lstart,
    int* __restrict__ rank) {
  __shared__ int warp_tot[32];
  __shared__ int n_sh[2];
  __shared__ int tot_sh[CC_THREADS];
  __shared__ int listed[CC_THREADS];
  __shared__ int n_listed;
  const int t = threadIdx.x, b = blockIdx.x * CC_THREADS + t;
  const int su = *sorted_upto, end = n - *free_top, dirty = end - su;
  const bool run = (where == nullptr || *where) &&
                   (dirty_cap < 0 || dirty > dirty_cap);
  if (blockIdx.x == 0 && t == 0) {
    ctl[CC_GO] = run ? 1 : 0;
    ctl[CC_TICKET] = 0;
    ctl[CC_READY] = 0;
  }
  if (!run) return;
  if (t == 0) n_listed = 0;
  __syncthreads();
  int c = 0;
  if (b < nb) {
    const int s = bstart[b], e = s + blen[b];
    for (int i = s; i < e; ++i)
      if (astate[i] == DHASH_LIVE) rank[i] = c++;
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
    if (over) {                    // the block ranks this bucket's tail
      listed[atomicAdd(&n_listed, 1)] = t;
    } else {
      for (int x = 1; x < m; ++x) {    // by arena index
        const int v = mine[x];
        int y = x - 1;
        while (y >= 0 && mine[y] > v) {
          mine[y + 1] = mine[y];
          --y;
        }
        mine[y + 1] = v;
      }
      for (int r = 0; r < m; ++r) rank[mine[r]] = c + r;
      c += m;
    }
  }
  tot_sh[t] = c;
  __syncthreads();
  const int nl = n_listed;
  for (int k = 0; k < nl; ++k) {
    const int lt = listed[k], lb = blockIdx.x * CC_THREADS + lt;
    const int c0 = tot_sh[lt];
    if (t == 0) n_sh[0] = 0;
    __syncthreads();
    dhash_block_rank(
        dirty,
        [&](int j) {
          return astate[su + j] == DHASH_LIVE &&
                 dhash_bucket_of(kind, seeds, akey[su + j], nb) == lb;
        },
        [&](int j, int r) { rank[su + j] = c0 + r; }, warp_tot, n_sh);
    if (t == 0) tot_sh[lt] = c0 + n_sh[0];
    __syncthreads();
  }
  c = tot_sh[t];
  const int before = cc_block_exclusive_sum(c, warp_tot, &n_sh[1]);
  if (b < nb) {
    tot[b] = c;
    lstart[b] = before;
  }
  if (t == 0) tsum[blockIdx.x] = n_sh[1];
}

__global__ void __launch_bounds__(CC_THREADS) cc_gather(
    const int* __restrict__ akey, const int* __restrict__ aval,
    const int* __restrict__ astate, const int* free_top, int n, int nb,
    int kind, const long long* __restrict__ seeds, int* ctl,
    const int* __restrict__ tsum, int* tpre,
    const int* __restrict__ lstart, const int* __restrict__ rank,
    int* __restrict__ out_key, int* __restrict__ out_val,
    int* __restrict__ out_b) {
  __shared__ int warp_tot[32];
  __shared__ int sh[2];
  if (!ctl[CC_GO]) return;
  const int t = threadIdx.x;
  if (t == 0) sh[0] = atomicAdd(&ctl[CC_TICKET], 1);
  __syncthreads();
  if (sh[0] == 0) {      // the first block: each tile's start, the live count
    const int ntiles = (nb + CC_THREADS - 1) / CC_THREADS;
    int carry = 0;
    for (int base = 0; base < ntiles; base += CC_THREADS) {
      const int j = base + t;
      const int v = j < ntiles ? tsum[j] : 0;
      const int e = cc_block_exclusive_sum(v, warp_tot, &sh[1]);
      if (j < ntiles) tpre[j] = carry + e;
      carry += sh[1];
      __syncthreads();
    }
    __threadfence();
    __syncthreads();
    if (t == 0) {
      ctl[CC_LIVE] = carry;
      __threadfence();
      atomicExch(&ctl[CC_READY], 1);
    }
  } else if (t == 0) {
    while (atomicAdd(&ctl[CC_READY], 0) == 0) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  const int end = n - *free_top;
  for (int i = blockIdx.x * CC_THREADS + t; i < end;
       i += gridDim.x * CC_THREADS) {
    if (astate[i] != DHASH_LIVE) continue;
    const int key = akey[i];
    const int b = dhash_bucket_of(kind, seeds, key, nb);
    // tpre was written by another block of this launch: read it from L2
    const int dst = __ldcg(tpre + b / CC_THREADS) + lstart[b] + rank[i];
    out_key[dst] = key;
    out_val[dst] = aval[i];
    out_b[dst] = b;
  }
}

__global__ void __launch_bounds__(CC_THREADS) cc_write(
    int* __restrict__ akey, int* __restrict__ aval, int* __restrict__ astate,
    int* __restrict__ anext, int* __restrict__ heads,
    int* __restrict__ free_stack, int* free_top, int* __restrict__ bstart,
    int* __restrict__ blen, int* sorted_upto, int n, int nb,
    const int* __restrict__ ctl, const int* __restrict__ tpre,
    const int* __restrict__ tot, const int* __restrict__ lstart,
    const int* __restrict__ out_key, const int* __restrict__ out_val,
    const int* __restrict__ out_b) {
  if (!ctl[CC_GO]) return;
  const int live = ctl[CC_LIVE];
  const int most = n > nb ? n : nb;
  for (int i = blockIdx.x * CC_THREADS + threadIdx.x; i < most;
       i += gridDim.x * CC_THREADS) {
    if (i < n) {
      const bool on = i < live;
      akey[i] = on ? out_key[i] : 0;
      aval[i] = on ? out_val[i] : 0;
      astate[i] = on ? DHASH_LIVE : DHASH_EMPTY;
      anext[i] =
          (on && i + 1 < live && out_b[i + 1] == out_b[i]) ? i + 1 : -1;
      free_stack[i] = n - 1 - i;
    }
    if (i < nb) {
      const int c = tot[i], s = tpre[i / CC_THREADS] + lstart[i];
      bstart[i] = s;
      blen[i] = c;
      heads[i] = c > 0 ? s : -1;
    }
    if (i == 0) {
      *free_top = n - live;
      *sorted_upto = live;
    }
  }
}

// scratch: 4 + 2 * ((nb + 255) / 256) + 2 * nb + 4 * n int32 words, no
// initial contents needed: the control words (CC_GO ... CC_LIVE); per tile
// its sum and its start; per bucket its total and its start within its
// tile; per node its rank (in its run, or among its bucket's tail nodes);
// the scratch arena out_key, out_val, out_b.
extern "C" int dhash_chain_compact(
    int* akey, int* aval, int* astate, int* anext, int* heads,
    int* free_stack, int* free_top, int* bstart, int* blen, int* sorted_upto,
    int n, int nb, int kind, const long long* seeds, const uint8_t* where,
    int dirty_cap, int* scratch, void* stream) {
  if (n < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  static_assert(CC_THREADS == 256, "the scratch layout counts 256-bucket "
                                   "tiles");
  cudaStream_t s = (cudaStream_t)stream;
  int sms = 0;
  const cudaError_t e = dhash_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (nb + CC_THREADS - 1) / CC_THREADS;
  int* ctl = scratch;
  int* tsum = ctl + 4;
  int* tpre = tsum + ntiles;
  int* tot = tpre + ntiles;
  int* lstart = tot + nb;
  int* rank = lstart + nb;
  int* out_key = rank + n;
  int* out_val = out_key + n;
  int* out_b = out_val + n;
  // the node kernels: grid-stride, at most a full SM's worth of blocks an SM
  const int most = n > nb ? n : nb;
  const int cap = sms * (2048 / CC_THREADS);
  const int gn = (n + CC_THREADS - 1) / CC_THREADS;
  const int gm = (most + CC_THREADS - 1) / CC_THREADS;
  cc_scan<<<ntiles, CC_THREADS, 0, s>>>(
      akey, astate, anext, heads, bstart, blen, free_top, sorted_upto, n, nb,
      kind, seeds, where, dirty_cap, ctl, tsum, tot, lstart, rank);
  cc_gather<<<gn < cap ? gn : cap, CC_THREADS, 0, s>>>(
      akey, aval, astate, free_top, n, nb, kind, seeds, ctl, tsum, tpre,
      lstart, rank, out_key, out_val, out_b);
  cc_write<<<gm < cap ? gm : cap, CC_THREADS, 0, s>>>(
      akey, aval, astate, anext, heads, free_stack, free_top, bstart, blen,
      sorted_upto, n, nb, ctl, tpre, tot, lstart, out_key, out_val, out_b);
  return (int)cudaGetLastError();
}

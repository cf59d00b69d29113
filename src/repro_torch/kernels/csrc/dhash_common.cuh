// Shared definitions for the DHash kernels (Hopper, sm_90a).
//
// Linear tables are three int32 arrays of C slots (key, val, state); bool
// tensors arrive as one byte per element.  A probe sequence is h0, h0+1, ...
// wrapped at C by the thread itself, so the kernels read the table tensors in
// place: there is no padded copy, no query sort and no tile map.
//
// Twochoice and cuckoo tables are the same three arrays laid out [rows, W]
// row-major (W <= 32 lanes); a key lives in one of its two candidate rows and
// a location is the flat slot row * W + lane.
//
// A chain table is a node arena of N nodes (key, val, state, next) with a
// head per bucket, kept bucket-sorted by a compaction: bucket b's nodes at
// [bstart[b], bstart[b] + blen[b]) below sorted_upto, and the nodes inserted
// since the last compaction in the "dirty" tail [sorted_upto, sorted_upto +
// dirty).  A location is a node index in [0, N).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define DHASH_EMPTY 0
#define DHASH_LIVE 1
#define DHASH_TOMB 2
#define DHASH_MIGRATED 3

#define DHASH_MAX_WIDTH 32
// the largest hazard buffer the probe2 kernels stage in shared memory: the
// 48 KiB a block gets without opting in, and what the extract kernel fills
#define DHASH_MAX_CHUNK 4096

// Linear-probe lookup of one key: walk at most max_probes slots from h0,
// stop at EMPTY, hit on LIVE with an equal key, skip TOMB and MIGRATED.
// loc is the physical slot of the hit in [0, C), or -1.
__device__ __forceinline__ bool dhash_probe_one(
    const int* __restrict__ tk, const int* __restrict__ tv,
    const int* __restrict__ ts, int C, int h0, int key, int max_probes,
    int* val, int* loc) {
  int pos = h0;
  for (int p = 0; p < max_probes; ++p) {
    int st = ts[pos];
    if (st == DHASH_EMPTY) break;
    if (st == DHASH_LIVE && tk[pos] == key) {
      *val = tv[pos];
      *loc = pos;
      return true;
    }
    if (++pos == C) pos = 0;
  }
  *val = 0;
  *loc = -1;
  return false;
}

// First lane of `row` that holds `key` LIVE, or -1.  With VEC (W a multiple
// of 4 and 16-byte aligned arrays) the row is read as 16-byte loads: W = 8
// is two loads of the states and two of the keys.
template <bool VEC>
__device__ __forceinline__ int dhash_row_find(const int* __restrict__ tk,
                                              const int* __restrict__ ts,
                                              long long row, int W, int key) {
  const long long base = row * W;
  if (VEC) {
    for (int l = 0; l < W; l += 4) {
      const int4 s = *reinterpret_cast<const int4*>(ts + base + l);
      const int4 k = *reinterpret_cast<const int4*>(tk + base + l);
      if (s.x == DHASH_LIVE && k.x == key) return l;
      if (s.y == DHASH_LIVE && k.y == key) return l + 1;
      if (s.z == DHASH_LIVE && k.z == key) return l + 2;
      if (s.w == DHASH_LIVE && k.w == key) return l + 3;
    }
  } else {
    for (int l = 0; l < W; ++l)
      if (ts[base + l] == DHASH_LIVE && tk[base + l] == key) return l;
  }
  return -1;
}

// Two-row lookup of one key, row a first (the reference's a-row priority).
// loc is the hit's flat slot, or -1; val is 0 on a miss.
template <bool VEC>
__device__ __forceinline__ bool dhash_two_row_lookup(
    const int* __restrict__ tk, const int* __restrict__ tv,
    const int* __restrict__ ts, int W, int ra, int rb, int key, int* val,
    int* loc) {
  long long row = ra;
  int lane = dhash_row_find<VEC>(tk, ts, row, W, key);
  if (lane < 0) {
    row = rb;
    lane = dhash_row_find<VEC>(tk, ts, row, W, key);
  }
  if (lane < 0) {
    *val = 0;
    *loc = -1;
    return false;
  }
  const long long slot = row * W + lane;
  *val = tv[slot];
  *loc = (int)slot;
  return true;
}

// A staged buffer in shared memory: n keys, n values as int32, then n live
// bytes rounded up to whole words.
__host__ __device__ inline int dhash_stage_words(int n) {
  return 2 * n + (n + 3) / 4;
}

// Shared-memory bytes of a staged hazard buffer.
static inline size_t dhash_hazard_smem_bytes(int chunk) {
  return (size_t)dhash_stage_words(chunk) * 4;
}

// Copy n entries into the staged layout at `smem`; `entry(j, &key, &val)`
// gives entry j and returns whether it is live.  Returns 1 + the index of
// the last live entry (`end` is a __shared__ int of the caller, one per
// staged buffer).  Every thread of the block must call it: it holds two
// barriers.
template <class Entry>
__device__ __forceinline__ int dhash_stage(int n, int* smem, int* end,
                                           Entry entry) {
  int* shk = smem;
  int* shv = smem + n;
  uint8_t* shl = (uint8_t*)(smem + 2 * n);
  if (threadIdx.x == 0) *end = 0;
  __syncthreads();
  int my_end = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int k, v;
    const bool l = entry(j, &k, &v);
    shk[j] = k;
    shv[j] = v;
    shl[j] = l ? 1 : 0;
    if (l) my_end = j + 1;
  }
  if (my_end) atomicMax(end, my_end);
  __syncthreads();
  return *end;
}

// The hazard stage of the probe2 kernels.  The block copies the hazard
// buffer (key, val, live: 9 bytes an entry, 36 KiB at chunk = 4096) into
// dynamic shared memory `smem` once and returns 1 + the index of the last
// live entry.
__device__ __forceinline__ int dhash_hazard_stage(
    const int* __restrict__ hk, const int* __restrict__ hv,
    const uint8_t* __restrict__ hl, int chunk, int* smem, int* hz_end) {
  return dhash_stage(chunk, smem, hz_end, [&](int j, int* k, int* v) {
    *k = hk[j];
    *v = hv[j];
    return hl[j] != 0;
  });
}

// The lowest live hazard index holding `key`, or -1, from the buffer that
// dhash_hazard_stage (or dhash_tail_stage) put into `smem`.  The scan stops at the first live
// match (as argmax over the match mask) and at the last live entry; all
// threads of a warp read the same entry at the same time, which shared
// memory serves as a broadcast.
__device__ __forceinline__ int dhash_hazard_find(const int* smem, int chunk,
                                                 int n_hz, int key,
                                                 int* val) {
  const int* shk = smem;
  const int* shv = smem + chunk;
  const uint8_t* shl = (const uint8_t*)(smem + 2 * chunk);
  for (int j = 0; j < n_hz; ++j) {
    if (shl[j] && shk[j] == key) {
      *val = shv[j];
      return j;
    }
  }
  return -1;
}

// Whether the twochoice kernels may read a row as 16-byte loads.
static inline bool dhash_rows_vec_ok(int W, const void* a, const void* b,
                                     const void* c = nullptr,
                                     const void* d = nullptr) {
  auto al = [](const void* p) { return p == nullptr || ((uintptr_t)p % 16) == 0; };
  return W % 4 == 0 && al(a) && al(b) && al(c) && al(d);
}

// ---------------------------------------------------------------------------
// chain: the arena-sorted node layout
// ---------------------------------------------------------------------------

// One arena's arrays.
struct DhashArena {
  const int* key;
  const int* val;
  const int* state;
  const int* next;    // -1 ends a chain
  const int* heads;   // [B], -1 = empty bucket
  const int* bstart;  // [B] sorted segment start
  const int* blen;    // [B] sorted segment length
  int n;
};

// The dirty-tail window of one arena, staged in shared memory: the `size`
// nodes at [base, base + size) with base = min(sorted_upto, N - size); a
// node counts if it is LIVE at or past sorted_upto.  `covered` is whether
// the window holds the whole tail, so that a miss there proves absence.
struct DhashTail {
  const int* smem;
  int size, n_live, base;
  bool covered;
};

// The largest dirty window (dirty_cap) the chain kernels stage.
#define DHASH_MAX_DIRTY 512

// Stage an arena's dirty-tail window (the reference's _chain_dirty_window);
// every thread of the block must call it.
__device__ __forceinline__ DhashTail dhash_tail_stage(
    const DhashArena& a, int sorted_upto, int dirty, int size, int* smem,
    int* end) {
  const int base = min(sorted_upto, a.n - size);
  DhashTail t;
  t.smem = smem;
  t.size = size;
  t.base = base;
  t.covered = sorted_upto + dirty <= base + size;
  t.n_live = dhash_stage(size, smem, end, [&](int j, int* k, int* v) {
    const int p = base + j;
    *k = a.key[p];
    *v = a.val[p];
    return p >= sorted_upto && a.state[p] == DHASH_LIVE;
  });
  return t;
}

// The bounded walk of the pointer-chasing reference (ref.chain_lookup_ref):
// from the bucket's head along `next`, at most max_chain nodes.
__device__ __forceinline__ bool dhash_chain_walk(const DhashArena& a, int b,
                                                 int key, int max_chain,
                                                 int* val, int* loc) {
  int cur = a.heads[b];
  for (int p = 0; p < max_chain && cur >= 0; ++p) {
    if (a.state[cur] == DHASH_LIVE && a.key[cur] == key) {
      *val = a.val[cur];
      *loc = cur;
      return true;
    }
    cur = a.next[cur];
  }
  return false;
}

// The fast path of one arena: the sorted segment of bucket b (scanned only
// when it is at most max_chain long), then the staged dirty tail.  On a hit
// sets val and loc (a node index).  `complete` is whether a miss proves
// absence: the segment was scanned and the window covers the tail.  A query
// that is found nowhere and not complete takes the bounded walk.
//
// The segment scan has ONE exit, so that the warp's lanes, which leave it
// after different numbers of nodes, meet again before the tail compare: with
// a return from inside the scan each group of lanes that left it together
// ran the whole tail compare on its own (chain_probe on an H100: 0.30 ms
// instead of 0.042 ms for 65536 queries against a 300-node tail, PERF.md).
__device__ __forceinline__ bool dhash_chain_fast(const DhashArena& a,
                                                 const DhashTail& t, int b,
                                                 int key, int max_chain,
                                                 int* val, int* loc,
                                                 bool* complete) {
  const int len = a.blen[b];
  const bool scan = len <= max_chain;
  *complete = scan && t.covered;
  bool found = false;
  if (scan) {
    const int start = a.bstart[b];
    for (int p = start; p < start + len; ++p) {
      if (a.key[p] == key && a.state[p] == DHASH_LIVE) {
        *val = a.val[p];
        *loc = p;
        found = true;
        break;
      }
    }
  }
  if (!found) {
    const int j = dhash_hazard_find(t.smem, t.size, t.n_live, key, val);
    if (j >= 0) {
      *loc = t.base + j;
      found = true;
    }
  }
  return found;
}

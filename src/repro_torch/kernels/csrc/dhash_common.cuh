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
#include <limits.h>
#include <stdint.h>

#define DHASH_EMPTY 0
#define DHASH_LIVE 1
#define DHASH_TOMB 2
#define DHASH_MIGRATED 3

#define DHASH_MAX_WIDTH 32
// the largest hazard buffer the probe2 kernels stage in shared memory (a
// staged set of 36 KiB, inside the 48 KiB a block gets without opting in),
// and what the extract kernel fills
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
  bool vec;           // key and state 16-byte aligned, n a multiple of 4
};

// Whether a segment scan may read an arena's keys and states as 16-byte
// loads (DhashArena::vec).
static inline bool dhash_arena_vec(const int* key, const int* state, int n) {
  return n % 4 == 0 && (uintptr_t)key % 16 == 0 &&
         (uintptr_t)state % 16 == 0;
}

// The largest dirty window (dirty_cap) the chain kernels stage.
#define DHASH_MAX_DIRTY 512

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

// ---------------------------------------------------------------------------
// the staged set: a buffer's live keys in shared memory behind a hashed index
// ---------------------------------------------------------------------------
//
// A dense lookup of a staged buffer scans it serially: one thread compares
// its key with every live entry up to the first match, up to 512 compares a
// query (4096 for a hazard buffer).  A staged set answers the same question
// -- the LOWEST live index holding the key, as argmax over the match mask
// gives it -- in a few shared-memory loads.
//
// Layout: a set of n entries occupies dhash_set_words(n) words of the
// kernel's dynamic shared memory (dhash_smem) from a word offset that is a
// multiple of 4; with n4 = n rounded up to a multiple of 4: one word for
// 1 + the index of its last flagged entry and three of padding, the keys
// (int32 [n4], 16-byte aligned), the index (dhash_set_slots(n) = a power of
// two >= 2n of 16-bit slots, each an entry index or DHASH_SET_EMPTY), the
// overflow bytes ([n4]), rounded up to 4 words.  No values are staged (a
// hit reads its value from device memory): 36 KiB at n = 4096, and a
// 4096-entry hazard set plus two 512-node tail sets take 45 KiB, inside the
// 48 KiB a block gets without opting in.  A DhashSet holds word offsets,
// not pointers, and every access forms its address from dhash_smem where it
// is made: with shared-memory pointers kept in a struct that a function
// returned, nvcc 12.9 -O3 compiled the index build of chain_probe2's tail
// sets to global-memory atomics on a null base (an illegal address on the
// card; -G compiled it right).
//
// The index is open addressing with linear probing from a fixed
// multiplicative hash of the key (dhash_set_home), not from the table's own
// hash family, so that keys aimed at one bucket of the table do not also
// collide here.  Building it (dhash_set_index), each live entry j claims
// the first empty slot of its probe run with a 16-bit compare-and-swap; if
// it meets its own key first, it lowers that slot to j (a 16-bit atomic
// min), so a key's slot ends at its lowest live index whatever the order
// the threads ran in.  Dead entries never enter.  A key takes at most
// DHASH_SET_RUN slots: one that finds all of them taken by other keys is
// flagged in the overflow bytes instead (and so are its duplicates, which
// meet the same full run), and a query whose run is full without an empty
// slot or a match scans the flagged entries up to the last one, lowest
// index first, four entries a step (one word of flags, one 16-byte load of
// keys).  Even a set whose every key has one home slot therefore costs
// DHASH_SET_RUN probes an entry to build, and DHASH_SET_RUN probes plus a
// quarter of the dense scan's steps to look up.

#define DHASH_SET_EMPTY 0xFFFFu
#define DHASH_SET_RUN 32
// threads of a block that stages a set: one block an SM builds it once for
// all the SM's queries (dhash_set_grid)
#define DHASH_SET_THREADS 1024

// the dynamic shared memory of a kernel that stages sets
extern __shared__ __align__(16) int dhash_smem[];

// Slots of the index of an n-entry set: a power of two, at least 2n and 2.
__host__ __device__ inline int dhash_set_slots(int n) {
  int s = 2;
  while (s < 2 * n) s <<= 1;
  return s;
}

// Shared-memory words of an n-entry set, a multiple of 4.
__host__ __device__ inline int dhash_set_words(int n) {
  const int n4 = (n + 3) & ~3;
  return (4 + n4 + dhash_set_slots(n) / 2 + n4 / 4 + 3) & ~3;
}

// An n-entry set at word `off` of dhash_smem: the word offsets of its
// parts, and its index's mask and hash shift.
struct DhashSet {
  int n, key, slot, ovf;    // entries; offsets of keys, index, flags
  int mask, shift;          // slots - 1, 32 - log2(slots)
};

__device__ __forceinline__ DhashSet dhash_set_at(int off, int n) {
  const int slots = dhash_set_slots(n), n4 = (n + 3) & ~3;
  DhashSet s;
  s.n = n;
  s.key = off + 4;
  s.slot = off + 4 + n4;
  s.ovf = off + 4 + n4 + slots / 2;
  s.mask = slots - 1;
  s.shift = 33 - __ffs(slots);
  return s;
}

// 1 + the index of the set's last flagged entry (the word at its offset).
__device__ __forceinline__ int* dhash_set_end(const DhashSet& s) {
  return dhash_smem + s.key - 4;
}

__device__ __forceinline__ int* dhash_set_keys(const DhashSet& s) {
  return dhash_smem + s.key;
}

// the index as words of two 16-bit slots (slot h in the low half of word
// h / 2 when h is even)
__device__ __forceinline__ unsigned* dhash_set_index_words(const DhashSet& s) {
  return (unsigned*)(dhash_smem + s.slot);
}

__device__ __forceinline__ uint8_t* dhash_set_flags(const DhashSet& s) {
  return (uint8_t*)(dhash_smem + s.ovf);
}

// The home slot of a key: Fibonacci hashing, the top bits of key * 2^32/phi.
__device__ __forceinline__ unsigned dhash_set_home(const DhashSet& s,
                                                   int key) {
  return ((unsigned)key * 0x9E3779B1u) >> s.shift;
}

__device__ __forceinline__ unsigned dhash_set_slot(const DhashSet& s,
                                                   unsigned h) {
  return (dhash_set_index_words(s)[h >> 1] >> ((h & 1u) * 16u)) & 0xFFFFu;
}

// 16-bit compare-and-swap (cmp -> val) and atomic min on slot h, by 32-bit
// compare-and-swap on the word that holds it; the CAS returns the slot's
// value before it.
__device__ __forceinline__ unsigned dhash_set_cas(const DhashSet& s,
                                                  unsigned h, unsigned cmp,
                                                  unsigned val) {
  unsigned* w = dhash_set_index_words(s) + (h >> 1);
  const unsigned sh = (h & 1u) * 16u;
  unsigned old = *(volatile unsigned*)w;
  for (;;) {
    const unsigned cur = (old >> sh) & 0xFFFFu;
    if (cur != cmp) return cur;
    const unsigned prev =
        atomicCAS(w, old, (old & ~(0xFFFFu << sh)) | (val << sh));
    if (prev == old) return cmp;
    old = prev;
  }
}

__device__ __forceinline__ void dhash_set_min(const DhashSet& s, unsigned h,
                                              unsigned val) {
  unsigned* w = dhash_set_index_words(s) + (h >> 1);
  const unsigned sh = (h & 1u) * 16u;
  unsigned old = *(volatile unsigned*)w;
  for (;;) {
    if (((old >> sh) & 0xFFFFu) <= val) return;
    const unsigned prev =
        atomicCAS(w, old, (old & ~(0xFFFFu << sh)) | (val << sh));
    if (prev == old) return;
    old = prev;
  }
}

// First half of the stage: clear the index and copy the n entries' keys;
// `entry(j, &key)` gives entry j's key and returns whether it is live.
// Every thread of the block calls it; a __syncthreads() must follow before
// dhash_set_index (several sets may be filled before one barrier).
template <class Entry>
__device__ __forceinline__ void dhash_set_fill(const DhashSet& s,
                                               Entry entry) {
  unsigned* words = dhash_set_index_words(s);
  int* keys = dhash_set_keys(s);
  uint8_t* flags = dhash_set_flags(s);
  for (int w = threadIdx.x; w <= s.mask >> 1; w += blockDim.x)
    words[w] = 0xFFFFFFFFu;
  for (int j = threadIdx.x; j < ((s.n + 3) & ~3); j += blockDim.x) {
    int k = 0;
    const bool live = j < s.n && entry(j, &k);
    keys[j] = k;
    flags[j] = live ? 1 : 0;    // live and not yet in the index
  }
  if (threadIdx.x == 0) *dhash_set_end(s) = 0;
}

// Second half: every live entry into the index, or flagged.  Every thread
// of the block calls it; a __syncthreads() must follow before a find.
__device__ __forceinline__ void dhash_set_index(const DhashSet& s) {
  const int* keys = dhash_set_keys(s);
  uint8_t* flags = dhash_set_flags(s);
  int my_end = 0;
  for (int j = threadIdx.x; j < s.n; j += blockDim.x) {
    if (!flags[j]) continue;
    const int k = keys[j];
    unsigned h = dhash_set_home(s, k);
    bool placed = false;
    for (int p = 0; p < DHASH_SET_RUN && !placed; ++p) {
      const unsigned e = dhash_set_cas(s, h, DHASH_SET_EMPTY, j);
      if (e == DHASH_SET_EMPTY) {
        placed = true;
      } else if (keys[e] == k) {
        dhash_set_min(s, h, j);
        placed = true;
      }
      h = (h + 1) & s.mask;
    }
    if (placed)
      flags[j] = 0;
    else
      my_end = j + 1;
  }
  if (my_end) atomicMax(dhash_set_end(s), my_end);
}

// Both halves of the stage of one set, with their barriers.
template <class Entry>
__device__ __forceinline__ void dhash_set_stage(const DhashSet& s,
                                                Entry entry) {
  dhash_set_fill(s, entry);
  __syncthreads();
  dhash_set_index(s);
  __syncthreads();
}

// The lowest live index of the set holding `key`, or -1.  One exit from
// each loop, so the warp's lanes meet again after it.
__device__ __forceinline__ int dhash_set_find(const DhashSet& s, int key) {
  const int* keys = dhash_set_keys(s);
  unsigned h = dhash_set_home(s, key);
  int r = -1;
  bool open = true;    // the run is full: the key may be flagged
  for (int p = 0; p < DHASH_SET_RUN; ++p) {
    const unsigned e = dhash_set_slot(s, h);
    if (e == DHASH_SET_EMPTY) {
      open = false;
      break;
    }
    if (keys[e] == key) {
      r = (int)e;
      open = false;
      break;
    }
    h = (h + 1) & s.mask;
  }
  if (open) {
    const int end = (*dhash_set_end(s) + 3) >> 2;
    const unsigned* flags = (const unsigned*)dhash_set_flags(s);
    const int4* keys4 = (const int4*)keys;
    for (int w = 0; w < end; ++w) {
      const unsigned f = flags[w];
      if (f == 0) continue;
      const int4 k = keys4[w];
      const int l = (f & 0xFFu) && k.x == key           ? 0
                    : (f & 0xFF00u) && k.y == key       ? 1
                    : (f & 0xFF0000u) && k.z == key     ? 2
                    : (f & 0xFF000000u) && k.w == key   ? 3
                                                        : -1;
      if (l >= 0) {
        r = 4 * w + l;
        break;
      }
    }
  }
  return r;
}

// An arena's dirty-tail window as a staged set: the `size` nodes at [base,
// base + size) with base = min(sorted_upto, N - size), of which a node
// counts if it is LIVE at or past sorted_upto (the reference's
// _chain_dirty_window).  `covered` is whether the window holds the whole
// tail, so that a miss there proves absence.  The value of a hit is read
// from the arena.
struct DhashSetTail {
  DhashSet set;
  int base;
  bool covered;
};

// First half of the stage of a tail set at word `off`; a __syncthreads()
// and dhash_set_index(t.set) follow.
__device__ __forceinline__ DhashSetTail dhash_tail_set_fill(
    const DhashArena& a, int sorted_upto, int dirty, int size, int off) {
  DhashSetTail t;
  t.set = dhash_set_at(off, size);
  t.base = min(sorted_upto, a.n - size);
  t.covered = sorted_upto + dirty <= t.base + size;
  const int base = t.base;
  dhash_set_fill(t.set, [&](int j, int* k) {
    const int p = base + j;
    *k = a.key[p];
    return p >= sorted_upto && a.state[p] == DHASH_LIVE;
  });
  return t;
}

__device__ __forceinline__ bool dhash_tail_find(const DhashArena& a,
                                                const DhashSetTail& t,
                                                int key, int* val,
                                                int* loc) {
  const int j = dhash_set_find(t.set, key);
  if (j >= 0) {
    *val = a.val[t.base + j];
    *loc = t.base + j;
  }
  return j >= 0;
}

// The fast path of one arena: the sorted segment of bucket b (scanned only
// when it is at most max_chain long), then the dirty tail's staged set
// (dhash_tail_find).  On a hit sets val and loc (a node index).
// `complete` is whether a miss proves absence: the segment was scanned and
// the window covers the tail.  A query that is found nowhere and not
// complete takes the bounded walk.
//
// The segment scan has ONE exit, so that the warp's lanes, which leave it
// after different numbers of nodes, meet again before the tail lookup: with
// a return from inside the scan each group of lanes that left it together
// ran the tail lookup on its own (chain_probe's first design, a serial
// scan of the staged tail, on an H100: 0.30 ms instead of 0.042 ms for 65536
// queries against a 300-node tail, PERF.md).  Where the arena allows
// (DhashArena::vec) the scan reads keys and states as 16-byte loads, four
// nodes a step from the 16-byte boundary at or below the segment's start:
// a warp's lanes scan different buckets, so each load of the scan touches
// up to 32 lines, and four nodes a load cut those loads to a quarter
// (chain_probe on an H100, 65536 queries: 0.0234 ms against 0.0247 a node
// a step, PERF.md).
__device__ __forceinline__ bool dhash_chain_fast(const DhashArena& a,
                                                 const DhashSetTail& t, int b,
                                                 int key, int max_chain,
                                                 int* val, int* loc,
                                                 bool* complete) {
  const int len = a.blen[b];
  const bool scan = len <= max_chain;
  *complete = scan && t.covered;
  bool found = false;
  if (scan && a.vec) {     // four nodes a step, from a 16-byte boundary
    const int start = a.bstart[b], end = start + len;
    for (int p = start & ~3; p < end && !found; p += 4) {
      const int4 k4 = *reinterpret_cast<const int4*>(a.key + p);
      const int4 s4 = *reinterpret_cast<const int4*>(a.state + p);
      const int k[4] = {k4.x, k4.y, k4.z, k4.w};
      const int s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = p + u;
        if (!found && q >= start && q < end && k[u] == key &&
            s[u] == DHASH_LIVE) {
          *val = a.val[q];
          *loc = q;
          found = true;
        }
      }
    }
  } else if (scan) {
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
  if (!found) found = dhash_tail_find(a, t, key, val, loc);
  return found;
}

// Multiprocessors of the calling thread's current device, cached.
static inline cudaError_t dhash_sm_count(int* sms) {
  static int cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

// The grid of a kernel that stages a set: at most one block of
// DHASH_SET_THREADS an SM, so each SM builds the set once, and no more
// blocks than runs of 32 queries (dhash_set_first / dhash_set_stride).
static inline cudaError_t dhash_set_grid(int Q, int* blocks) {
  int sms = 0;
  const cudaError_t e = dhash_sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int b = (Q + 31) / 32;
  *blocks = b < 1 ? 1 : (b > sms ? sms : b);
  return cudaSuccess;
}

// The queries of a thread under dhash_set_grid: runs of 32 consecutive
// queries, one a warp (coalesced), dealt round-robin to the blocks, so that
// a region of the batch that is slow to answer (keys of one flooded bucket)
// spreads over every SM: for (i = dhash_set_first(); i < Q; i +=
// dhash_set_stride()).
__device__ __forceinline__ int dhash_set_first() {
  return ((threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 +
         (threadIdx.x & 31);
}

__device__ __forceinline__ int dhash_set_stride() {
  return (blockDim.x >> 5) * gridDim.x * 32;
}

// ---------------------------------------------------------------------------
// the hash families of core/hashing.py, bit for bit (u32 arithmetic with
// wrap-around, logical shifts); a function's seeds are int64 words holding
// u32 values, its kind one of the codes below (its index in HASH_KINDS)
// ---------------------------------------------------------------------------

#define DHASH_KIND_MULTIPLY_SHIFT 0
#define DHASH_KIND_MIX32 1
#define DHASH_KIND_TABULATION 2

__device__ __forceinline__ uint32_t dhash_mix32(uint32_t x, uint32_t s0,
                                                uint32_t s1) {
  x ^= s0;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x ^ s1;
}

// hashing.hash_u32 of one key.
__device__ __forceinline__ uint32_t dhash_hash_u32(int kind,
                                                   const long long* seeds,
                                                   int key) {
  const uint32_t k = (uint32_t)key;
  if (kind == DHASH_KIND_MULTIPLY_SHIFT)
    return k * (uint32_t)seeds[0] + (uint32_t)seeds[1];
  if (kind == DHASH_KIND_MIX32)
    return dhash_mix32(k, (uint32_t)seeds[0], (uint32_t)seeds[1]);
  return (uint32_t)seeds[k & 0xFF] ^ (uint32_t)seeds[256 + ((k >> 8) & 0xFF)] ^
         (uint32_t)seeds[512 + ((k >> 16) & 0xFF)] ^
         (uint32_t)seeds[768 + (k >> 24)];
}

// hashing.bucket_of of one key: a mask for a power-of-two bucket count.
__device__ __forceinline__ int dhash_bucket_of(int kind, const long long* seeds,
                                               int key, int nbuckets) {
  const uint32_t h = dhash_hash_u32(kind, seeds, key);
  const uint32_t n = (uint32_t)nbuckets;
  return (int)((n & (n - 1)) == 0 ? (h & (n - 1)) : (h % n));
}

// hashing.reseed of seed word `pos` under `salt` (an int32, wrapped): the
// mix32 finalizer over (seed ^ mixed salt, 0x27D4EB2F ^ pos, 0x165667B1).
__device__ __forceinline__ uint32_t dhash_reseed_word(uint32_t seed,
                                                      uint32_t salt,
                                                      uint32_t pos) {
  const uint32_t s = salt * 0x9E3779B1u + 0x85EBCA77u;
  return dhash_mix32(seed ^ s, 0x27D4EB2Fu ^ pos, 0x165667B1u);
}

// First lane of `row` that is not LIVE, or -1, read from L2 (past the SM's
// own L1, so a write another block made before a launch boundary or a
// barrier is seen).  With VEC the row is read as 16-byte loads.
template <bool VEC>
__device__ __forceinline__ int dhash_row_first_free(const int* ts,
                                                    long long row, int W) {
  const long long base = row * W;
  if (VEC) {
    for (int l = 0; l < W; l += 4) {
      const int4 s = __ldcg(reinterpret_cast<const int4*>(ts + base + l));
      if (s.x != DHASH_LIVE) return l;
      if (s.y != DHASH_LIVE) return l + 1;
      if (s.z != DHASH_LIVE) return l + 2;
      if (s.w != DHASH_LIVE) return l + 3;
    }
  } else {
    for (int l = 0; l < W; ++l)
      if (__ldcg(ts + base + l) != DHASH_LIVE) return l;
  }
  return -1;
}

// The lanes of `row` that are not LIVE, as a bit mask (lane l is bit l),
// read from L2 with every load of the row issued before any is tested: one
// round trip a row, where dhash_row_first_free stops at the first free lane.
template <bool VEC>
__device__ __forceinline__ unsigned dhash_row_free_mask(const int* ts,
                                                        long long row, int W) {
  const long long base = row * W;
  unsigned m = 0;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < DHASH_MAX_WIDTH / 4; ++q) {
      if (4 * q >= W) break;
      const int4 s = __ldcg(reinterpret_cast<const int4*>(ts + base + 4 * q));
      m |= ((unsigned)(s.x != DHASH_LIVE) | (unsigned)(s.y != DHASH_LIVE) << 1 |
            (unsigned)(s.z != DHASH_LIVE) << 2 |
            (unsigned)(s.w != DHASH_LIVE) << 3) << (4 * q);
    }
  } else {
    for (int l = 0; l < W; ++l)
      m |= (unsigned)(__ldcg(ts + base + l) != DHASH_LIVE) << l;
  }
  return m;
}

// One pending query's plan in iteration `it` (dhash_kick_rounds): kind 0
// (none), 1 (plan A: the key into `slot`), 2 (plan B: the victim in `slot`,
// key `vkey` and value `vval`, moves to lane `lane2` of row `row2`, and the
// key takes its lane).  Both rows' states are loaded together; with both
// full every lane is LIVE, so a victim's state needs no test.
template <bool VEC>
__device__ __forceinline__ void dhash_kick_plan(
    const int* tk, const int* tv, const int* ts, int W, int nbuckets, int ra,
    int rb, int it, const long long* __restrict__ seeds_a, int kind_a,
    const long long* __restrict__ seeds_b, int kind_b, int* kind, int* slot,
    int* row2, int* lane2, int* vkey, int* vval) {
  const unsigned fa = dhash_row_free_mask<VEC>(ts, ra, W);
  const unsigned fb = dhash_row_free_mask<VEC>(ts, rb, W);
  *kind = 0;
  if (fa | fb) {
    *kind = 1;
    *slot = fa ? ra * W + __ffs(fa) - 1 : rb * W + __ffs(fb) - 1;
    return;
  }
  for (int r = 0; r < 2 * W; ++r) {
    const int l = (r + it) % (2 * W);
    const int vs = (l < W ? ra : rb) * W + (l % W);
    const int k = __ldcg(tk + vs);
    const int v = __ldcg(tv + vs);
    const int alt = l < W
        ? nbuckets + dhash_bucket_of(kind_b, seeds_b, k, nbuckets)
        : dhash_bucket_of(kind_a, seeds_a, k, nbuckets);
    const unsigned fr = dhash_row_free_mask<VEC>(ts, alt, W);
    if (fr) {
      *kind = 2;
      *slot = vs;
      *row2 = alt;
      *lane2 = __ffs(fr) - 1;
      *vkey = k;
      *vval = v;
      return;
    }
  }
}

// A plan that holds its rows, carried out (the rows it touches are the
// plan's since it was made: only their lock's holder writes them): plan
// B's victim into its alternate row, then the key into `slot`.
__device__ __forceinline__ void dhash_kick_write(int* tk, int* tv, int* ts,
                                                 int W, int kind, int slot,
                                                 int row2, int lane2,
                                                 int vkey, int vval, int key,
                                                 int val) {
  if (kind == 2) {
    const int alt = row2 * W + lane2;
    tk[alt] = vkey;
    tv[alt] = vval;
    ts[alt] = DHASH_LIVE;
  }
  tk[slot] = key;
  tv[slot] = val;
  ts[slot] = DHASH_LIVE;
}

// The cuckoo insert's bounded kick-out (cuckoo_kick_ref over the whole batch
// for max_kick iterations, slot for slot), by one block of any size, over a
// list of n batch indices of the queries it takes, in any order (an entry < 0
// is skipped).  In iteration `it` each pending query forms one plan on the
// table as it is at the start of the iteration: plan A, the first free lane
// of row a, else of row b; plan B (both rows full), the first LIVE victim
// among the 2W lanes (row a's, then row b's) scanned from lane it mod 2W
// whose alternate row (the other side, under the other hash function) has a
// free lane.  A row's lock goes to the lowest batch index among the plans
// that touch it (atomicMin on lock[row]; the locks are CLAIM_FREE = INT_MAX
// on entry and every one taken is restored), and a query acts only if it
// holds every row its plan touches: plan A writes the key, plan B moves the
// victim into the alternate row's first free lane and writes the key into the
// lane it vacated.  Nothing depends on the order of the entries, so the
// placement is the reference's.  The iterations end early when no query is
// pending, or when no pending query could form a plan (then none ever can:
// the table did not change); the counts ride on the barriers
// (__syncthreads_or).  A placed entry of the list turns INT_MIN.  With no
// more entries than threads each thread keeps its one query's state in
// registers across the barriers (the main path: a few keys); otherwise
// `plan` holds three int32 words a list entry.  `tally` (optional) gets one run, the
// iterations and n.  Every thread of the block must call it; table words
// another block or launch wrote are read from L2 (__ldcg).
template <bool VEC>
__device__ __forceinline__ void dhash_kick_rounds(
    int* tk, int* tv, int* ts, int W, int nbuckets,
    const int* __restrict__ rows_a, const int* __restrict__ rows_b,
    const int* __restrict__ keys, const int* __restrict__ vals, uint8_t* ok,
    int max_kick, const long long* __restrict__ seeds_a, int kind_a,
    const long long* __restrict__ seeds_b, int kind_b, int* lock,
    int* list, int n, int* plan, int* tally) {
  const int t = threadIdx.x;
  int it = 0;
  if (n <= (int)blockDim.x) {
    // a query a thread at most: its rows, key, value and plan stay in
    // registers across the barriers (no plan words, no list re-reads)
    int i = t < n ? __ldcg(&list[t]) : -1;
    int ra = 0, rb = 0, key = 0, val = 0;
    if (i >= 0) {
      ra = rows_a[i];
      rb = rows_b[i];
      key = keys[i];
      val = vals[i];
    }
    while (it < max_kick) {
      int kind = 0, slot = 0, row2 = 0, lane2 = 0, vkey = 0, vval = 0;
      if (i >= 0) {
        dhash_kick_plan<VEC>(tk, tv, ts, W, nbuckets, ra, rb, it, seeds_a,
                             kind_a, seeds_b, kind_b, &kind, &slot, &row2,
                             &lane2, &vkey, &vval);
        if (kind) atomicMin(&lock[slot / W], i);
        if (kind == 2) atomicMin(&lock[row2], i);
      }
      if (!__syncthreads_or(kind)) break;    // no plan now, none ever: stop
      ++it;
      const bool own = kind && __ldcg(&lock[slot / W]) == i &&
                       (kind != 2 || __ldcg(&lock[row2]) == i);
      __syncthreads();                       // every lock read, then freed
      if (kind) lock[slot / W] = INT_MAX;
      if (kind == 2) lock[row2] = INT_MAX;
      if (own) {
        dhash_kick_write(tk, tv, ts, W, kind, slot, row2, lane2, vkey, vval,
                         key, val);
        ok[i] = 1;
        list[t] = INT_MIN;         // placed
        i = -1;
      }
      if (!__syncthreads_or(i >= 0)) break;  // every key placed
    }
  } else {
    while (it < max_kick) {
      // plan: on the table as it is at the start of the iteration
      int planned = 0;
      for (int j = t; j < n; j += blockDim.x) {
        const int i = __ldcg(&list[j]);
        if (i < 0) continue;
        int kind, slot = 0, row2 = 0, lane2, vkey, vval;
        dhash_kick_plan<VEC>(tk, tv, ts, W, nbuckets, rows_a[i], rows_b[i],
                             it, seeds_a, kind_a, seeds_b, kind_b, &kind,
                             &slot, &row2, &lane2, &vkey, &vval);
        plan[3 * j] = kind;
        plan[3 * j + 1] = slot;
        plan[3 * j + 2] = row2;
        if (kind) {
          atomicMin(&lock[slot / W], i);
          if (kind == 2) atomicMin(&lock[row2], i);
          planned = 1;
        }
      }
      if (!__syncthreads_or(planned)) break;  // no plan now, none ever
      ++it;
      // the locks: a plan acts only on rows it holds
      for (int j = t; j < n; j += blockDim.x) {
        const int i = __ldcg(&list[j]);
        const int kind = plan[3 * j];
        if (i < 0 || kind == 0) continue;
        const bool own = __ldcg(&lock[plan[3 * j + 1] / W]) == i &&
                         (kind != 2 || __ldcg(&lock[plan[3 * j + 2]]) == i);
        if (own) plan[3 * j] = kind + 2;
      }
      __syncthreads();
      // the writes, each in rows its query holds; every lock taken restored
      int left = 0;
      for (int j = t; j < n; j += blockDim.x) {
        const int i = __ldcg(&list[j]);
        const int kind = plan[3 * j];
        if (i < 0) continue;
        left |= kind <= 2;
        if (kind == 0) continue;
        const int slot = plan[3 * j + 1], row2 = plan[3 * j + 2];
        lock[slot / W] = INT_MAX;
        if (kind == 2 || kind == 4) lock[row2] = INT_MAX;
        if (kind <= 2) continue;
        if (kind == 4) {             // plan B: the victim, as it is now
          const unsigned fr = dhash_row_free_mask<VEC>(ts, row2, W);
          dhash_kick_write(tk, tv, ts, W, 2, slot, row2, __ffs(fr) - 1,
                           __ldcg(tk + slot), __ldcg(tv + slot), keys[i],
                           vals[i]);
        } else {
          dhash_kick_write(tk, tv, ts, W, 1, slot, 0, 0, 0, 0, keys[i],
                           vals[i]);
        }
        ok[i] = 1;
        list[j] = INT_MIN;         // placed: skipped from now on
      }
      if (!__syncthreads_or(left)) break;    // every key placed
    }
  }
  if (t == 0 && tally != nullptr) {
    atomicAdd(&tally[0], 1);
    atomicAdd(&tally[1], it);
    atomicAdd(&tally[2], n);
  }
}

// Ordered ranking by one block: calls emit(i, r) for the indices i of
// [0, Q) with keep(i), r counting up from n[0] in ascending order of i, and
// advances n[0] (shared; n[1] is scratch), which every thread may read
// after the call.  Each thread tests a run of up to 16 consecutive indices,
// so a batch of up to 16 x blockDim indices is one pass: one shuffle scan
// of the counts and one scan of the warp totals.  `warp_tot` is 32 words of
// shared scratch.  Every thread of the block must call it.
template <class Keep, class Emit>
__device__ __forceinline__ void dhash_block_rank(int Q, Keep keep, Emit emit,
                                                 int* warp_tot, int* n) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per_pass = blockDim.x * 16;
  for (int base = 0; base < Q; base += per_pass) {
    const int len = Q - base < per_pass ? Q - base : per_pass;
    const int ipt = (len + blockDim.x - 1) / blockDim.x;
    const int lo = base + t * ipt;
    const int hi = lo + ipt < base + len ? lo + ipt : base + len;
    unsigned bits = 0;
    int cnt = 0;
    for (int i = lo; i < hi; ++i)
      if (keep(i)) {
        bits |= 1u << (i - lo);
        ++cnt;
      }
    int incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < nwarps ? warp_tot[lane] : 0;
      int wi = w;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, wi, d);
        if (lane >= d) wi += v;
      }
      if (lane < nwarps) warp_tot[lane] = wi - w;
      if (lane == 31) n[1] = wi;       // this pass's total
    }
    __syncthreads();
    int pos = n[0] + warp_tot[warp] + incl - cnt;
    for (int i = lo; i < hi; ++i)
      if ((bits >> (i - lo)) & 1u) emit(i, pos++);
    __syncthreads();
    if (t == 0) n[0] += n[1];
    __syncthreads();
  }
}

// Ordered compaction by one block: appends to list[n[0] ...] the indices i
// of [0, Q) with keep(i), in ascending order (dhash_block_rank).
template <class Keep>
__device__ __forceinline__ void dhash_block_compact(int Q, Keep keep,
                                                    int* __restrict__ list,
                                                    int* warp_tot, int* n) {
  dhash_block_rank(
      Q, keep, [&](int i, int r) { list[r] = i; }, warp_tot, n);
}

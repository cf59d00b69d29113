// probe_insert: batched claim-first-non-LIVE insert, in place.
//
// Replaces the TPU kernel _probe_insert_kernel (src/repro/kernels/probe.py)
// AND the cross-tile claim resolution its wrapper did afterwards.  The
// placement is that of the plain oracle (probe_insert_ref / linear_insert)
// slot for slot: presence is proved on the table as it was before the
// batch, then rounds p = 0 .. max_probes-1 run in lock step, every pending
// query looking at slot (h0 + p) mod C in round p; a slot that is not LIVE
// at the start of the round goes to the LOWEST batch index that wants it.
//
// No round is run here.  In round p two queries want one slot only if they
// have the same start slot h0, and group h (the queries with h0 = h) reaches
// slot s in round s - h: groups with a larger h0 reach a slot first.  So the
// lock-step result is a greedy pass in DESCENDING h0: each group, in
// ascending batch index, takes the first slots of [h, h + max_probes) that
// are not LIVE and that no group already processed took.  The result for the
// groups with h0 in [a, b) depends only on the groups and the table's states
// in [a, b + max_probes - 1) (a "halo" of max_probes - 1 slots above the
// range), as long as that window does not wrap onto itself.
//
// Two kernels, no barrier inside either:
//
//   * probe_insert_resolve (reads only): block r owns the start slots
//     [r W, r W + W), W = ceil(C / blocks): one block a 64 queries, at most
//     one an SM, and enough that C >= W + max_probes - 1.  It reads the
//     whole h0 array and mask (40 KiB at Q = 8192, from L2) as 16-byte
//     loads, lists its range's masked queries in batch order (a block
//     scan), and counts the halo's pending queries (the groups there matter
//     only through the slots they take).  A warp then reads each listed
//     query's window, 64 slots as two ballots: its free slots (not LIVE)
//     and whether the key is LIVE before the first EMPTY slot (presence; a
//     probe run never leaves the window).  The pending queries are sorted
//     by (h0, batch order) in shared memory (a rank by counting; bitonic
//     above 1024), and each cluster of groups (groups less than max_probes
//     apart) is walked by one thread from its top down with two 64-bit
//     masks a group: the window's free slots and the slots that the groups
//     above, halo included, took.  It writes `present` and a target slot
//     (or -1) for the queries of its own range.  A range with more queries
//     than a block lists (PI_CAP) is halved until they fit (the halves
//     read the presence the first pass wrote); a range of one start slot
//     that still does not fit is counted, and its queries are ranked in
//     batch order in a second sweep.
//   * probe_insert_write: every query with a target writes key, value and
//     LIVE, and sets `ok`.  Targets are distinct, so nothing contends.
//
// Windows wider than 64 slots (max_probes > 64) or wider than the table
// (max_probes > C, where a group's window wraps onto itself) take
// probe_insert_lockstep: ONE block proves presence for the whole batch and
// then runs the rounds with __syncthreads(), claims resolved in batch order
// a chunk of 1024 queries at a time through a small hashed claim map in
// shared memory; it writes the table itself (the write kernel then only
// repeats those writes and sets `ok`).
//
// Bound: bytes -- the batch's keys, values, mask and start slots, the
// presence probes, the winners' writes; in practice the latency of a few
// dependent rounds of loads a block (the batch, the windows, the writes)
// and the launch of two kernels.  The first design ran the rounds over the
// whole grid with up to 1 + 2 * max_probes cooperative grid syncs a launch
// and kept an int32 claim word a slot (8 MiB at 2^21 slots); this one holds
// no claim word and no grid barrier, and its result does not depend on the
// order in which threads run.  The ordering it relies on is pinned on the
// CPU by tests/test_torch_insert_order.py.
//
// A table stack: T tables in one launch, each resolved on its own, table t
// on grid row blockIdx.y with its rows of the stacked [T, C] table and
// [T, Q] batch.  Its target is the table given, or, where `sel` (one byte
// a table, or null) is set, the alternative table of the same shape given
// beside it: the reference's cond(rebuilding) in dhash.insert (new table
// mid-rebuild, else old), decided here on the device.  A row of the greedy
// path takes ceil(SMs / T) blocks at most (and still enough that its
// ranges never wrap).  One table is T = 1 with no `sel`.
//
// Caller contract (as the reference): mask is winner-filtered, at most one
// set entry for each distinct key.
#include <limits.h>

#include "dhash_common.cuh"

typedef unsigned long long u64;

#define PI_THREADS 1024
// queries of a range a block lists at once: 2048 x 36 bytes of dynamic
// shared memory, and the halo's counts
#define PI_CAP 2048
#define PI_SMEM_BYTES (PI_CAP * 36 + 256)
// the widest window of the greedy path (one 64-bit mask a group)
#define PI_MAX_WINDOW 64
// queries each thread reads per sweep of the batch
#define PI_PER_THREAD 8
#define PI_NONE (~0ull)

// Whether query `key` is LIVE in the table before the batch: the scalar
// walk, for the few queries that the warps of pi_range do not probe.
__device__ __forceinline__ bool pi_present(const int* __restrict__ tk,
                                           const int* __restrict__ ts,
                                           int C, int h0, int key,
                                           int max_probes) {
  int pos = h0;
  for (int p = 0; p < max_probes; ++p) {
    const int st = ts[pos];
    if (st == DHASH_EMPTY) break;
    if (st == DHASH_LIVE && tk[pos] == key) return true;
    if (++pos == C) pos = 0;
  }
  return false;
}

// Exclusive prefix sum of v over the block (PI_THREADS threads); *total is
// the block's sum.  Holds three barriers; `scratch` is 33 shared ints.
__device__ __forceinline__ int pi_block_scan(int v, int* scratch,
                                             int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (PI_THREADS >> 5) ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    scratch[lane] = w;      // inclusive sums of the warps
    if (lane == 31) scratch[32] = w;
  }
  __syncthreads();
  const int before = (warp ? scratch[warp - 1] : 0) + x - v;
  *total = scratch[32];
  __syncthreads();          // read before the next scan writes
  return before;
}

// The lowest `n` set bits of m.
__device__ __forceinline__ u64 pi_lowest(u64 m, int n) {
  u64 rest = m;
  for (int k = 0; k < n && rest; ++k) rest &= rest - 1;
  return m ^ rest;
}

// Position of the set bit of rank r (0 = lowest) of m; m has more than r.
__device__ __forceinline__ int pi_nth_bit(u64 m, int r) {
  for (int k = 0; k < r; ++k) m &= m - 1;
  return __ffsll((long long)m) - 1;
}

// Window mask of max_probes bits.
__device__ __forceinline__ u64 pi_full(int max_probes) {
  return max_probes >= 64 ? ~0ull : ((1ull << max_probes) - 1);
}

// Table t of a stack (t = blockIdx.y): the target's arrays (the
// alternative where sel[t] is set) and the batch's row.
struct PiTable {
  int *tk, *tv, *ts;
  long long tq;                // the batch row's first element
};

__device__ __forceinline__ PiTable pi_table(int* tk, int* tv, int* ts,
                                            int* tk2, int* tv2, int* ts2,
                                            const uint8_t* sel, int C,
                                            int Q) {
  const int t = blockIdx.y;
  const bool alt = sel != nullptr && sel[t] != 0;
  const long long tc = (long long)t * C;
  PiTable r;
  r.tk = (alt ? tk2 : tk) + tc;
  r.tv = (alt ? tv2 : tv) + tc;
  r.ts = (alt ? ts2 : ts) + tc;
  r.tq = (long long)t * Q;
  return r;
}

// Slot h + j mod C, for 0 <= h < C and 0 <= j < 3 C.
__device__ __forceinline__ int pi_wrap(long long h, int j, int C) {
  long long s = h + j;
  while (s >= C) s -= C;
  return (int)s;
}

// Shared memory of the greedy path: the list (key (offset << 32 | list
// position), then sorted into the second array), each listed query's index
// and window mask, each group's first entry and end, the halo's pending
// counts.  Addresses are formed from dhash_smem where they are used (see
// DhashSet in dhash_common.cuh).
#define PI_ENT ((u64*)dhash_smem)
#define PI_SRT (PI_ENT + PI_CAP)
#define PI_WMASK (PI_SRT + PI_CAP)
#define PI_QIDX ((int*)(PI_WMASK + PI_CAP))
#define PI_FIRST (PI_QIDX + PI_CAP)
#define PI_GEND (PI_FIRST + PI_CAP)
#define PI_HCNT (PI_GEND + PI_CAP)

// A warp reads the window [h, h + P) (P <= 64: two slots a lane, states
// and, with `probe`, keys) and returns its free slots
// (not LIVE before the batch), bit j for slot h + j mod C; with `probe`,
// *there is whether `key` is LIVE in its probe run (the first EMPTY or
// matching slot decides; a run never leaves the window).  Every lane gets
// both.
__device__ __forceinline__ u64 pi_warp_window(const int* __restrict__ tk,
                                              const int* __restrict__ ts,
                                              int C, int h, int key, int P,
                                              bool probe, bool* there) {
  const int lane = threadIdx.x & 31;
  const bool in0 = lane < P, in1 = lane + 32 < P;
  const int p0 = in0 ? pi_wrap(h, lane, C) : 0;
  const int p1 = in1 ? pi_wrap(h, lane + 32, C) : 0;
  const int s0 = in0 ? ts[p0] : DHASH_LIVE, s1 = in1 ? ts[p1] : DHASH_LIVE;
  const int k0 = probe && in0 ? tk[p0] : 0, k1 = probe && in1 ? tk[p1] : 0;
  const unsigned full = 0xffffffffu;
  if (probe) {
    const u64 stop = (u64)__ballot_sync(full, in0 && s0 == DHASH_EMPTY) |
                     ((u64)__ballot_sync(full, in1 && s1 == DHASH_EMPTY)
                      << 32);
    const u64 hit =
        (u64)__ballot_sync(full, s0 == DHASH_LIVE && in0 && k0 == key) |
        ((u64)__ballot_sync(full, s1 == DHASH_LIVE && in1 && k1 == key)
         << 32);
    *there = hit && (!stop || __ffsll((long long)hit) <
                                  __ffsll((long long)stop));
  }
  return (u64)__ballot_sync(full, s0 != DHASH_LIVE) |
         ((u64)__ballot_sync(full, s1 != DHASH_LIVE) << 32);
}

// Count query i (masked, local offset `off` in the halo above `base`) if it
// is pending: a halo slot inside the block's own range has its `present`
// from the block's first pass; one in the next block's range is probed.
__device__ __forceinline__ void pi_halo_count(
    const int* __restrict__ tk, const int* __restrict__ ts, int C, int off,
    int base, int width, int i, const int* __restrict__ h0,
    const int* __restrict__ keys, int P, const uint8_t* present) {
  const bool there = off < width ? present[i] != 0
                                 : pi_present(tk, ts, C, h0[i], keys[i], P);
  if (!there) atomicAdd(&PI_HCNT[off - base], 1);
}

// The slots of [base, base + P - 1) that the halo's groups (counted by
// pi_halo_count, highest first) take, bit j for slot base + j; warp 0 runs
// the groups, most halos have none.  Every thread calls it: it ends with a
// barrier.
__device__ u64 pi_halo(const int* __restrict__ ts, int C, int a, int base,
                       int P) {
  __shared__ u64 h_taken;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, *cnt = PI_HCNT;
    u64 nz = (u64)__ballot_sync(0xffffffffu, lane < P - 1 && cnt[lane]) |
             ((u64)__ballot_sync(0xffffffffu,
                                 lane + 32 < P - 1 && cnt[lane + 32])
              << 32);
    const u64 full = pi_full(P);
    const int hb = pi_wrap(a, base, C);
    u64 taken = 0;
    int prev = -1;
    while (nz) {
      const int d = 63 - __clzll((long long)nz);
      nz &= ~(1ull << d);
      if (prev >= 0) taken <<= prev - d;
      bool unused;
      const u64 f = pi_warp_window(ts, ts, C, pi_wrap(hb, d, C), 0, P, false,
                                   &unused);
      taken |= pi_lowest(f & ~taken & full, min(cnt[d], P));
      prev = d;
    }
    if (lane == 0) h_taken = prev > 0 ? taken << prev : taken;
  }
  __syncthreads();
  return h_taken;
}

// The first index of [0, j] whose entry has offset `off` (the entries are
// sorted), and 1 + the last index of [j, n).
__device__ __forceinline__ int pi_lower(const u64* srt, int j, int off) {
  int lo = 0, hi = j;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if ((int)(srt[m] >> 32) < off) lo = m + 1; else hi = m;
  }
  return lo;
}

__device__ __forceinline__ int pi_upper(const u64* srt, int j, int n,
                                        int off) {
  int lo = j, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if ((int)(srt[m] >> 32) <= off) lo = m + 1; else hi = m;
  }
  return lo;
}

// The greedy pass over the block's start slots [lo, hi) (local offsets
// (h0 - a) mod C) with their halo [hi, hi + P - 1): the range's pending
// queries are listed in batch order, the halo's counted.  The block's first
// pass (`root`, the whole range) lists every masked query of the range and
// proves its presence, and writes it; later passes list the pending ones.
// Returns false when more than PI_CAP queries are listed.
__device__ bool pi_range(const int* __restrict__ tk,
                         const int* __restrict__ ts, int C, int a,
                         int width, int lo, int hi, bool root, bool vec8,
                         const int* __restrict__ h0,
                         const int* __restrict__ keys,
                         const uint8_t* __restrict__ mask, int Q, int P,
                         uint8_t* present, int* __restrict__ slot,
                         int* scan) {
  u64* ent = PI_ENT;                    // (offset << 32 | list position)
  u64* srt = PI_SRT;                            // ent sorted
  int* first = PI_FIRST;                        // the group's first entry
  int* gend = PI_GEND;                          // 1 + the group's last
  const int ext = hi + P - 1;
  for (int d = threadIdx.x; d < PI_MAX_WINDOW; d += PI_THREADS)
    PI_HCNT[d] = 0;
  __syncthreads();

  // 1. list the pending queries of [lo, hi) in batch order; count the
  //    halo's
  int n = 0;
  for (int base = 0; base < Q && n <= PI_CAP;
       base += PI_THREADS * PI_PER_THREAD) {
    const int i0 = base + threadIdx.x * PI_PER_THREAD;
    // the thread's eight start slots and mask bytes, as two 16-byte and
    // one 8-byte load where the batch allows (`vec8`)
    int o[PI_PER_THREAD];
    bool m[PI_PER_THREAD];
    if (vec8 && i0 + PI_PER_THREAD <= Q) {
      const int4 x = *reinterpret_cast<const int4*>(h0 + i0);
      const int4 y = *reinterpret_cast<const int4*>(h0 + i0 + 4);
      const uint2 z = *reinterpret_cast<const uint2*>(mask + i0);
      o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
      o[4] = y.x; o[5] = y.y; o[6] = y.z; o[7] = y.w;
#pragma unroll
      for (int k = 0; k < PI_PER_THREAD; ++k)
        m[k] = ((k < 4 ? z.x : z.y) >> (8 * (k & 3))) & 0xFFu;
    } else {
#pragma unroll
      for (int k = 0; k < PI_PER_THREAD; ++k) {
        o[k] = i0 + k < Q ? h0[i0 + k] : -1;
        m[k] = i0 + k < Q && mask[i0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < PI_PER_THREAD; ++k) {
      if (o[k] >= 0) {
        o[k] -= a;
        if (o[k] < 0) o[k] += C;
        if (o[k] < lo || o[k] >= ext) o[k] = -1;
      }
    }
    int c = 0;
#pragma unroll
    for (int k = 0; k < PI_PER_THREAD; ++k) {
      const int i = i0 + k, off = o[k];
      o[k] = -1;
      if (off < 0) continue;
      if (!m[k]) {
        if (root && off < hi) {         // unmasked
          present[i] = 0;
          slot[i] = -1;
        }
        continue;
      }
      if (off >= hi) {
        pi_halo_count(tk, ts, C, off, hi, width, i, h0, keys, P, present);
        continue;
      }
      if (root || !present[i]) {       // presence below, or known
        o[k] = off;
        ++c;
      }
    }
    int total;
    int pos = n + pi_block_scan(c, scan, &total);
#pragma unroll
    for (int k = 0; k < PI_PER_THREAD; ++k)
      if (o[k] >= 0) {
        if (pos < PI_CAP) {
          ent[pos] = ((u64)o[k] << 32) | (unsigned)pos;
          PI_QIDX[pos] = i0 + k;
        }
        ++pos;
      }
    n += total;
  }
  // 2. what the halo takes of [hi, hi + P - 1); its barrier also ends 1
  //    (no thread still writes the list, which pi_hot_slot reuses)
  const u64 halo = pi_halo(ts, C, a, hi, P);
  __shared__ int n_pend;
  if (n > PI_CAP) {
    // the list stopped early: the first pass writes the outputs of the
    // range's unmasked and present queries, and the presence the later
    // passes read
    if (root)
      for (int i = threadIdx.x; i < Q; i += PI_THREADS) {
        int off = h0[i] - a;
        if (off < 0) off += C;
        if (off < lo || off >= hi) continue;
        const bool there =
            mask[i] && pi_present(tk, ts, C, h0[i], keys[i], P);
        present[i] = there ? 1 : 0;
        if (!mask[i] || there) slot[i] = -1;
      }
    return false;
  }
  // 3. a warp a listed query reads its window: the free slots, and in the
  //    first pass the presence (the present ones leave the list: their
  //    key sorts last)
  if (threadIdx.x == 0) n_pend = 0;
  __syncthreads();
  for (int j = threadIdx.x >> 5; j < n; j += PI_THREADS >> 5) {
    const u64 e = ent[j];
    const int i = PI_QIDX[j];
    bool there = false;
    const u64 f = pi_warp_window(tk, ts, C, pi_wrap(a, (int)(e >> 32), C),
                                 root ? keys[i] : 0, P, root, &there);
    if ((threadIdx.x & 31) == 0) {
      PI_WMASK[j] = f;
      if (root) present[i] = there ? 1 : 0;
      if (there) {
        slot[i] = -1;
        ent[j] = PI_NONE;
      } else {
        atomicAdd(&n_pend, 1);
      }
    }
  }
  __syncthreads();
  const int np = n_pend;

  // 4. sort by (offset, list position): a rank by counting when each entry
  //    has a thread, else a bitonic sort
  if (n <= PI_THREADS) {
    if (threadIdx.x < n && ent[threadIdx.x] != PI_NONE) {
      const u64 e = ent[threadIdx.x];
      int r = 0;
      for (int k = 0; k < n; ++k) r += ent[k] < e;
      srt[r] = e;
    }
    __syncthreads();
  } else {
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (int j = threadIdx.x; j < n2; j += PI_THREADS)
      srt[j] = j < n ? ent[j] : PI_NONE;
    __syncthreads();
    for (int k = 2; k <= n2; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < (n2 >> 1); t += PI_THREADS) {
          const int x = 2 * t - (t & (j - 1)), y = x + j;
          const u64 ex = srt[x], ey = srt[y];
          if ((ex > ey) == ((x & k) == 0)) {
            srt[x] = ey;
            srt[y] = ex;
          }
        }
        __syncthreads();
      }
  }

  // 5. groups: each entry finds its group's first entry, a group's first
  //    entry its end (binary searches of the sorted list)
  for (int j = threadIdx.x; j < np; j += PI_THREADS) {
    const int off = (int)(srt[j] >> 32);
    const int f = pi_lower(srt, j, off);
    first[j] = f;
    if (f == j) gend[j] = pi_upper(srt, j, np, off);
  }
  __syncthreads();

  // 6. each cluster (groups less than P apart) from its top group down;
  //    `taken` holds the slots the groups above took, bit j = slot h + j;
  //    the top group of the range starts from what the halo took
  const u64 full = pi_full(P);
  u64* win = ent;                               // taken, a group
  for (int j = threadIdx.x; j < np; j += PI_THREADS) {
    if (first[j] != j) continue;
    const int g = gend[j], top = (int)(srt[j] >> 32);
    if (g < np && (int)(srt[g] >> 32) - top < P) continue;
    u64 taken = hi - top < PI_MAX_WINDOW ? halo << (hi - top) : 0;
    int cur = j;
    for (;;) {
      const int cnt = min(gend[cur] - cur, P);
      const u64 free = PI_WMASK[(unsigned)srt[cur]];
      const u64 t = pi_lowest(free & ~taken & full, cnt);
      win[cur] = t;
      taken |= t;
      if (cur == 0) break;
      const int nxt = first[cur - 1];
      const int d = (int)(srt[cur] >> 32) - (int)(srt[nxt] >> 32);
      if (d >= P) break;
      taken <<= d;
      cur = nxt;
    }
  }
  __syncthreads();

  // 7. the k-th member of a group takes its k-th slot
  for (int j = threadIdx.x; j < np; j += PI_THREADS) {
    const u64 e = srt[j];
    const int off = (int)(e >> 32), i = PI_QIDX[(unsigned)e];
    const int f = first[j], r = j - f;
    const u64 t = win[f];
    slot[i] = r < __popcll(t) ? pi_wrap(pi_wrap(a, off, C), pi_nth_bit(t, r),
                                        C)
                              : -1;
  }
  __syncthreads();
  return true;
}

// One start slot `o` with more pending queries than a block lists: they
// are counted, the halo's groups too, and o's pending queries are ranked
// in batch order in a second sweep.  `present` is the first pass's.
__device__ void pi_hot_slot(const int* __restrict__ ts, int C, int a,
                            int width, int o, const int* __restrict__ tk,
                            const int* __restrict__ h0,
                            const int* __restrict__ keys,
                            const uint8_t* __restrict__ mask, int Q, int P,
                            uint8_t* present, int* __restrict__ slot,
                            int* scan) {
  __shared__ int n_o;
  __shared__ u64 taken_o;
  if (threadIdx.x == 0) n_o = 0;
  for (int d = threadIdx.x; d < PI_MAX_WINDOW; d += PI_THREADS)
    PI_HCNT[d] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += PI_THREADS) {
    int off = h0[i] - a;
    if (off < 0) off += C;
    if (off < o || off >= o + P || !mask[i]) continue;
    if (off > o) {
      pi_halo_count(tk, ts, C, off, o + 1, width, i, h0, keys, P, present);
    } else if (!present[i]) {
      atomicAdd(&n_o, 1);
    }
  }
  __syncthreads();
  const u64 halo = pi_halo(ts, C, a, o + 1, P);
  if (threadIdx.x < 32) {
    bool unused;
    const u64 f = pi_warp_window(ts, ts, C, pi_wrap(a, o, C), 0, P, false,
                                 &unused);
    if (threadIdx.x == 0)
      taken_o = pi_lowest(f & ~(halo << 1) & pi_full(P), min(n_o, P));
  }
  __syncthreads();
  const u64 t = taken_o;
  const int nt = __popcll(t);
  int done = 0;
  for (int base = 0; base < Q; base += PI_THREADS) {
    const int i = base + threadIdx.x;
    bool mine = false;
    if (i < Q) {
      int off = h0[i] - a;
      if (off < 0) off += C;
      mine = off == o && mask[i] && !present[i];
    }
    int total;
    const int r = done + pi_block_scan(mine ? 1 : 0, scan, &total);
    if (mine)
      slot[i] = r < nt ? pi_wrap(pi_wrap(a, o, C), pi_nth_bit(t, r), C) : -1;
    done += total;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(PI_THREADS) probe_insert_resolve(
    int* tk0, int* ts0, int C, int W, bool vec8, const int* __restrict__ h0,
    const int* __restrict__ keys, const uint8_t* __restrict__ mask, int Q,
    int P, uint8_t* present, int* __restrict__ slot, int* tk2, int* ts2,
    const uint8_t* sel) {
  const PiTable tab = pi_table(tk0, tk0, ts0, tk2, tk2, ts2, sel, C, Q);
  const int* __restrict__ tk = tab.tk;
  const int* __restrict__ ts = tab.ts;
  h0 += tab.tq; keys += tab.tq; mask += tab.tq; present += tab.tq;
  slot += tab.tq;
  __shared__ int scan[33];
  __shared__ int stk[128][2], n_stk;
  const long long a64 = (long long)blockIdx.x * W;
  if (a64 >= C) return;
  const int a = (int)a64, width = (int)min((long long)W, C - a64);
  if (threadIdx.x == 0) {
    stk[0][0] = 0;
    stk[0][1] = width;
    n_stk = 1;
  }
  __syncthreads();
  bool root = true;
  while (n_stk > 0) {
    const int lo = stk[n_stk - 1][0], hi = stk[n_stk - 1][1];
    __syncthreads();
    if (threadIdx.x == 0) --n_stk;
    if (!pi_range(tk, ts, C, a, width, lo, hi, root, vec8, h0, keys, mask, Q,
                  P, present, slot, scan)) {
      if (hi - lo > 1) {
        if (threadIdx.x == 0) {
          const int mid = lo + (hi - lo) / 2;
          stk[n_stk][0] = lo;
          stk[n_stk][1] = mid;
          stk[n_stk + 1][0] = mid;
          stk[n_stk + 1][1] = hi;
          n_stk += 2;
        }
      } else {
        pi_hot_slot(ts, C, a, width, lo, tk, h0, keys, mask, Q, P, present,
                    slot, scan);
      }
    }
    root = false;
    __syncthreads();
  }
}

// Windows wider than 64 slots or than the table: the rounds themselves, in
// one block.  The table is written here, so it is read through plain (not
// read-only) loads.
__global__ void __launch_bounds__(PI_THREADS) probe_insert_lockstep(
    int* tk0, int* tv0, int* ts0, int C, const int* __restrict__ h0,
    const int* __restrict__ keys, const int* __restrict__ vals,
    const uint8_t* __restrict__ mask, int Q, int P,
    uint8_t* __restrict__ present, int* __restrict__ slot, int* tk2,
    int* tv2, int* ts2, const uint8_t* sel) {
  const PiTable tab = pi_table(tk0, tv0, ts0, tk2, tv2, ts2, sel, C, Q);
  int *tk = tab.tk, *tv = tab.tv, *ts = tab.ts;
  h0 += tab.tq; keys += tab.tq; vals += tab.tq; mask += tab.tq;
  present += tab.tq; slot += tab.tq;
  // the claim map of one chunk: 2048 (slot, lowest index) entries
  constexpr int M = 2 * PI_THREADS;
  int* mkey = (int*)dhash_smem;
  int* mval = mkey + M;
  for (int e = threadIdx.x; e < M; e += PI_THREADS) {
    mkey[e] = -1;
    mval[e] = INT_MAX;
  }
  for (int i = threadIdx.x; i < Q; i += PI_THREADS) {
    bool there = false;
    if (mask[i]) there = pi_present(tk, ts, C, h0[i], keys[i], P);
    present[i] = there ? 1 : 0;
    slot[i] = mask[i] && !there ? -2 : -1;
  }
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    int left = 0;
    for (int base = 0; base < Q; base += PI_THREADS) {
      const int i = base + threadIdx.x;
      int s = -1, e = -1;
      if (i < Q && slot[i] == -2) {
        s = (int)(((long long)h0[i] + p) % C);
        if (ts[s] == DHASH_LIVE) s = -1;
      }
      if (s >= 0) {            // bid: the chunk's lowest index wins s
        e = (int)(((unsigned)s * 0x9E3779B1u) >> 21);
        for (;;) {
          const int prev = atomicCAS(&mkey[e], -1, s);
          if (prev == -1 || prev == s) break;
          e = (e + 1) & (M - 1);
        }
        atomicMin(&mval[e], i);
      }
      __syncthreads();
      const bool won = s >= 0 && mval[e] == i;
      __syncthreads();
      if (won) {
        tk[s] = keys[i];
        tv[s] = vals[i];
        ts[s] = DHASH_LIVE;
        slot[i] = s;
        mkey[e] = -1;
        mval[e] = INT_MAX;
      }
      if (i < Q && slot[i] == -2) left = 1;
      __syncthreads();
    }
    if (!__syncthreads_or(left)) break;
  }
  for (int i = threadIdx.x; i < Q; i += PI_THREADS)
    if (slot[i] == -2) slot[i] = -1;
}

__global__ void probe_insert_write(int* tk0, int* tv0, int* ts0, int C,
                                   const int* __restrict__ keys,
                                   const int* __restrict__ vals,
                                   const int* __restrict__ slot, int Q,
                                   uint8_t* __restrict__ okf, int* tk2,
                                   int* tv2, int* ts2, const uint8_t* sel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const PiTable tab = pi_table(tk0, tv0, ts0, tk2, tv2, ts2, sel, C, Q);
  int* __restrict__ tk = tab.tk;
  int* __restrict__ tv = tab.tv;
  int* __restrict__ ts = tab.ts;
  keys += tab.tq; vals += tab.tq; slot += tab.tq; okf += tab.tq;
  const int s = slot[i];
  okf[i] = s >= 0 ? 1 : 0;
  if (s >= 0) {
    tk[s] = keys[i];
    tv[s] = vals[i];
    ts[s] = DHASH_LIVE;
  }
}

// dynamic shared memory opted in, for each device that has launched
#define PI_MAX_DEVICES 64
static bool g_opted[PI_MAX_DEVICES];

// The blocks of the greedy path: one a 64 queries (at most one an SM), and
// enough that a range and its halo never wrap: W = ceil(C / blocks) <= C -
// P + 1.
static inline int pi_blocks(int C, int Q, int P, int sms) {
  int b = (Q + 63) / 64;
  if (b > sms) b = sms;
  const long long room = C - P + 1;
  const int need = (int)((C + room - 1) / room);
  return b > need ? b : need;
}

extern "C" int dhash_probe_insert(int* tk, int* tv, int* ts, int C,
                                  const int* h0, const int* keys,
                                  const int* vals, const uint8_t* mask,
                                  int Q, int max_probes, uint8_t* okf,
                                  uint8_t* present, int* slot, int T,
                                  int* tk2, int* tv2, int* ts2,
                                  const uint8_t* sel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T < 1 || T > 65535 || (sel != nullptr && (!tk2 || !tv2 || !ts2)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = dhash_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= PI_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!g_opted[dev]) {
    e = cudaFuncSetAttribute(probe_insert_resolve,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PI_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    g_opted[dev] = true;
  }
  if (max_probes >= 1 && max_probes <= PI_MAX_WINDOW && max_probes <= C) {
    const int blocks = pi_blocks(C, Q, max_probes, (sms + T - 1) / T);
    const int W = (int)(((long long)C + blocks - 1) / blocks);
    // every row's start slots and mask bytes aligned as the first row's
    const bool vec8 = (uintptr_t)h0 % 16 == 0 && (uintptr_t)mask % 8 == 0 &&
                      (T == 1 || Q % 8 == 0);
    probe_insert_resolve<<<dim3(blocks, T), PI_THREADS, PI_SMEM_BYTES, s>>>(
        tk, ts, C, W, vec8, h0, keys, mask, Q, max_probes, present, slot,
        tk2, ts2, sel);
  } else {
    probe_insert_lockstep<<<dim3(1, T), PI_THREADS, 2 * PI_THREADS * 2 * 4,
                            s>>>(tk, tv, ts, C, h0, keys, vals, mask, Q,
                                 max_probes, present, slot, tk2, tv2, ts2,
                                 sel);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  probe_insert_write<<<dim3((Q + 255) / 256, T), 256, 0, s>>>(
      tk, tv, ts, C, keys, vals, slot, Q, okf, tk2, tv2, ts2, sel);
  return (int)cudaGetLastError();
}

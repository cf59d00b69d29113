// epoch_swap: the epoch swap and the next rebuild's start, guarded on the
// device, in place.
//
// Replaces no Pallas kernel: the reference computes both as XLA code inside
// its jitted engine step (src/repro/core/dhash.py, finish_same_shape: a
// jnp.where on `done` over every leaf of both tables and the scalars; and
// rebuild_autostart: lax.cond(rebuilding) around clearing the standby,
// reseeding its hash function from the epoch counter and freezing the old
// table).  Eager PyTorch would branch on the host for both; here the
// exchange reads two device flags, go[0] = swap and go[1] = start:
//
//   swap  = swap_on && rebuilding && cursor >= capacity && no hazard entry
//           live                                    (rebuild_done)
//   start = start_on && (swap || !rebuilding)       (the autostart's cond)
//
// An engine's rebuild-epoch step takes them from its transition launch
// (extract.cu decides them after the scan); a caller with no transition in
// its step has this entry point decide them first (epoch_flags_kernel, one
// block), then exchange.
//
// When `swap` is set, the contents of every tensor leaf of the old and the
// new table change places (key, value, state, the hash seeds; for a chain
// arena also links, heads, free stack and segment offsets), so that the
// state's two table containers keep their tensors; cursor, lookups and
// expensive go to 0, rebuilding falls and the epoch counter rises, as
// finish_same_shape resets them.  When `start` is set, the standby (the new
// table after the swap) is cleared as the backend's `clear` clears it,
// each of its hash functions is reseeded from epoch + 1 (the epoch after
// the swap) plus its salt offset, as hashing.reseed does, and rebuilding
// rises with the cursor at 0.  Chain's freeze of the old arena at a start
// is the caller's (a chain_compact launch guarded on `go[1]`).
//
// Bound: bytes, once an epoch; launch latency on every other step.  The
// exchange reads only what its outcome needs — swap and start: a <- b,
// b <- fill (reads b); start alone: b <- fill (reads nothing); swap alone:
// a <-> b (reads both) — and moves 16-byte words (a scalar loop takes a
// leaf's tail past its last whole word, and a leaf whose two tensors are
// not both 16-byte aligned), four words a thread an iteration, with 1024
// threads an SM (64 KiB in flight an SM; an idle launch starts no more
// warps than a two-kernel design of 256-thread blocks did).  Block 0
// handles the hash seeds (a few words; the reseed needs the epoch, so the
// same block moves the scalars after a barrier).  On an idle step every
// block reads go and returns: one launch.  It is launched as a
// programmatic dependent (its blocks may start while the transition block
// ahead of it runs, and wait in griddepcontrol.wait until that grid has
// finished and its writes are visible).
//
// A table stack: T tables in one call, each on its own row: leaves [T, n]
// (a leaf's n elements a table), scalars and flags [T], hazard flags
// [T, chunk], go [T, 2].  Each table decides, exchanges, clears and
// reseeds on its own go row; its reseed salt is its own epoch + 1 and its
// own seeds, so the tables keep distinct hash functions after every epoch.
// Table t's exchange runs on grid row blockIdx.y = t (the decision on
// block t), with at most 2 SMs' worth of blocks / T a row.  One table is
// T = 1.
#include "dhash_common.cuh"

#define EPOCH_MAX_LEAVES 16
#define EPOCH_THREADS 512
#define EPOCH_BLOCKS_PER_SM 2
#define EPOCH_UNROLL 4

// leaf modes: what the clear writes into the standby's words
#define EPOCH_FILL 0        // int32 words, the constant `fill`
#define EPOCH_DESC 1        // int32 words, n - 1 - i (a chain free stack)
#define EPOCH_SEEDS 2       // int64 seed words, reseeded with salt offset fill
#define EPOCH_SEEDS_MS 3    // the same, multiply_shift: word 0 made odd

struct EpochLeaves {
  void* a[EPOCH_MAX_LEAVES];       // the old table's leaf
  void* b[EPOCH_MAX_LEAVES];       // the new table's leaf, same shape
  long long n[EPOCH_MAX_LEAVES];   // elements
  int mode[EPOCH_MAX_LEAVES];
  int fill[EPOCH_MAX_LEAVES];
  int count;
};

__global__ void epoch_flags_kernel(const uint8_t* __restrict__ hl, int chunk,
                                   const int* __restrict__ cursor,
                                   const uint8_t* __restrict__ rebuilding,
                                   long long capacity, int swap_on,
                                   int start_on, uint8_t* __restrict__ go) {
  const int t = blockIdx.x;         // the table
  hl += (long long)t * chunk;
  cursor += t;
  rebuilding += t;
  go += 2 * t;
  int any = 0;
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) any |= hl[j];
  const int live = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    const bool rb = rebuilding[0] != 0;
    const bool swap = swap_on && rb && (long long)cursor[0] >= capacity &&
                      !live;
    const bool start = start_on && (swap || !rb);
    go[0] = swap ? 1 : 0;
    go[1] = start ? 1 : 0;
  }
}

// what the clear writes at word i of a leaf of n words
__device__ __forceinline__ int epoch_clear(int mode, int fill, long long n,
                                           long long i) {
  return mode == EPOCH_DESC ? (int)(n - 1 - i) : fill;
}

__device__ __forceinline__ int4 epoch_clear4(int mode, int fill, long long n,
                                             long long w) {
  const long long i = 4 * w;
  return make_int4(epoch_clear(mode, fill, n, i),
                   epoch_clear(mode, fill, n, i + 1),
                   epoch_clear(mode, fill, n, i + 2),
                   epoch_clear(mode, fill, n, i + 3));
}

// one int32 leaf: words [first, n4) as int4 with stride `stride`, then the
// scalar tail [4 n4, n)
__device__ __forceinline__ void epoch_leaf(int* __restrict__ a,
                                           int* __restrict__ b, long long n,
                                           int mode, int fill, bool swap,
                                           bool start, long long first,
                                           long long stride) {
  const bool vec = (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  int4* a4 = reinterpret_cast<int4*>(a);
  int4* b4 = reinterpret_cast<int4*>(b);
  long long w = first;
  if (swap && start) {                         // a <- b, b <- clear
    for (; w + (EPOCH_UNROLL - 1) * stride < n4; w += EPOCH_UNROLL * stride) {
      int4 x[EPOCH_UNROLL];
#pragma unroll
      for (int u = 0; u < EPOCH_UNROLL; ++u) x[u] = b4[w + u * stride];
#pragma unroll
      for (int u = 0; u < EPOCH_UNROLL; ++u) {
        a4[w + u * stride] = x[u];
        b4[w + u * stride] = epoch_clear4(mode, fill, n, w + u * stride);
      }
    }
    for (; w < n4; w += stride) {
      a4[w] = b4[w];
      b4[w] = epoch_clear4(mode, fill, n, w);
    }
  } else if (swap) {                           // a <-> b
    for (; w + (EPOCH_UNROLL - 1) * stride < n4; w += EPOCH_UNROLL * stride) {
      int4 x[EPOCH_UNROLL], y[EPOCH_UNROLL];
#pragma unroll
      for (int u = 0; u < EPOCH_UNROLL; ++u) {
        x[u] = a4[w + u * stride];
        y[u] = b4[w + u * stride];
      }
#pragma unroll
      for (int u = 0; u < EPOCH_UNROLL; ++u) {
        a4[w + u * stride] = y[u];
        b4[w + u * stride] = x[u];
      }
    }
    for (; w < n4; w += stride) {
      const int4 x = a4[w];
      a4[w] = b4[w];
      b4[w] = x;
    }
  } else {                                     // b <- clear
    for (; w < n4; w += stride) b4[w] = epoch_clear4(mode, fill, n, w);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    if (swap) {
      const int bv = b[i];
      b[i] = start ? epoch_clear(mode, fill, n, i) : a[i];
      a[i] = bv;
    } else {
      b[i] = epoch_clear(mode, fill, n, i);
    }
  }
}

__global__ void __launch_bounds__(EPOCH_THREADS, EPOCH_BLOCKS_PER_SM)
epoch_swap_kernel(EpochLeaves L, const uint8_t* __restrict__ go, int* cursor,
                  uint8_t* rebuilding, int* epoch, int* lookups,
                  int* expensive) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int t = blockIdx.y;         // the table
  go += 2 * t;
  const bool swap = go[0] != 0, start = go[1] != 0;
  if (!swap && !start) return;
  cursor += t; rebuilding += t; epoch += t; lookups += t; expensive += t;
  if (blockIdx.x == 0) {
    // the hash seeds: a few words each, this block only
    const uint32_t salt = (uint32_t)(epoch[0] + (swap ? 2 : 1));
    for (int l = 0; l < L.count; ++l) {
      if (L.mode[l] != EPOCH_SEEDS && L.mode[l] != EPOCH_SEEDS_MS) continue;
      long long* a = (long long*)L.a[l] + t * L.n[l];
      long long* b = (long long*)L.b[l] + t * L.n[l];
      for (long long i = threadIdx.x; i < L.n[l]; i += blockDim.x) {
        const long long av = a[i], bv = b[i];
        const long long mid = swap ? av : bv;
        if (swap) a[i] = bv;
        if (start) {
          uint32_t w = dhash_reseed_word((uint32_t)mid,
                                         salt + (uint32_t)L.fill[l],
                                         (uint32_t)i);
          if (L.mode[l] == EPOCH_SEEDS_MS && i == 0) w |= 1u;
          b[i] = (long long)w;
        } else {
          b[i] = mid;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (swap) {
        epoch[0] += 1;
        lookups[0] = 0;
        expensive[0] = 0;
      }
      cursor[0] = 0;
      rebuilding[0] = start ? 1 : 0;
    }
    return;
  }
  const long long stride = (long long)(gridDim.x - 1) * blockDim.x;
  const long long first = (long long)(blockIdx.x - 1) * blockDim.x +
                          threadIdx.x;
  for (int l = 0; l < L.count; ++l) {
    const int mode = L.mode[l];
    if (mode == EPOCH_SEEDS || mode == EPOCH_SEEDS_MS) continue;
    epoch_leaf((int*)L.a[l] + t * L.n[l], (int*)L.b[l] + t * L.n[l],
               L.n[l], mode, L.fill[l], swap, start, first, stride);
  }
}

// `desc` holds count rows of five int64 words: old leaf pointer, new leaf
// pointer, elements (a table's), mode, fill (the constant, or the seeds'
// salt offset); the leaves, scalars and flags hold T tables' rows.
// With `hl` given this call decides go first (epoch_flags_kernel, from the
// hazard flags, cursor and rebuilding, swap_on and start_on), then
// exchanges; with `hl` null it exchanges on the go it is given.
extern "C" int dhash_epoch_swap(const long long* desc, int count,
                                const uint8_t* hl, int chunk, int* cursor,
                                uint8_t* rebuilding, int* epoch, int* lookups,
                                int* expensive, long long capacity,
                                int swap_on, int start_on, uint8_t* go,
                                int T, void* stream) {
  if (count < 0 || count > EPOCH_MAX_LEAVES || T < 1 || T > 65535)
    return (int)cudaErrorInvalidValue;
  EpochLeaves L;
  L.count = count;
  long long most = 0;
  for (int l = 0; l < count; ++l) {
    L.a[l] = (void*)desc[5 * l];
    L.b[l] = (void*)desc[5 * l + 1];
    L.n[l] = desc[5 * l + 2];
    L.mode[l] = (int)desc[5 * l + 3];
    L.fill[l] = (int)desc[5 * l + 4];
    if (L.mode[l] < EPOCH_FILL || L.mode[l] > EPOCH_SEEDS_MS)
      return (int)cudaErrorInvalidValue;
    if (L.n[l] > most) most = L.n[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (hl != nullptr) {
    epoch_flags_kernel<<<T, 1024, 0, s>>>(hl, chunk, cursor, rebuilding,
                                          capacity, swap_on, start_on, go);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0;
  e = dhash_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // block 0 of a row for the seeds, then enough blocks for the largest
  // leaf's 16-byte words, at most EPOCH_BLOCKS_PER_SM an SM over all rows
  long long want = (most / 4 + (long long)EPOCH_THREADS * EPOCH_UNROLL - 1) /
                   ((long long)EPOCH_THREADS * EPOCH_UNROLL);
  if (want > (long long)EPOCH_BLOCKS_PER_SM * sms / T)
    want = (long long)EPOCH_BLOCKS_PER_SM * sms / T;
  if (want < 1) want = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)want + 1, T);
  cfg.blockDim = dim3(EPOCH_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, epoch_swap_kernel, L, (const uint8_t*)go,
                         cursor, rebuilding, epoch, lookups, expensive);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

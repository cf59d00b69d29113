// epoch_swap: the epoch swap and the next rebuild's start, guarded on the
// device, in place.
//
// Replaces no Pallas kernel: the reference computes both as XLA code inside
// its jitted engine step (src/repro/core/dhash.py, finish_same_shape: a
// jnp.where on `done` over every leaf of both tables and the scalars; and
// rebuild_autostart: lax.cond(rebuilding) around clearing the standby,
// reseeding its hash function from the epoch counter and freezing the old
// table).  Eager PyTorch would branch on the host for both; this launch lets
// an engine step decide on the device:
//
//   swap  = swap_on && rebuilding && cursor >= capacity && no hazard entry
//           live                                    (rebuild_done)
//   start = start_on && (swap || !rebuilding)       (the autostart's cond)
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
// Two kernels in one call: one block decides and writes go[0] = swap and
// go[1] = start, then the exchange.  Its block 0 handles the hash seeds
// (a few words; the reseed needs the epoch, so the same block moves the
// scalars after a barrier) and the others walk the table leaves.  On a step
// with neither flag set, every block returns at once: the cost is the two
// launches.
//
// Bound: bytes, once an epoch — read the new table, write both (a table of
// 3 x 2^21 int32 words is 24 MiB, so about 72 MiB, ~21 us at 3.35 TB/s);
// on every other step, launch latency.
#include "dhash_common.cuh"

#define EPOCH_MAX_LEAVES 16
#define EPOCH_THREADS 256

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

__global__ void __launch_bounds__(EPOCH_THREADS) epoch_swap_kernel(
    EpochLeaves L, const uint8_t* __restrict__ go, int* cursor,
    uint8_t* rebuilding, int* epoch, int* lookups, int* expensive) {
  const bool swap = go[0] != 0, start = go[1] != 0;
  if (!swap && !start) return;
  if (blockIdx.x == 0) {
    // the hash seeds: a few words each, this block only
    const uint32_t salt = (uint32_t)(epoch[0] + (swap ? 2 : 1));
    for (int l = 0; l < L.count; ++l) {
      if (L.mode[l] != EPOCH_SEEDS && L.mode[l] != EPOCH_SEEDS_MS) continue;
      long long* a = (long long*)L.a[l];
      long long* b = (long long*)L.b[l];
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
    int* a = (int*)L.a[l];
    int* b = (int*)L.b[l];
    const long long n = L.n[l];
    const int fill = L.fill[l];
    for (long long i = first; i < n; i += stride) {
      const int av = a[i], bv = b[i];
      const int mid = swap ? av : bv;
      if (swap) a[i] = bv;
      b[i] = start ? (mode == EPOCH_DESC ? (int)(n - 1 - i) : fill) : mid;
    }
  }
}

// `desc` holds count rows of five int64 words: old leaf pointer, new leaf
// pointer, elements, mode, fill (the constant, or the seeds' salt offset).
extern "C" int dhash_epoch_swap(const long long* desc, int count,
                                const uint8_t* hl, int chunk, int* cursor,
                                uint8_t* rebuilding, int* epoch, int* lookups,
                                int* expensive, long long capacity,
                                int swap_on, int start_on, uint8_t* go,
                                void* stream) {
  if (count < 0 || count > EPOCH_MAX_LEAVES) return (int)cudaErrorInvalidValue;
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
  epoch_flags_kernel<<<1, 1024, 0, s>>>(hl, chunk, cursor, rebuilding,
                                        capacity, swap_on, start_on, go);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = dhash_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // block 0 for the seeds, then enough blocks for the largest leaf, at most
  // four an SM
  long long want = (most + EPOCH_THREADS - 1) / EPOCH_THREADS;
  if (want > 4LL * sms) want = 4LL * sms;
  if (want < 1) want = 1;
  epoch_swap_kernel<<<(int)want + 1, EPOCH_THREADS, 0, s>>>(
      L, go, cursor, rebuilding, epoch, lookups, expensive);
  return (int)cudaGetLastError();
}

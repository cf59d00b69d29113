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

// Shared-memory bytes of a staged hazard buffer: key and val as int32, live
// as bytes rounded up to whole words.
static inline size_t dhash_hazard_smem_bytes(int chunk) {
  return (size_t)chunk * 8 + (((size_t)chunk + 3) / 4) * 4;
}

// The hazard stage of both probe2 kernels.  The block copies the hazard
// buffer (key, val, live: 9 bytes an entry, 36 KiB at chunk = 4096) into
// dynamic shared memory `smem` once, laid out as chunk keys, chunk values,
// chunk live bytes, and finds 1 + the index of the last live entry, which it
// returns (`hz_end` is a __shared__ int of the caller).  Every thread of the
// block must call it: it holds two barriers.
__device__ __forceinline__ int dhash_hazard_stage(
    const int* __restrict__ hk, const int* __restrict__ hv,
    const uint8_t* __restrict__ hl, int chunk, int* smem, int* hz_end) {
  int* shk = smem;
  int* shv = smem + chunk;
  uint8_t* shl = (uint8_t*)(smem + 2 * chunk);
  if (threadIdx.x == 0) *hz_end = 0;
  __syncthreads();
  int my_end = 0;
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
    uint8_t l = hl[j];
    shk[j] = hk[j];
    shv[j] = hv[j];
    shl[j] = l;
    if (l) my_end = j + 1;
  }
  if (my_end) atomicMax(hz_end, my_end);
  __syncthreads();
  return *hz_end;
}

// The lowest live hazard index holding `key`, or -1, from the buffer that
// dhash_hazard_stage put into `smem`.  The scan stops at the first live
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

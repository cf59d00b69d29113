// extract: the rebuild chunk scan, one block.
//
// Replaces the TPU kernel _extract_kernel (src/repro/kernels/probe.py) and
// the MIGRATED scatter its wrapper applied afterwards.  Reads the `chunk`
// slots at `cursor` (a device scalar, read here — the host never sees it),
// ranks the LIVE ones with a block-wide exclusive scan, writes their keys and
// values compacted IN SLOT ORDER to the front of the hazard buffer, marks
// those slots MIGRATED in place, and writes the advanced cursor
// min(cursor + chunk, C).  Slots at or past C never migrate.
//
// Bound: bytes — in: the state of every slot of the chunk (chunk words), key
// and value of the LIVE slots only (2 words each) and the cursor; out: the
// hazard buffer (2 x chunk words and chunk bytes), the MIGRATED mark of each
// live slot and the cursor.  That is under 90 KiB at chunk = 4096, far below
// what one launch costs; the time is launch latency plus one pass of one
// block.  The design is therefore one
// block of 1024 threads, each owning a run of consecutive slots, one warp
// shuffle scan and one scan of the 32 warp totals in shared memory.
//
// Guard: the reference runs the scan behind lax.cond(rebuilding & ~pending)
// (src/repro/core/dhash.py, rebuild_extract).  Here the launch takes two
// device flags, `run` and `hold` (either may be null): the block returns at
// once unless run is set and hold is not, so an engine step launches the
// scan every step and never asks the host.  The outputs may be the state's
// own hazard buffer and `new_cursor` may be `cursor` itself: every thread
// reads the cursor before the first barrier, and it is written after the
// last.
#include "dhash_common.cuh"

#define EXTRACT_THREADS 1024
#define EXTRACT_MAX_ITEMS 4      // chunk <= 4096

__global__ void __launch_bounds__(EXTRACT_THREADS) extract_kernel(
    const int* __restrict__ tk, const int* __restrict__ tv,
    int* __restrict__ ts, int C, const int* cursor, int chunk,
    int* __restrict__ hk, int* __restrict__ hv, uint8_t* __restrict__ hl,
    int* new_cursor, const uint8_t* run, const uint8_t* hold) {
  __shared__ int warp_tot[EXTRACT_THREADS / 32];
  __shared__ int total_sh;
  if ((run != nullptr && !*run) || (hold != nullptr && *hold)) return;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int cur = cursor[0];
  const int ipt = (chunk + EXTRACT_THREADS - 1) / EXTRACT_THREADS;

  // each thread owns items [t*ipt, (t+1)*ipt) of the chunk
  bool live[EXTRACT_MAX_ITEMS];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < EXTRACT_MAX_ITEMS; ++k) {
    int j = t * ipt + k;
    long long pos = (long long)cur + j;
    live[k] = (k < ipt) && (j < chunk) && (pos < C) &&
              (ts[pos] == DHASH_LIVE);
    cnt += live[k] ? 1 : 0;
  }

  // block-wide exclusive scan of cnt
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int n = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += n;
    }
    warp_tot[lane] = wi - w;          // exclusive prefix of the warp totals
    if (lane == 31) total_sh = wi;
  }
  __syncthreads();
  int rank = warp_tot[warp] + incl - cnt;
  const int total = total_sh;

#pragma unroll
  for (int k = 0; k < EXTRACT_MAX_ITEMS; ++k) {
    if (live[k]) {
      long long pos = (long long)cur + t * ipt + k;
      hk[rank] = tk[pos];
      hv[rank] = tv[pos];
      ts[pos] = DHASH_MIGRATED;
      ++rank;
    }
  }
  // the tail of the hazard buffer is zero and not live
  for (int j = t; j < chunk; j += EXTRACT_THREADS) {
    hl[j] = (j < total) ? 1 : 0;
    if (j >= total) {
      hk[j] = 0;
      hv[j] = 0;
    }
  }
  if (t == 0) {
    long long nc = (long long)cur + chunk;
    new_cursor[0] = (int)(nc < C ? nc : C);
  }
}

extern "C" int dhash_extract(
    const int* tk, const int* tv, int* ts, int C, const int* cursor,
    int chunk, int* hk, int* hv, uint8_t* hl, int* new_cursor,
    const uint8_t* run, const uint8_t* hold, void* stream) {
  if (chunk > EXTRACT_THREADS * EXTRACT_MAX_ITEMS)
    return (int)cudaErrorInvalidValue;
  extract_kernel<<<1, EXTRACT_THREADS, 0, (cudaStream_t)stream>>>(
      tk, tv, ts, C, cursor, chunk, hk, hv, hl, new_cursor, run, hold);
  return (int)cudaGetLastError();
}

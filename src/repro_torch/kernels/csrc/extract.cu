// extract: the rebuild step's one transition launch, one block.
//
// Replaces the TPU kernel _extract_kernel (src/repro/kernels/probe.py) and
// the MIGRATED scatter its wrapper applied afterwards; in its transition
// form also what the reference's rebuild step computes around it as XLA
// code (src/repro/core/dhash.py: rebuild_step's
// lax.cond(hazard_live.any(), rebuild_land, rebuild_extract), the landing's
// keep mask, rebuild_done and rebuild_autostart's condition).  In order:
//
//  (a) the snapshot pending = any(hl), read before the buffer changes: one
//      transition a call, so a landing that empties the buffer does not
//      let the scan run in the same step (transition form);
//  (b) the landing's bookkeeping hl <- hl & ~ok & ~present, from the
//      landing insert's outputs, read only where hl is set (transition
//      form);
//  (c) the guarded chunk scan, where `run` is set and `hold` is not (in
//      the transition form `run` is the state's `rebuilding` and the hold
//      is the snapshot): the `chunk` slots at `cursor` (a device scalar,
//      read here — the host never sees it), LIVE ones ranked with a
//      block-wide exclusive scan, their keys and values written compacted
//      IN SLOT ORDER to the front of the hazard buffer, those slots marked
//      MIGRATED in place, the cursor advanced to min(cursor + chunk, C).
//      Slots at or past C never migrate;
//  (d) the epoch decision, where `go` is given (transition form):
//      live = total > 0 where the scan ran, else any(hl) after (b);
//      go[0] = swap  = swap_on && rebuilding && cursor' >= C && !live,
//      go[1] = start = start_on && (swap || !rebuilding),
//      for the exchange (epoch_swap.cu) and chain's freeze.  C, the flat
//      length of the scanned arrays, is the table's scan-order capacity.
//
// Bound: bytes — in: the hazard flags (chunk bytes), ok and present where
// a flag is set, the state of every slot of the chunk, key and value of
// the LIVE slots and the cursor; out: the hazard buffer, the MIGRATED marks
// and the cursor.  Under 100 KiB at chunk = 4096, far below what one launch
// costs: the time is launch latency plus a few dependent memory round
// trips of one block.  So the design cuts round trips, barriers and
// instructions: one block of 1024 threads, each owning four consecutive
// items (one 4-byte load of its flags, ok and present only where a flag is
// set, one 16-byte load of its four states, then its keys and values as
// two 16-byte loads issued together), one warp shuffle scan and one scan
// of the 32 warp totals in shared memory; a step that is not rebuilding,
// or a landing before the table's end, decides without a second barrier.
// (Loading the states, keys and values before the snapshot's barrier, and
// ok and present everywhere, was slower on a landing step and no faster on
// a scan: 48 KiB more through one SM.)  Where an address is not aligned
// (a cursor that is not a multiple of 4, a chunk below 4096, the partial
// last chunk) the thread takes its items one by one; both paths are the
// kernel.
//
// The launch lets the exchange queued behind it start (programmatic
// dependent launch: griddepcontrol.launch_dependents); the exchange waits
// for this grid to finish before it reads go.
//
// A table stack: T tables in one launch, one block a table (table t is
// block t), each on its own row of the stacked inputs: its table [T, C],
// cursor, flags run / hold / rebuilding, hazard buffer and ok / present
// [T, chunk], go [T, 2].  One table (T = 1) takes the kernel's STACK =
// false instance: the code it always was.
//
// In place: the outputs may be the state's own hazard buffer and
// `new_cursor` may be `cursor` itself: every thread reads the cursor before
// the first barrier, and it is written after the last; a thread writes the
// flags only of its own items in (b), and in (c) pending is false, so (b)
// wrote nothing.
#include "dhash_common.cuh"

#define EXTRACT_THREADS 1024
#define EXTRACT_ITEMS 4          // chunk <= 4096

// the flags of items [j0, j0 + ipt) as bits (bit k: item j0 + k)
__device__ __forceinline__ unsigned extract_bits(const uint8_t* __restrict__ p,
                                                 int j0, int ipt, int chunk) {
  if (ipt == EXTRACT_ITEMS && j0 + EXTRACT_ITEMS <= chunk &&
      ((uintptr_t)(p + j0) & 3) == 0) {
    const unsigned m = __vcmpne4(*reinterpret_cast<const uint32_t*>(p + j0),
                                 0u);
    return (m & 1u) | ((m >> 7) & 2u) | ((m >> 14) & 4u) | ((m >> 21) & 8u);
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < EXTRACT_ITEMS; ++k)
    if (k < ipt && j0 + k < chunk && p[j0 + k]) bits |= 1u << k;
  return bits;
}

__device__ __forceinline__ void extract_put_bits(uint8_t* __restrict__ p,
                                                 int j0, int ipt, int chunk,
                                                 unsigned bits) {
  if (ipt == EXTRACT_ITEMS && j0 + EXTRACT_ITEMS <= chunk &&
      ((uintptr_t)(p + j0) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p + j0) =
        (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) |
        ((bits & 8u) << 21);
    return;
  }
#pragma unroll
  for (int k = 0; k < EXTRACT_ITEMS; ++k)
    if (k < ipt && j0 + k < chunk) p[j0 + k] = (bits >> k) & 1u;
}

__device__ __forceinline__ bool extract_al16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

template <bool STACK>
__global__ void __launch_bounds__(EXTRACT_THREADS) extract_kernel(
    const int* __restrict__ tk, const int* __restrict__ tv,
    int* __restrict__ ts, int C, const int* cursor, int chunk,
    int* __restrict__ hk, int* __restrict__ hv, uint8_t* __restrict__ hl,
    int* new_cursor, const uint8_t* run, const uint8_t* hold,
    const uint8_t* __restrict__ ok, const uint8_t* __restrict__ present,
    uint8_t* __restrict__ go, int swap_on, int start_on) {
  __shared__ int warp_tot[EXTRACT_THREADS / 32];
  __shared__ int total_sh;
  asm volatile("griddepcontrol.launch_dependents;");
  if (STACK) {  // table `blockIdx.x` of the stack: its row of every array
    const int b = blockIdx.x;
    const long long tc = (long long)b * C, th = (long long)b * chunk;
    tk += tc; tv += tc; ts += tc;
    cursor += b; new_cursor += b;
    hk += th; hv += th; hl += th;
    if (run != nullptr) run += b;
    if (hold != nullptr) hold += b;
    if (ok != nullptr) ok += th;
    if (present != nullptr) present += th;
    if (go != nullptr) go += 2 * b;
  }
  const bool land = ok != nullptr;
  const bool rb = run == nullptr || *run != 0;
  if (!land && (!rb || (hold != nullptr && *hold != 0))) return;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int cur = cursor[0];
  const int ipt = (chunk + EXTRACT_THREADS - 1) / EXTRACT_THREADS;
  const int j0 = t * ipt;

  // (a) the snapshot (only a rebuilding step asks it: elsewhere nothing
  // scans), (b) the landing's bookkeeping
  bool scan = true;
  unsigned left = 0;                  // this thread's flags after (b)
  if (land) {
    const unsigned was = extract_bits(hl, j0, ipt, chunk);
    const bool pending = rb && __syncthreads_or(was != 0);
    if (was != 0) {
      left = was & ~extract_bits(ok, j0, ipt, chunk) &
             ~extract_bits(present, j0, ipt, chunk);
      if (left != was) extract_put_bits(hl, j0, ipt, chunk, left);
    }
    scan = rb && !pending;
  }

  // (c) the guarded chunk scan
  int total = 0;
  long long cur_after = cur;
  if (scan) {
    const long long base = (long long)cur + j0;
    const bool vec = ipt == EXTRACT_ITEMS && j0 + EXTRACT_ITEMS <= chunk &&
                     base + EXTRACT_ITEMS <= C && extract_al16(ts + base) &&
                     extract_al16(tk + base) && extract_al16(tv + base);
    int st[EXTRACT_ITEMS], key[EXTRACT_ITEMS], val[EXTRACT_ITEMS];
    unsigned live = 0;
    if (vec) {
      const int4 s = *reinterpret_cast<const int4*>(ts + base);
      st[0] = s.x; st[1] = s.y; st[2] = s.z; st[3] = s.w;
#pragma unroll
      for (int k = 0; k < EXTRACT_ITEMS; ++k)
        live |= (st[k] == DHASH_LIVE ? 1u : 0u) << k;
      if (live) {
        const int4 a = *reinterpret_cast<const int4*>(tk + base);
        const int4 b = *reinterpret_cast<const int4*>(tv + base);
        key[0] = a.x; key[1] = a.y; key[2] = a.z; key[3] = a.w;
        val[0] = b.x; val[1] = b.y; val[2] = b.z; val[3] = b.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < EXTRACT_ITEMS; ++k) {
        const long long pos = base + k;
        st[k] = (k < ipt && j0 + k < chunk && pos < C) ? ts[pos]
                                                       : DHASH_EMPTY;
        live |= (st[k] == DHASH_LIVE ? 1u : 0u) << k;
      }
#pragma unroll
      for (int k = 0; k < EXTRACT_ITEMS; ++k) {
        if ((live >> k) & 1u) {
          key[k] = tk[base + k];
          val[k] = tv[base + k];
        }
      }
    }
    const int cnt = __popc(live);

    // block-wide exclusive scan of cnt
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += n;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_tot[lane];
      int wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, wi, d);
        if (lane >= d) wi += n;
      }
      warp_tot[lane] = wi - w;        // exclusive prefix of the warp totals
      if (lane == 31) total_sh = wi;
    }
    __syncthreads();
    int rank = warp_tot[warp] + incl - cnt;
    total = total_sh;

#pragma unroll
    for (int k = 0; k < EXTRACT_ITEMS; ++k) {
      if ((live >> k) & 1u) {
        hk[rank] = key[k];
        hv[rank] = val[k];
        ++rank;
      }
    }
    if (live) {
      if (vec) {
        *reinterpret_cast<int4*>(ts + base) = make_int4(
            (live & 1u) ? DHASH_MIGRATED : st[0],
            (live & 2u) ? DHASH_MIGRATED : st[1],
            (live & 4u) ? DHASH_MIGRATED : st[2],
            (live & 8u) ? DHASH_MIGRATED : st[3]);
      } else {
#pragma unroll
        for (int k = 0; k < EXTRACT_ITEMS; ++k)
          if ((live >> k) & 1u) ts[base + k] = DHASH_MIGRATED;
      }
    }
    // this thread's items of the hazard buffer past the live entries: zero
    // and not live (the entries below `total` are the ranked writes above)
    unsigned below = 0;
#pragma unroll
    for (int k = 0; k < EXTRACT_ITEMS; ++k)
      below |= (j0 + k < total ? 1u : 0u) << k;
    extract_put_bits(hl, j0, ipt, chunk, below);
    if (ipt == EXTRACT_ITEMS && j0 >= total && j0 + EXTRACT_ITEMS <= chunk &&
        extract_al16(hk + j0) && extract_al16(hv + j0)) {
      *reinterpret_cast<int4*>(hk + j0) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(hv + j0) = make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int k = 0; k < EXTRACT_ITEMS; ++k) {
        const int j = j0 + k;
        if (k < ipt && j < chunk && j >= total) {
          hk[j] = 0;
          hv[j] = 0;
        }
      }
    }
    const long long nc = (long long)cur + chunk;
    cur_after = nc < C ? nc : C;
    if (t == 0) new_cursor[0] = (int)cur_after;
  }

  // (d) the epoch decision; a swap needs rebuilding and the cursor at the
  // end, so only such a step asks the flags left by (b)
  if (go != nullptr) {
    const bool live_after =
        scan ? total > 0
             : rb && cur_after >= (long long)C && __syncthreads_or(left != 0);
    if (t == 0) {
      const bool swap = swap_on && rb && cur_after >= (long long)C &&
                        !live_after;
      const bool start = start_on && (swap || !rb);
      go[0] = swap ? 1 : 0;
      go[1] = start ? 1 : 0;
    }
  }
}

// Two forms.  The extract form (ok, present and go null) is the guarded
// scan alone: run & ~hold (either may be null).  The transition form (ok
// and present given, run the state's rebuilding flag, hold null) takes the
// hold from its own snapshot and, with go, decides the epoch.
extern "C" int dhash_extract(
    const int* tk, const int* tv, int* ts, int C, const int* cursor,
    int chunk, int* hk, int* hv, uint8_t* hl, int* new_cursor,
    const uint8_t* run, const uint8_t* hold, const uint8_t* ok,
    const uint8_t* present, uint8_t* go, int swap_on, int start_on, int T,
    void* stream) {
  if (chunk < 1 || chunk > EXTRACT_THREADS * EXTRACT_ITEMS || T < 1)
    return (int)cudaErrorInvalidValue;
  const bool land = ok != nullptr;
  if (land != (present != nullptr) ||
      (land && (run == nullptr || hold != nullptr)) || (go && !land))
    return (int)cudaErrorInvalidValue;
  auto kernel = T > 1 ? extract_kernel<true> : extract_kernel<false>;
  kernel<<<T, EXTRACT_THREADS, 0, (cudaStream_t)stream>>>(
      tk, tv, ts, C, cursor, chunk, hk, hv, hl, new_cursor, run, hold, ok,
      present, go, swap_on, start_on);
  return (int)cudaGetLastError();
}

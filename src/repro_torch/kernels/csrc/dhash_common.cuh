// Shared definitions for the linear-backend kernels (Hopper, sm_90a).
//
// Tables are three int32 arrays of C slots (key, val, state); bool tensors
// arrive as one byte per element.  A probe sequence is h0, h0+1, ... wrapped
// at C by the thread itself, so the kernels read the table tensors in place:
// there is no padded copy, no query sort and no tile map.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define DHASH_EMPTY 0
#define DHASH_LIVE 1
#define DHASH_TOMB 2
#define DHASH_MIGRATED 3

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

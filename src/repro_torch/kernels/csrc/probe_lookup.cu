// probe_lookup: batched linear-probe lookup, one thread a query.
//
// Replaces the TPU kernel _probe_kernel (src/repro/kernels/probe.py), which
// sorted the queries by start slot and probed a two-block window of a padded
// table copy held in fast memory.  Here a thread gathers straight from global
// memory: a table of 2^21 slots (24 MiB) stays in the 50 MB L2, and a larger
// one costs one 32-byte sector of the state array and one of the key array a
// probe step.  Bound: bytes — a lookup touches a few scattered sectors and
// does one compare a step, so the time is that of the dependent gathers
// (state, then key, then value).  The design keeps enough threads in flight
// to hide that latency (one query a thread, 256 threads a block) and exits
// the probe loop at the first hit or EMPTY slot.  The hit's slot is emitted
// so that a delete is this kernel plus one scatter.
#include "dhash_common.cuh"

__global__ void probe_lookup_kernel(
    const int* __restrict__ tk, const int* __restrict__ tv,
    const int* __restrict__ ts, int C, const int* __restrict__ h0,
    const int* __restrict__ qk, int Q, int max_probes,
    uint8_t* __restrict__ found, int* __restrict__ val,
    int* __restrict__ loc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  int v, l;
  bool f = dhash_probe_one(tk, tv, ts, C, h0[i], qk[i], max_probes, &v, &l);
  found[i] = f ? 1 : 0;
  val[i] = v;
  loc[i] = l;
}

extern "C" int dhash_probe_lookup(
    const int* tk, const int* tv, const int* ts, int C, const int* h0,
    const int* qk, int Q, int max_probes, uint8_t* found, int* val, int* loc,
    void* stream) {
  const int threads = 256;
  int blocks = (Q + threads - 1) / threads;
  probe_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tk, tv, ts, C, h0, qk, Q, max_probes, found, val, loc);
  return (int)cudaGetLastError();
}

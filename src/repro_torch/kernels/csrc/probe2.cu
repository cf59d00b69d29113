// probe2: the rebuild-epoch ordered check in one pass, one thread a query.
//
// Replaces the TPU kernel _probe2_kernel (src/repro/kernels/probe.py): old
// table probe, then the hazard buffer, then the new table probe, with the
// priority old > hazard > new (the paper's Lemma 4.1).  The TPU version kept
// windows of both tables resident through a two-level tile map and merged
// partial results over a second grid axis; here both tables are gathered in
// place, so there is no tile map, no merge round and no `complete` output.
//
// Bound: operations, not bytes.  The hazard check compares a query with
// every live hazard entry: up to Q x chunk = 2.7e8 compares at Q = 65536,
// chunk = 4096, against a few scattered sectors a query for the two table
// probes.  The design cuts the compares three ways: a query the old table
// resolved skips the scan; the scan stops at the first live match (lowest
// hazard index, as argmax over the match mask gives); and it ends at the
// last live entry of the buffer, which the block finds while it stages the
// buffer into shared memory once (dhash_hazard_stage, shared with
// tc_probe2.cu).  Contract: chunk <= 4096 (the staged buffer fits the 48 KiB
// of shared memory a block gets without opting in), the same limit as the
// extract kernel that fills the buffer; a larger chunk is refused.
//
// Outputs: found, val, and the ordered-delete components f_old, loc_old
// (slot in the old table), hz_idx (hazard index, only where the old table
// did not resolve the query), loc_new (slot in the new table, only where
// neither the old table nor the hazard buffer resolved it); -1 = none.
#include "dhash_common.cuh"

__global__ void probe2_kernel(
    const int* __restrict__ ok, const int* __restrict__ ov,
    const int* __restrict__ os, int Co, const int* __restrict__ nk,
    const int* __restrict__ nv, const int* __restrict__ ns, int Cn,
    const int* __restrict__ hk, const int* __restrict__ hv,
    const uint8_t* __restrict__ hl, int chunk, const int* __restrict__ h0o,
    const int* __restrict__ h0n, const int* __restrict__ qk, int Q,
    int max_probes, uint8_t* __restrict__ found, int* __restrict__ val,
    uint8_t* __restrict__ f_old, int* __restrict__ loc_old,
    int* __restrict__ hz_idx, int* __restrict__ loc_new) {
  extern __shared__ int smem[];
  __shared__ int hz_end;   // 1 + index of the last live hazard entry
  const int n_hz = dhash_hazard_stage(hk, hv, hl, chunk, smem, &hz_end);

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int key = qk[i];
  int v, lo, hz = -1, ln = -1;
  bool fo = dhash_probe_one(ok, ov, os, Co, h0o[i], key, max_probes, &v, &lo);
  bool f = fo;
  if (!f) {
    hz = dhash_hazard_find(smem, chunk, n_hz, key, &v);
    f = hz >= 0;
  }
  if (!f) f = dhash_probe_one(nk, nv, ns, Cn, h0n[i], key, max_probes, &v, &ln);
  found[i] = f ? 1 : 0;
  val[i] = v;
  f_old[i] = fo ? 1 : 0;
  loc_old[i] = lo;
  hz_idx[i] = hz;
  loc_new[i] = ln;
}

extern "C" int dhash_probe2(
    const int* ok, const int* ov, const int* os, int Co, const int* nk,
    const int* nv, const int* ns, int Cn, const int* hk, const int* hv,
    const uint8_t* hl, int chunk, const int* h0o, const int* h0n,
    const int* qk, int Q, int max_probes, uint8_t* found, int* val,
    uint8_t* f_old, int* loc_old, int* hz_idx, int* loc_new, void* stream) {
  const int threads = 256;
  int blocks = (Q + threads - 1) / threads;
  if (chunk > DHASH_MAX_CHUNK) return (int)cudaErrorInvalidValue;
  probe2_kernel<<<blocks, threads, dhash_hazard_smem_bytes(chunk),
                  (cudaStream_t)stream>>>(
      ok, ov, os, Co, nk, nv, ns, Cn, hk, hv, hl, chunk, h0o, h0n, qk, Q,
      max_probes, found, val, f_old, loc_old, hz_idx, loc_new);
  return (int)cudaGetLastError();
}

// tc_lookup: batched two-row lookup (twochoice and cuckoo), one thread a
// query.
//
// Replaces the TPU kernel _tc_lookup_kernel (src/repro/kernels/probe.py,
// with its row probe _tc_row_probe) AND the recombine its wrapper did after
// it (src/repro/kernels/ops.py, twochoice_lookup).  The TPU version expanded
// every query into two entries (one per candidate row), sorted the 2Q entries
// by row, padded the table to whole row blocks and gathered from a window of
// two resident blocks a tile, flagging entries whose row escaped the window
// for a fallback pass; the wrapper then unsorted the entries and merged the
// two of each query with a-row priority.  Here a thread reads its query's two
// rows where they lie in global memory: a table of 2^18 x 8 slots (24 MiB)
// stays in the 50 MB L2.  Results come back in query order, one a query, with
// loc = row * W + lane, the flat slot.  Cuckoo tables use the same kernel
// with side-offset rows.
//
// Bound: bytes.  A query reads row a (its W states and W keys, one 32-byte
// sector each at W = 8) and, on a miss there, row b, then the value of a hit:
// dependent scattered gathers with one compare a lane.  The design issues
// each row as two 16-byte loads of the states and two of the keys when W is a
// multiple of 4 (one thread, no cross-lane shuffle), keeps 256 threads a
// block in flight to hide the latency, and skips row b after a hit in row a.
// The hit's slot is emitted so that a delete is this kernel plus one scatter.
#include "dhash_common.cuh"

template <bool VEC>
__global__ void tc_lookup_kernel(
    const int* __restrict__ tk, const int* __restrict__ tv,
    const int* __restrict__ ts, int W, const int* __restrict__ rows_a,
    const int* __restrict__ rows_b, const int* __restrict__ qk, int Q,
    uint8_t* __restrict__ found, int* __restrict__ val,
    int* __restrict__ loc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  int v, l;
  bool f = dhash_two_row_lookup<VEC>(tk, tv, ts, W, rows_a[i], rows_b[i],
                                     qk[i], &v, &l);
  found[i] = f ? 1 : 0;
  val[i] = v;
  loc[i] = l;
}

extern "C" int dhash_tc_lookup(
    const int* tk, const int* tv, const int* ts, int W, const int* rows_a,
    const int* rows_b, const int* qk, int Q, uint8_t* found, int* val,
    int* loc, void* stream) {
  if (W < 1 || W > DHASH_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (Q + threads - 1) / threads;
  if (dhash_rows_vec_ok(W, tk, ts))
    tc_lookup_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        tk, tv, ts, W, rows_a, rows_b, qk, Q, found, val, loc);
  else
    tc_lookup_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        tk, tv, ts, W, rows_a, rows_b, qk, Q, found, val, loc);
  return (int)cudaGetLastError();
}

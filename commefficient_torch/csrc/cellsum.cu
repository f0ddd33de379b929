// The ordered cell sum of the sparse re-encode, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. Its counterpart in the JAX package is XLA's
// scatter-add inside jax.ops.segment_sum (ops/circulant.py encode_vals_at
// and the hash sketch's sketch_encode_vals_at), which on the CPU adds a
// cell's addends in the order of idx. The card's index_add_ adds them in
// no fixed order, and the subtract rule and the zero rule's mask read the
// sums, so the port sums each cell in that order. Its plain version
// (ops/circulant_kernels.py cell_sum_plain) ranks the addends of each cell
// and adds rank t to every cell at once for t = 0, 1, ...; the number of
// ranks is read back to the host there. This kernel reads nothing back:
// it is what lets the split round's decode half run without a host sync.
//
// What it computes. The wrapper sorts the flat cells j c + bucket of the
// r k addends stably (torch.sort(..., stable=True)), giving sorted_cells
// and order; the (r, c) table is zeroed before the launch. Thread i takes
// position i of the sorted order. A position whose cell differs from the
// one before it starts a run of equal cells; its thread folds the run's
// addends, addends[order[i]], addends[order[i + 1]], ..., in that order
// into a float32 sum that starts from +0.0, exactly as table[at] + addend
// does in the plain loop (a lone -0.0 gives +0.0, as in segment_sum). Each
// add is a separate __fadd_rn, so nvcc can neither contract nor reorder
// it; NaN and inf pass through (as the card's one canonical NaN). The sum
// is written once, to table[cell]. No atomics: two calls give the same
// bits, and the bits of the CPU's plain version.
//
// What bounds it on an H100 SXM. Each position is read once (its cell and
// the one before it, 8 bytes each; its order index, 8 bytes; its addend,
// 4 bytes) and each run writes one float: about 5 MB at r k = 250,000
// (k = 50,000, r = 5), 1.5 us at 3.35 TB/s, so a launch's latency (a few
// microseconds) is most of its time. The addend reads are gathers through
// order, one 4-byte load each. The worst case, all k addends of a row in
// one cell, runs that run serially in one thread (k dependent adds, each
// behind its gather through order): correct and merely slow.
// The table's zeroing before the launch adds its 4 r c bytes (10 MB at
// c = 500,736). Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit
// (chip_smoke.py, the zeroing and the launch): 0.0110 ms at r k = 250,000
// random top-k coordinates, c = 500,736 (bound 0.0045 ms, bytes;
// index_add_ 0.0105 ms in no fixed order; the plain loop 0.54 ms with its
// host read), 0.51 ms with a run of 2,000 addends a row, 8.4 ms with all
// 50,000 of a row in one cell. 20 registers, no spills.
//
// Interface: plain C, loaded with ctypes. cell_sum launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cell_sum_kernel(const long long* __restrict__ sorted_cells,
                    const long long* __restrict__ order,
                    const float* __restrict__ addends, long long n,
                    float* __restrict__ table) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long cell = sorted_cells[i];
  if (i > 0 && sorted_cells[i - 1] == cell) return;   // not a run's head
  float sum = 0.0f;
  long long j = i;
#pragma unroll 4
  for (; j < n; ++j) {
    if (sorted_cells[j] != cell) break;
    sum = __fadd_rn(sum, addends[order[j]]);
  }
  table[cell] = sum;
}

}  // namespace

extern "C" int cell_sum(const long long* sorted_cells, const long long* order,
                        const float* addends, long long n, float* table,
                        void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cell_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sorted_cells, order, addends, n, table);
  return (int)cudaGetLastError();
}

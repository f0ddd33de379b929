// Circulant count sketch kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1 circ_encode <- pallas_encode, ops/circulant_pallas.py (JAX package)
//   K2 circ_decode <- pallas_decode, ops/circulant_pallas.py (JAX package)
//
// The vector of length d is viewed as m = ceil(d / c) blocks of length c,
// zero beyond d. Row j of the (r, c) table is
//
//   table[j, i] = sum_{b < m} sigma_j(b*c + u) * v[b*c + u],
//                 u = (i - s[j, b]) mod c,
//
// and the decode estimate of coordinate x = b*c + i is
//
//   est[x] = median_j sigma_j(x) * table[j, (i + s[j, b]) mod c],
//
// with sigma_j(x) = +1 or -1 from the top bit of
// fmix32(x * key_j + 0x9E3779B9) (murmur3 finalizer, uint32 arithmetic).
// The median is the bubble comparator network of ops/topk.py
// median_axis0, the mean of the two middle values for even r.
//
// Design. The Pallas kernels' wrap padding and 1024-aligned spans exist
// only to avoid TPU lane rotates; none of that is carried over. Any shift
// in [0, c) is accepted (aligned or not).
//
// What bounds both kernels on an H100 SXM. Each (row, coordinate) term
// needs its sign (x key + C, two shift-xors, two multiplies, the sign bit
// xor-ed into the value: 5 ALU instructions, 2 IMAD and one on either
// pipe; the finalizer's last h ^= h >> 16 cannot change bit 31 and is
// left out) and one index step, with its share of the loads and float
// adds: 10.4 instructions at r = 5 (chip_smoke.py SIGN_HASH and
// sketch_work). An SM issues 128 instructions a clock, 64 of them on the
// ALU and 64 on the IMAD pipe, at the clock of the data sheet's 67 TFLOP/s
// float32. At the GPT-2 shape (d = 92,138,496, c = 524,288, m = 176)
// issue bounds both, 0.143 ms for K1 and 0.140 ms for K2, above the bytes
// (0.116 and 0.113 ms); at the ResNet-9 shape (d = 6,568,640, c = 500,736,
// m = 14) the bytes do: 0.0138 and 0.0108 ms. Both kernels issue more than
// that (chip_smoke.py reads their SASS): a term of K1's walk about 15, 8 on
// the ALU (the shifted column's wrap test, select and add, the address);
// K2 about 34, 20 on the ALU, most in the NaN-propagating median network.
//
// K1: a persistent grid of 256-thread CTAs, as many as fit on the card at
// once (4 an SM). A CTA owns a tile of output columns for all r rows (4
// columns a thread for r <= 5, 2 above, strided by 256 so that neighbouring
// threads gather neighbouring elements of v) and keeps r sums a column in
// registers. It walks the blocks b = 0 .. m - 1 in ascending order with the
// (r, m) shifts staged in shared memory 128 blocks at a time. Since every
// CTA in flight walks b in step, the r gathers of block b come from one
// 4 c-byte slice of v that L2 holds: v is read from device memory once
// (368 MB at the GPT-2 shape), and the r reads of it are L2 hits (r x 4 d
// bytes of L2 traffic, 1.84 GB at the GPT-2 shape, not measured apart: the
// likely ceiling above the issue of K1's own SASS). When the column tiles
// outnumber the CTAs (c above about 540,000 at r <= 5) a CTA takes a
// second tile and v is read once per wave. The summation order is that of
// the plain version (and of pallas_encode), ascending b per cell, with no
// atomics, so the result is deterministic. The last block alone tests
// x < d. One launch computes table = [table +] encode(scale * v): the
// accumulate flag and the scale fold the fused client step's
// per-microbatch weighting into the launch.
//
// K2: one thread per output coordinate x < d. It gathers r table cells,
// applies the signs and takes the median in registers (the network is
// unrolled for a compile-time r). The 10 MB table stays in the 50 MB L2.
// Bytes: 4 r c read + 4 d written = 36.3 MB at the ResNet-9 shape.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit (chip_smoke.py,
// r = 5): K1 0.043 ms at m = 14 and 0.474 ms at m = 176 (32% and 30% of
// the bound); K2 0.057 and 0.760 ms (19% and 18%). ptxas (nvcc -Xptxas -v,
// sm_90a): the encode 63-64 registers for r >= 3 (55 at r = 2, 40 at
// r = 1) and 512 r bytes of shared memory, the decode 16-28 registers; no
// spills.
//
// Bitwise agreement with the plain PyTorch versions
// (ops/circulant_kernels.py): the float operations are written with
// __fmul_rn / __fadd_rn so that nvcc cannot contract them into FMAs, and
// they happen in the same order as in the plain versions. A sign is
// applied by flipping the sign bit, which is what negation does.
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // decode: threads a CTA
constexpr int kMaxRows = 8;
constexpr int kEncThreads = 256;       // encode: threads a CTA
constexpr int kEncCtasPerSm = 4;       // resident encode CTAs an SM
constexpr int kShiftChunk = 128;       // blocks whose shifts are staged

// Columns of a table tile a thread owns in the encode: its r sums a column
// stay in registers (at most 64 a thread for 4 CTAs an SM).
template <int R>
__host__ __device__ constexpr int enc_cols() {
  return R <= 5 ? 4 : 2;
}

// The sign bit of sigma_j(x): bit 31 of fmix32(x * key + 0x9E3779B9). The
// finalizer's last step, h ^= h >> 16, cannot change bit 31 and is left
// out.
__device__ __forceinline__ uint32_t sign_bit(uint32_t x, uint32_t key) {
  uint32_t h = x * key + 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h & 0x80000000u;
}

// sigma * a: negation flips the sign bit, nothing else
__device__ __forceinline__ float with_sign(float a, uint32_t bit) {
  return __uint_as_float(__float_as_uint(a) ^ bit);
}

// min/max that propagate NaN, as torch.minimum / jnp.minimum do (fminf
// alone would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// Add block b's terms to a thread's sums: for row j and column i the term
// sigma_j(x) * scale * v[x], x = b c + (i - s[j, b]) mod c. Only the last
// block, which may run past d, tests x < d (past d the vector is zero
// padding: sigma * 0 would add a signed zero, which leaves a sum that
// starts at +0 unchanged).
template <int R, int C, bool kTail>
__device__ __forceinline__ void encode_block(float (&acc)[R][C],
                                             const int (&col)[C],
                                             int (*sh)[kShiftChunk],
                                             const uint32_t (&key)[R],
                                             const float* __restrict__ v,
                                             uint32_t d, uint32_t c,
                                             uint32_t bc, int bb,
                                             float scale) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = sh[j][bb];
    const uint32_t base = bc - (uint32_t)s;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      uint32_t x = base + (uint32_t)col[q];
      if (col[q] < s) x += c;
      if (!kTail || x < d) {
        const float val = __fmul_rn(__ldg(v + x), scale);
        acc[j][q] = __fadd_rn(acc[j][q], with_sign(val, sign_bit(x, key[j])));
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kEncThreads, kEncCtasPerSm)
    encode_kernel(const float* __restrict__ v, uint32_t d,
                  const int* __restrict__ shifts,
                  const uint32_t* __restrict__ keys, int c, int m,
                  float scale, int accumulate, float* __restrict__ table) {
  constexpr int C = enc_cols<R>();
  constexpr int kTileCols = kEncThreads * C;
  __shared__ int sh[R][kShiftChunk];
  uint32_t key[R];
#pragma unroll
  for (int j = 0; j < R; ++j) key[j] = keys[j];
  const int m_full = (int)(d / (uint32_t)c);    // blocks wholly below d
  const int tiles = (int)(((long long)c + kTileCols - 1) / kTileCols);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // columns past c repeat column c - 1 and are not written
    int col[C];
    float acc[R][C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      col[q] = min(tile * kTileCols + q * kEncThreads + (int)threadIdx.x,
                   c - 1);
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j][q] = 0.0f;
    }
    for (int b0 = 0; b0 < m; b0 += kShiftChunk) {
      const int nb = min(kShiftChunk, m - b0);
      __syncthreads();                         // the last chunk is read
#pragma unroll
      for (int j = 0; j < R; ++j) {
        for (int k = threadIdx.x; k < nb; k += kEncThreads) {
          sh[j][k] = shifts[(long long)j * m + b0 + k];
        }
      }
      __syncthreads();
      for (int bb = 0; bb < nb; ++bb) {
        const int b = b0 + bb;
        const uint32_t bc = (uint32_t)b * (uint32_t)c;
        if (b < m_full) {
          encode_block<R, C, false>(acc, col, sh, key, v, d, c, bc, bb,
                                    scale);
        } else {
          encode_block<R, C, true>(acc, col, sh, key, v, d, c, bc, bb,
                                   scale);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = tile * kTileCols + q * kEncThreads + (int)threadIdx.x;
      if (i >= c) continue;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float* out = table + (long long)j * c + i;
        *out = accumulate ? __fadd_rn(*out, acc[j][q]) : acc[j][q];
      }
    }
  }
}

// The persistent grid: every CTA of `kernel` that fits on the current
// device at once, at most one a work item; -1 if a query failed, 0 if no
// CTA fits. Queried at every launch (a few attribute reads).
template <typename Kernel>
int persistent_grid(int items, Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess) {
    return -1;
  }
  return items < sms * per_sm ? items : sms * per_sm;
}

template <int R>
int launch_encode(const float* v, long long d, const int* shifts,
                  const uint32_t* keys, int c, int m, float scale,
                  int accumulate, float* table, cudaStream_t stream) {
  constexpr int kTileCols = kEncThreads * enc_cols<R>();
  const int tiles = (int)(((long long)c + kTileCols - 1) / kTileCols);
  const int grid = persistent_grid(tiles, encode_kernel<R>, kEncThreads);
  if (grid < 0) return (int)cudaGetLastError();
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  encode_kernel<R><<<grid, kEncThreads, 0, stream>>>(
      v, (uint32_t)d, shifts, keys, c, m, scale, accumulate, table);
  return (int)cudaGetLastError();
}

template <int R>
__global__ void decode_kernel(const float* __restrict__ table,
                              const int* __restrict__ shifts,
                              const uint32_t* __restrict__ keys, int c,
                              int m, long long d, float* __restrict__ out) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= d) return;
  const int b = (int)(x / c);
  const int i = (int)(x - (long long)b * c);
  float e[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    int q = i + shifts[(long long)j * m + b];
    if (q >= c) q -= c;
    e[j] = with_sign(table[(long long)j * c + q],
                     sign_bit((uint32_t)x, keys[j]));
  }
  // bubble network of median_axis0: r(r-1)/2 min/max pairs
#pragma unroll
  for (int p = 0; p < R; ++p) {
#pragma unroll
    for (int q = 0; q < R - 1 - p; ++q) {
      const float lo = nan_min(e[q], e[q + 1]);
      const float hi = nan_max(e[q], e[q + 1]);
      e[q] = lo;
      e[q + 1] = hi;
    }
  }
  if (R % 2) {
    out[x] = e[R / 2];
  } else {
    out[x] = __fmul_rn(0.5f, __fadd_rn(e[R / 2 - 1], e[R / 2]));
  }
}

template <int R>
void launch_decode(const float* table, const int* shifts,
                   const uint32_t* keys, int c, int m, long long d,
                   float* out, cudaStream_t stream) {
  const long long blocks = (d + kThreads - 1) / kThreads;
  decode_kernel<R><<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, shifts, keys, c, m, d, out);
}

// m c coordinates must fit the uint32 sign-stream index (the wrapper
// checks it too)
bool bad_geometry(long long d, int c, int m) {
  return d <= 0 || c <= 0 || m <= 0 || (long long)m * c >= (1LL << 32) ||
         d > (long long)m * c;
}

}  // namespace

extern "C" int circ_encode(const float* v, long long d, const int* shifts,
                           const uint32_t* keys, int c, int r, int m,
                           float scale, int accumulate, float* table,
                           void* stream) {
  if (bad_geometry(d, c, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CIRC_ENCODE(R)                                                     \
  case R:                                                                  \
    return launch_encode<R>(v, d, shifts, keys, c, m, scale, accumulate,  \
                            table, s)
  switch (r) {
    CIRC_ENCODE(1);
    CIRC_ENCODE(2);
    CIRC_ENCODE(3);
    CIRC_ENCODE(4);
    CIRC_ENCODE(5);
    CIRC_ENCODE(6);
    CIRC_ENCODE(7);
    CIRC_ENCODE(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CIRC_ENCODE
}

extern "C" int circ_decode(const float* table, const int* shifts,
                           const uint32_t* keys, int c, int r, int m,
                           long long d, float* out, void* stream) {
  if (bad_geometry(d, c, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (r) {
    case 1: launch_decode<1>(table, shifts, keys, c, m, d, out, s); break;
    case 2: launch_decode<2>(table, shifts, keys, c, m, d, out, s); break;
    case 3: launch_decode<3>(table, shifts, keys, c, m, d, out, s); break;
    case 4: launch_decode<4>(table, shifts, keys, c, m, d, out, s); break;
    case 5: launch_decode<5>(table, shifts, keys, c, m, d, out, s); break;
    case 6: launch_decode<6>(table, shifts, keys, c, m, d, out, s); break;
    case 7: launch_decode<7>(table, shifts, keys, c, m, d, out, s); break;
    case kMaxRows:
      launch_decode<kMaxRows>(table, shifts, keys, c, m, d, out, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int circ_max_rows() { return kMaxRows; }

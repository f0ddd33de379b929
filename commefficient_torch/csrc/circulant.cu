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
// K1: one thread per (row j, column i). The thread walks the blocks b in
// ascending order and keeps the sum in a register: no atomics, and the
// summation order is that of the plain version (and of pallas_encode), so
// the result is deterministic. Neighbouring threads read neighbouring
// elements of v, so every read is coalesced apart from the one seam per
// block where (i - s) wraps. One launch computes
// table = [table +] encode(scale * v): the accumulate flag and the scale
// fold the fused client step's per-microbatch weighting into the launch.
// Bound on an H100 SXM (3.35 TB/s): bytes. It must read v once (4 d bytes)
// and write the table (4 r c bytes; read it too when accumulating). At
// d = 6,568,640, c = 500,736, r = 5: 26.3 MB + 2 x 10.0 MB, about 14 us.
// This first version reads v once per row (r times), from L2 where it
// hits.
//
// K2: one thread per output coordinate x < d. It gathers r table cells,
// applies the signs and takes the median in registers (the network is
// unrolled for a compile-time r). The 10 MB table stays in the 50 MB L2.
// Bound: bytes, 4 r c read + 4 d written = 36.3 MB at the flagship
// shape, about 11 us.
//
// Bitwise agreement with the plain PyTorch versions
// (ops/circulant_kernels.py): the float operations are written with
// __fmul_rn / __fadd_rn so that nvcc cannot contract them into FMAs, and
// they happen in the same order as in the plain versions.
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// true where sigma_j(x) = -1
__device__ __forceinline__ bool sign_negative(uint32_t x, uint32_t key) {
  return (mix32(x * key + 0x9E3779B9u) >> 31) != 0u;
}

// min/max that propagate NaN, as torch.minimum / jnp.minimum do (fminf
// alone would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__global__ void encode_kernel(const float* __restrict__ v, long long d,
                              const int* __restrict__ shifts,
                              const uint32_t* __restrict__ keys, int c,
                              int m, float scale, int accumulate,
                              float* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= c) return;
  const uint32_t key = keys[j];
  const int* row_shifts = shifts + (long long)j * m;
  float acc = 0.0f;
  for (int b = 0; b < m; ++b) {
    int u = i - row_shifts[b];
    if (u < 0) u += c;
    const long long x = (long long)b * c + u;
    // past d the vector is zero padding: sigma * 0 would add a signed
    // zero, which leaves acc unchanged (acc starts at +0)
    if (x < d) {
      const float val = __fmul_rn(v[x], scale);
      acc = __fadd_rn(acc, sign_negative((uint32_t)x, key) ? -val : val);
    }
  }
  float* out = table + (long long)j * c + i;
  *out = accumulate ? __fadd_rn(*out, acc) : acc;
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
    const float t = table[(long long)j * c + q];
    e[j] = sign_negative((uint32_t)x, keys[j]) ? -t : t;
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

}  // namespace

extern "C" int circ_encode(const float* v, long long d, const int* shifts,
                           const uint32_t* keys, int c, int r, int m,
                           float scale, int accumulate, float* table,
                           void* stream) {
  if (d <= 0 || c <= 0 || r <= 0 || r > 65535 || m <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((c + kThreads - 1) / kThreads, r);
  encode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      v, d, shifts, keys, c, m, scale, accumulate, table);
  return (int)cudaGetLastError();
}

extern "C" int circ_decode(const float* table, const int* shifts,
                           const uint32_t* keys, int c, int r, int m,
                           long long d, float* out, void* stream) {
  if (d <= 0 || c <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
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

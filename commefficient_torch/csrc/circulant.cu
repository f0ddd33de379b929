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
// The median is that of ops/topk.py median_axis0, the mean of the two
// middle values for even r, under min/max that return a NaN operand and
// order -0 below +0 (jnp.minimum / jnp.maximum).
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
// sketch_work). K2 needs no index step, but a coordinate's median network
// (MedianNet below: 10 min/max at r = 5, one FMNMX each on the ALU), 2 a
// term: 7 ALU instructions a term. An SM issues 128 instructions a clock,
// 64 of them on the ALU and 64 on the IMAD pipe, at the clock of the data
// sheet's 67 TFLOP/s float32. At the GPT-2 shape (d = 92,138,496,
// c = 524,288, m = 176) issue bounds K1 at 0.143 ms, above its bytes
// (0.116 ms), and the ALU K2 at 0.193 ms (bytes 0.113); at the ResNet-9
// shape (d = 6,568,640, c = 500,736, m = 14) the bytes bound K1, 0.0138 ms,
// and the ALU K2, 0.0137 ms (bytes 0.0108). chip_smoke.py reads what the
// kernels issue from their SASS: a term of K1's walk about 15, 8 on the
// ALU (the shifted column's wrap test, select and add, the address). Both
// kernels gather r 4 d bytes from L2 (1.84 GB at the GPT-2 shape), a
// ceiling that chip_smoke.py prints at a measured L2 read rate.
//
// K1: a persistent grid of 256-thread CTAs, as many as fit on the card at
// once (4 an SM). A CTA owns a tile of output columns for all r rows (4
// columns a thread for r <= 5, 2 above, strided by 256 so that neighbouring
// threads gather neighbouring elements of v) and keeps r sums a column in
// registers. It walks the blocks b = 0 .. m - 1 in ascending order with the
// (r, m) shifts staged in shared memory 128 blocks at a time (the range
// form: only the blocks that hold coordinates of [start, start + n)). Since every
// CTA in flight walks b in step, the r gathers of block b come from one
// 4 c-byte slice of v that L2 holds: v is read from device memory once
// (368 MB at the GPT-2 shape), and the r reads of it are L2 hits (r x 4 d
// bytes of L2 traffic, 1.84 GB at the GPT-2 shape, not measured apart: the
// likely ceiling above the issue of K1's own SASS). When the column tiles
// outnumber the CTAs (c above about 540,000 at r <= 5) a CTA takes a
// second tile and v is read once per wave. The summation order is that of
// the plain version (and of pallas_encode), ascending b per cell, with no
// atomics, so the result is deterministic. Only a block that the range
// does not cover whole (its first block, and its last, such as the block
// that holds d) tests x. One launch computes table = [table +]
// encode(scale * v): the accumulate flag and the scale fold the fused
// client step's per-microbatch weighting into the launch. The range form
// (a layer's gradient at its offset, StreamMLP's streaming encode) reads
// and writes all r c cells whatever n is: a 2,048-value bias costs the
// table's 21 MB at c = 524,288 (a design that touches only the columns a
// range reaches is left for later).
//
// K2: a CTA of 256 threads owns one work item, a tile of 2,048 columns
// (1,024 for r > 5) of one block b: grid x the tile, grid y the block (y
// loops past 65,535 blocks). It loads the r shifts s[j, b] and keys once,
// so a coordinate costs no division and no 64-bit index arithmetic (x =
// b c + i stays in uint32). A thread owns 8 coordinates (4 for r > 5),
// strided by 256, and issues all their r gathers before it uses one: row
// j of the tile is the run table[j, (i0 + s[j, b]) mod c ...], which wraps
// at most once; a tile whose runs do not wrap and that ends before c and
// before d reads through row pointers with constant offsets and stores
// without a test, the few others wrap and test each coordinate. The hash
// input x key + C advances by 256 key from one of a thread's coordinates
// to the next (one add), and the median is the network MedianNet<r>, one
// min.NaN / max.NaN each. Neighbouring threads gather neighbouring cells
// and store neighbouring coordinates. The 10.5 MB table stays in the 50
// MB L2. Bytes: 4 r c read + 4 d written = 36.3 MB at the ResNet-9 shape.
//
// K2's range form (start, n: the sharded server tail's decode of one
// rank's coordinates, ops/circulant.py decode_range): the coordinates
// [start, start + n) of the whole decode into out[0 .. n), bitwise that
// slice; those at and past d are +0.0, written by one cudaMemsetAsync on
// the stream. The grid's y walks only the range's blocks, a CTA whose tile
// holds no coordinate of the range returns at once, and a tile that the
// range does not cover whole tests each coordinate (kEdge). It is a second
// instantiation (kRange), so the whole decode keeps its code and its time
// (scripts/k2_ab.py of the port: 0.0261 ms against 0.0261 at m = 14).
// Its bound is that of its live coordinates: the table cells they gather
// (all r c once the range spans c) and 4 n bytes written, or their ALU
// issue; a shard of 4 took 0.0092 ms at m = 14 (bound 0.0050, bytes) and
// 0.0752 at m = 176 (bound 0.0481, ALU issue): the tiles at its two ends
// test every coordinate.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit (chip_smoke.py,
// r = 5): K1 0.043 ms at m = 14 and 0.474 ms at m = 176 (32% and 30% of
// the bound); K2 0.0259 and 0.276 ms (53% and 70% of its ALU bound; the
// one-thread-per-coordinate design it replaced took 0.057 and 0.760 ms).
// K2's SASS issues 11.8 instructions a term at r = 5 (7.5 ALU, 3.05 IMAD,
// 1.2 memory; no CALL), and its gathers read L2 at 6.7 TB/s at m = 176.
// ptxas (nvcc -Xptxas -v, sm_90a): the encode 63-64 registers for r >= 3
// (55 at r = 2, 40 at r = 1) and 512 r bytes of shared memory, the decode
// 122 registers at r = 5 (56 to 108 for the other r); no spills.
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
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 8;
constexpr int kDecThreads = 256;       // decode: threads a CTA
constexpr int kEncThreads = 256;       // encode: threads a CTA
constexpr int kEncCtasPerSm = 4;       // resident encode CTAs an SM
constexpr int kShiftChunk = 128;       // blocks whose shifts are staged

// Coordinates of a column tile a thread owns in the decode, strided by
// kDecThreads: their C r gathers are in flight together.
template <int R>
__host__ __device__ constexpr int dec_cols() {
  return R <= 5 ? 8 : 4;
}

// Columns of a table tile a thread owns in the encode: its r sums a column
// stay in registers (at most 64 a thread for 4 CTAs an SM).
template <int R>
__host__ __device__ constexpr int enc_cols() {
  return R <= 5 ? 4 : 2;
}

// The sign bit of sigma_j(x): bit 31 of fmix32(h), h = x * key +
// 0x9E3779B9. The finalizer's last step, h ^= h >> 16, cannot change bit
// 31 and is left out.
__device__ __forceinline__ uint32_t mix_sign(uint32_t h) {
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

// Add block b's terms to a thread's sums: for row j and column i the term
// sigma_j(x) * scale * v[x - lo], x = b c + (i - s[j, b]) mod c, where v
// holds the n values of the coordinates [lo, lo + n). The walk indexes v
// by u = x - lo (uint32: a coordinate below lo wraps past n), and the
// hash input x key + C is u key + (lo key + C), the row's constant
// computed once a block, so a term costs what it costs in the
// whole-vector walk (lo = 0). Only a block that the range does not cover
// whole tests u < n (kEdge): the first block of a range that starts
// inside a block, and the last that ends inside one, such as the block
// that holds d. A term outside the range would add a signed zero, which
// leaves a sum that starts at +0 unchanged.
template <int R, int C, bool kEdge>
__device__ __forceinline__ void encode_block(float (&acc)[R][C],
                                             const int (&col)[C],
                                             int (*sh)[kShiftChunk],
                                             const uint32_t (&key)[R],
                                             const float* __restrict__ v,
                                             uint32_t lo, uint32_t n,
                                             uint32_t c, uint32_t bc, int bb,
                                             float scale) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int s = sh[j][bb];
    const uint32_t base = bc - lo - (uint32_t)s;
    const uint32_t hc = lo * key[j] + 0x9E3779B9u;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      uint32_t u = base + (uint32_t)col[q];
      if (col[q] < s) u += c;
      if (!kEdge || u < n) {
        const float val = __fmul_rn(__ldg(v + u), scale);
        acc[j][q] = __fadd_rn(acc[j][q],
                              with_sign(val, mix_sign(u * key[j] + hc)));
      }
    }
  }
}

// The range [lo, lo + n) of global coordinates, 0 < n, lo + n <= m c <
// 2^32: the blocks lo / c .. (lo + n - 1) / c are walked in ascending
// order.
template <int R>
__global__ void __launch_bounds__(kEncThreads, kEncCtasPerSm)
    encode_kernel(const float* __restrict__ v, uint32_t lo, uint32_t n,
                  const int* __restrict__ shifts,
                  const uint32_t* __restrict__ keys, int c, int m,
                  float scale, int accumulate, float* __restrict__ table) {
  constexpr int C = enc_cols<R>();
  constexpr int kTileCols = kEncThreads * C;
  __shared__ int sh[R][kShiftChunk];
  uint32_t key[R];
#pragma unroll
  for (int j = 0; j < R; ++j) key[j] = keys[j];
  const uint32_t hi = lo + n;
  const int b_first = (int)(lo / (uint32_t)c);
  const int b_end = (int)((hi - 1) / (uint32_t)c) + 1;
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
    for (int b0 = b_first; b0 < b_end; b0 += kShiftChunk) {
      const int nb = min(kShiftChunk, b_end - b0);
      __syncthreads();                         // the last chunk is read
#pragma unroll
      for (int j = 0; j < R; ++j) {
        for (int k = threadIdx.x; k < nb; k += kEncThreads) {
          sh[j][k] = shifts[(long long)j * m + b0 + k];
        }
      }
      __syncthreads();
      for (int bb = 0; bb < nb; ++bb) {
        const uint32_t bc = (uint32_t)(b0 + bb) * (uint32_t)c;
        if (bc >= lo && bc + (uint32_t)c <= hi) {
          encode_block<R, C, false>(acc, col, sh, key, v, lo, n, c, bc, bb,
                                    scale);
        } else {
          encode_block<R, C, true>(acc, col, sh, key, v, lo, n, c, bc, bb,
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
int launch_encode(const float* v, long long start, long long n,
                  const int* shifts, const uint32_t* keys, int c, int m,
                  float scale, int accumulate, float* table,
                  cudaStream_t stream) {
  constexpr int kTileCols = kEncThreads * enc_cols<R>();
  const int tiles = (int)(((long long)c + kTileCols - 1) / kTileCols);
  const int grid = persistent_grid(tiles, encode_kernel<R>, kEncThreads);
  if (grid < 0) return (int)cudaGetLastError();
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  encode_kernel<R><<<grid, kEncThreads, 0, stream>>>(
      v, (uint32_t)start, (uint32_t)n, shifts, keys, c, m, scale, accumulate,
      table);
  return (int)cudaGetLastError();
}

// ---- K2 -------------------------------------------------------------

// The median networks, as lists of min/max operations: value v[R + k] is
// the k-th operation's min or max of v[A] and v[B], v[0 .. R - 1] the
// signed estimates. The median is the last value (odd R), or the mean of
// the last two (even R: the two middle values, in either order; a float
// sum does not depend on its operands' order). chip_smoke.py MEDIAN_NETS
// holds the same lists; its tests hold each, bit for bit, to the JAX
// package's median_axis0 and parse them from this file.
enum { kMin, kMax };
template <int Kind, int A, int B>
struct MinMax {};
template <typename... Ops>
struct Net {};

template <int R>
struct MedianNet;
template <>
struct MedianNet<1> {
  using type = Net<>;
};
template <>
struct MedianNet<2> {
  using type = Net<>;
};
template <>
struct MedianNet<3> {
  using type = Net<MinMax<kMin, 0, 1>, MinMax<kMax, 0, 1>, MinMax<kMin, 4, 2>,
                   MinMax<kMax, 3, 5>>;
};
template <>
struct MedianNet<4> {
  using type = Net<MinMax<kMin, 0, 1>, MinMax<kMax, 0, 1>, MinMax<kMin, 2, 3>,
                   MinMax<kMax, 2, 3>, MinMax<kMax, 4, 6>, MinMax<kMin, 5, 7>>;
};
template <>
struct MedianNet<5> {
  using type = Net<MinMax<kMin, 0, 1>, MinMax<kMax, 0, 1>, MinMax<kMin, 2, 3>,
                   MinMax<kMax, 2, 3>, MinMax<kMax, 5, 7>, MinMax<kMin, 6, 8>,
                   MinMax<kMin, 4, 9>, MinMax<kMax, 4, 9>,
                   MinMax<kMin, 12, 10>, MinMax<kMax, 11, 13>>;
};
template <>
struct MedianNet<6> {
  using type = Net<MinMax<kMin, 1, 4>, MinMax<kMax, 1, 4>, MinMax<kMin, 0, 2>,
                   MinMax<kMax, 0, 2>, MinMax<kMin, 9, 5>, MinMax<kMax, 9, 5>,
                   MinMax<kMin, 8, 3>, MinMax<kMax, 8, 3>, MinMax<kMin, 10, 7>,
                   MinMax<kMax, 10, 7>, MinMax<kMax, 12, 6>,
                   MinMax<kMin, 16, 13>, MinMax<kMax, 16, 13>,
                   MinMax<kMin, 18, 11>, MinMax<kMax, 17, 14>,
                   MinMax<kMin, 19, 15>>;
};
template <>
struct MedianNet<7> {
  using type = Net<MinMax<kMin, 2, 6>, MinMax<kMax, 2, 6>, MinMax<kMin, 0, 7>,
                   MinMax<kMax, 0, 7>, MinMax<kMin, 10, 5>,
                   MinMax<kMax, 10, 5>, MinMax<kMin, 1, 8>, MinMax<kMax, 1, 8>,
                   MinMax<kMin, 12, 14>, MinMax<kMin, 13, 4>,
                   MinMax<kMax, 13, 4>, MinMax<kMin, 3, 17>,
                   MinMax<kMax, 3, 17>, MinMax<kMin, 19, 15>,
                   MinMax<kMax, 9, 18>, MinMax<kMax, 16, 11>,
                   MinMax<kMin, 22, 21>, MinMax<kMax, 22, 21>,
                   MinMax<kMin, 24, 20>, MinMax<kMax, 23, 25>>;
};
template <>
struct MedianNet<8> {
  using type = Net<MinMax<kMin, 0, 1>, MinMax<kMax, 0, 1>, MinMax<kMin, 2, 3>,
                   MinMax<kMax, 2, 3>, MinMax<kMin, 4, 5>, MinMax<kMax, 4, 5>,
                   MinMax<kMin, 6, 7>, MinMax<kMax, 6, 7>, MinMax<kMin, 8, 10>,
                   MinMax<kMax, 8, 10>, MinMax<kMin, 9, 11>,
                   MinMax<kMax, 9, 11>, MinMax<kMin, 12, 14>,
                   MinMax<kMax, 12, 14>, MinMax<kMin, 13, 15>,
                   MinMax<kMax, 13, 15>, MinMax<kMin, 18, 17>,
                   MinMax<kMax, 18, 17>, MinMax<kMin, 22, 21>,
                   MinMax<kMax, 22, 21>, MinMax<kMax, 16, 20>,
                   MinMax<kMax, 24, 26>, MinMax<kMin, 25, 27>,
                   MinMax<kMin, 19, 23>, MinMax<kMin, 31, 29>,
                   MinMax<kMax, 30, 28>>;
};

// min and max that return NaN if an operand is NaN and order -0 below
// +0, as jnp.minimum and jnp.maximum do: one FMNMX each
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int Kind, int A, int B, int N>
__device__ __forceinline__ float apply(const float (&v)[N],
                                       MinMax<Kind, A, B>) {
  static_assert(A < N && B < N, "an operand past the values");
  return Kind == kMin ? min_nan(v[A], v[B]) : max_nan(v[A], v[B]);
}

template <int R, int N, typename... Ops, int... K>
__device__ __forceinline__ float run_net(float (&v)[N], Net<Ops...>,
                                         std::integer_sequence<int, K...>) {
  ((v[R + K] = apply(v, Ops{})), ...);
  if constexpr (R % 2) {
    return v[N - 1];
  } else {
    return __fmul_rn(0.5f, __fadd_rn(v[N - 2], v[N - 1]));
  }
}

template <int R, typename... Ops>
__device__ __forceinline__ float median(const float (&e)[R],
                                        Net<Ops...> net) {
  float v[R + sizeof...(Ops)];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = e[j];
  return run_net<R>(v, net,
                    std::make_integer_sequence<int, sizeof...(Ops)>{});
}

// Decode one tile of kDecThreads * C columns, i0 .. i0 + kTile - 1, of
// block b for all rows. Thread t owns the columns i = i0 + t + q
// kDecThreads, q < C, coordinates x = b c + i, and gathers row j's cell at
// column start[j] + t + q kDecThreads (mod c), start[j] = (i0 + s[j, b])
// mod c. h[j] enters as x key_j + 0x9E3779B9 of its first coordinate and
// advances by step[j] = kDecThreads key_j from one coordinate to the next.
// kEdge: the tile holds a row's seam, or runs past c or past d (or, in
// the range form kRange, out of the range), so each gather wraps and each
// coordinate is tested; the other tiles read through a row pointer and
// store without a test. The whole decode (kRange false) compiles to the
// code it had before the range form: lo is 0 there and never read.
template <int R, int C, bool kEdge, bool kRange>
__device__ __forceinline__ void decode_tile(const float* __restrict__ table,
                                            const uint32_t (&start)[R],
                                            uint32_t (&h)[R],
                                            const uint32_t (&step)[R],
                                            uint32_t c, uint32_t lo,
                                            uint32_t hi, uint32_t bc,
                                            uint32_t i0,
                                            float* __restrict__ out) {
  const uint32_t t = threadIdx.x;
  const float* row[R];
#pragma unroll
  for (int j = 0; j < R; ++j) row[j] = table + (size_t)j * c;
  float e[C][R];
  bool valid[C];
  // all C R gathers first, so that they are in flight together
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const uint32_t off = q * kDecThreads + t;
    // the range form: x - lo < hi - lo, lo <= x < hi in one compare
    if constexpr (kRange) {
      valid[q] = !kEdge || (i0 + off < c && bc + i0 + off - lo < hi - lo);
    } else {
      valid[q] = !kEdge || (i0 + off < c && bc + i0 + off < hi);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if constexpr (kEdge) {
        uint32_t col = start[j] + off;
        if (col >= c) col -= c;
        e[q][j] = valid[q] ? __ldg(row[j] + col) : 0.0f;
      } else {
        // a constant offset from the row's pointer, in the load itself
        e[q][j] = __ldg(row[j] + start[j] + t + q * kDecThreads);
      }
    }
  }
  // out holds the coordinates lo .. hi - 1 (only valid ones are stored)
  float* dst = kRange ? out + ((long long)(bc + i0 + t) - (long long)lo)
                      : out + (bc + i0 + t);
#pragma unroll
  for (int q = 0; q < C; ++q) {
    float v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      v[j] = with_sign(e[q][j], mix_sign(h[j]));
      h[j] += step[j];
    }
    const float med = median(v, typename MedianNet<R>::type{});
    if (!kEdge || valid[q]) dst[q * kDecThreads] = med;
  }
}

// A CTA decodes column tile blockIdx.x of the blocks b = b0 + blockIdx.y,
// b0 + blockIdx.y + gridDim.y, ... up to b1 (the grid's y extent stops at
// 65,535 blocks), the coordinates lo <= x < hi of them: the whole decode
// is lo = 0, hi = d, blocks 0 .. m - 1; the range form decodes
// [lo, hi), hi = min(start + n, d), into out[x - lo]. A tile with no
// coordinate in the range returns at once; a tile that the range does
// not cover whole tests each coordinate.
template <int R, bool kRange>
__global__ void __launch_bounds__(kDecThreads, 2)
    decode_kernel(const float* __restrict__ table,
                  const int* __restrict__ shifts,
                  const uint32_t* __restrict__ keys, uint32_t c, uint32_t m,
                  uint32_t lo, uint32_t hi, uint32_t b0, uint32_t b1,
                  float* __restrict__ out) {
  constexpr int C = dec_cols<R>();
  constexpr uint32_t kTile = kDecThreads * C;
  const uint32_t i0 = blockIdx.x * kTile;
  uint32_t key[R];
#pragma unroll
  for (int j = 0; j < R; ++j) key[j] = __ldg(keys + j);
  if constexpr (!kRange) b0 = 0;
  for (uint32_t b = b0 + blockIdx.y; kRange ? b <= b1 : b < m;
       b += gridDim.y) {
    const uint32_t bc = b * c;
    if (kRange && ((uint64_t)bc + i0 >= hi || (uint64_t)bc + i0 + kTile <= lo))
      continue;
    uint32_t start[R], h[R], step[R];
    bool edge = i0 + kTile > c || (uint64_t)bc + i0 + kTile > hi ||
                (kRange && bc + i0 < lo);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      uint32_t s = i0 + (uint32_t)__ldg(shifts + (size_t)j * m + b);
      if (s >= c) s -= c;
      start[j] = s;
      edge |= s + kTile > c;
      h[j] = (bc + i0 + threadIdx.x) * key[j] + 0x9E3779B9u;
      step[j] = key[j] * kDecThreads;
    }
    if (edge) {
      decode_tile<R, C, true, kRange>(table, start, h, step, c, lo, hi, bc,
                                      i0, out);
    } else {
      decode_tile<R, C, false, kRange>(table, start, h, step, c, lo, hi, bc,
                                       i0, out);
    }
  }
}

template <int R>
int launch_decode(const float* table, const int* shifts,
                  const uint32_t* keys, int c, int m, long long lo,
                  long long hi, bool whole, float* out, cudaStream_t stream) {
  constexpr int kTile = kDecThreads * dec_cols<R>();
  const long long b0 = lo / c, b1 = (hi - 1) / c;
  const long long blocks = b1 - b0 + 1;
  const dim3 grid((unsigned)(((long long)c + kTile - 1) / kTile),
                  (unsigned)(blocks < 65535 ? blocks : 65535));
  // the whole decode (lo = 0, hi = d) keeps its own instantiation
  auto kernel = whole ? decode_kernel<R, false> : decode_kernel<R, true>;
  kernel<<<grid, kDecThreads, 0, stream>>>(
      table, shifts, keys, (uint32_t)c, (uint32_t)m, (uint32_t)lo,
      (uint32_t)hi, (uint32_t)b0, (uint32_t)b1, out);
  return (int)cudaGetLastError();
}

// m c coordinates must fit the uint32 sign-stream index (the wrapper
// checks it too)
bool bad_geometry(long long d, int c, int m) {
  return d <= 0 || c <= 0 || m <= 0 || (long long)m * c >= (1LL << 32) ||
         d > (long long)m * c;
}

}  // namespace

// table [+]= encode(scale * v) of the vector that holds v's n values at
// the coordinates [start, start + n) and zeros elsewhere; the whole
// vector is start = 0, n = d.
extern "C" int circ_encode(const float* v, long long start, long long n,
                           const int* shifts, const uint32_t* keys, int c,
                           int r, int m, float scale, int accumulate,
                           float* table, void* stream) {
  if (start < 0 || bad_geometry(start + n, c, m) || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CIRC_ENCODE(R)                                                     \
  case R:                                                                  \
    return launch_encode<R>(v, start, n, shifts, keys, c, m, scale,        \
                            accumulate, table, s)
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

// The estimates of the coordinates [start, start + n) into out[0 .. n):
// those below d decoded, those at or past d exactly +0.0 (cudaMemsetAsync
// on the same stream). The whole decode is start = 0, n = d, and any range
// is bitwise that slice of it. A nonzero range_form runs the range
// instantiation even where the range covers [0, d) (a sharded tail on one
// rank), so a caller of the range form always runs its code.
extern "C" int circ_decode(const float* table, const int* shifts,
                           const uint32_t* keys, int c, int r, int m,
                           long long d, long long start, long long n,
                           int range_form, float* out, void* stream) {
  if (bad_geometry(d, c, m) || start < 0 || n <= 0 ||
      start + n >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long hi = start + n < d ? start + n : d;
  if (hi < start + n) {
    const long long first = hi > start ? hi : start;
    const cudaError_t err = cudaMemsetAsync(
        out + (first - start), 0, (size_t)(start + n - first) * sizeof(float),
        s);
    if (err != cudaSuccess) return (int)err;
  }
  if (hi <= start) return (int)cudaGetLastError();
  const bool whole = !range_form && start == 0 && hi == d;
#define CIRC_DECODE(R)                                                   \
  case R:                                                                \
    return launch_decode<R>(table, shifts, keys, c, m, start, hi, whole, \
                            out, s)
  switch (r) {
    CIRC_DECODE(1);
    CIRC_DECODE(2);
    CIRC_DECODE(3);
    CIRC_DECODE(4);
    CIRC_DECODE(5);
    CIRC_DECODE(6);
    CIRC_DECODE(7);
    CIRC_DECODE(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CIRC_DECODE
}

extern "C" int circ_max_rows() { return kMaxRows; }

// Causal flash attention for Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the library Pallas TPU kernel that the JAX package's
// models/gpt2.py flash_causal_attention calls
// (jax.experimental.pallas.ops.tpu.flash_attention):
//   flash_fwd     <- _flash_attention_impl (forward, writes o and the
//                    row statistics the backward reads)
//   flash_bwd_dq  <- _flash_attention_bwd_dq
//   flash_bwd_dkv <- _flash_attention_bwd_dkv
//
// What it computes, per sequence n and head h (q, k, v: S x D, bf16):
//
//   s = q k^T / sqrt(D), causal (key > query masked out)
//   lse = logsumexp_row(s)           (float32, (N, H, S))
//   o = softmax_row(s) v             (bf16)
//   delta = rowsum(dO * o)           (float32, written by flash_bwd_dq)
//   p = exp(s - lse),  dp = dO v^T,  ds = p * (dp - delta)
//   dq = ds k / sqrt(D),  dk = ds^T q / sqrt(D),  dv = p^T dO
//
// Layout. q, k, v, o, dO, dq, dk and dv are (N, S, H, D) tensors given by
// a base pointer and three element strides (sequence, position, head), the
// last dimension contiguous: the port's GPT-2 passes the three slices of
// the c_attn output (N, S, 3E) as they are, so no transpose precedes or
// follows a kernel. Rows must start on 16-byte boundaries (the wrapper
// checks the pointers and strides).
//
// Design. One CTA of four warps per (64-row tile, head, sequence); each
// warp owns 16 rows of the tile. Tiles of 64 rows of q / k / v / dO are
// copied into shared memory with 16-byte loads (rows padded by 8 bf16 so
// that ldmatrix reads hit 32 distinct banks), and every product runs on
// the tensor cores as mma.sync m16n8k16 (bf16 in, float32 accumulate),
// operands fed by ldmatrix (.trans where the tile is the k-major operand).
// The forward keeps the running row max and sum in registers (online
// softmax in the log2 domain) and never stores the S x S scores; the
// probabilities are rounded to bf16 only as the A operand of p v. The
// backward recomputes p from the saved lse. flash_bwd_dq owns a query
// tile and walks the key tiles up to the diagonal; it also computes delta
// for its rows and writes it, and flash_bwd_dkv, launched after it on the
// same stream, reads it: no extra pass. flash_bwd_dkv owns a key tile and
// walks the query tiles from the diagonal down. Every output element is
// written by one thread, once: no atomics, so the gradient is
// deterministic. Heavy tiles (most keys to walk) are scheduled first.
// The TPU kernel's block structure (512-wide blocks, the sequential grid
// that carries the softmax state in VMEM scratch) is not carried over:
// the loop over key tiles inside the CTA takes its place.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the GPT-2
// shape N 8, H 12, S 1024, D 64: the forward needs 2 causal products,
// 12.9 GFLOP (13 us), and moves 50.7 MB: 15 us by bytes. The backward
// needs 5 causal products, 32 GFLOP: 33 us. This first version stops at
// what mma.sync from synchronously loaded tiles gives; wgmma, TMA and
// warp specialisation are later work.
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// given stream and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it does not take (D != 64, S not a
// multiple of 64).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;               // query rows and keys per tile
constexpr int kWarps = 4;               // 16 rows of a tile per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                 // bf16 padding per shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long n, s, h;                    // sequence, position, head
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: a row-major 16x16, b 16x8 (k-major).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of one k-step (16 columns = n-tiles 2kk and 2kk+1) from a
// warp's float32 accumulators of a 16 x 64 product, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&s)[8][4], int kk) {
  a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// 64 rows of D bf16 from global memory (row stride in elements) into a
// padded shared tile, 16 bytes a thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride) {
  constexpr int kChunks = D / 8;
  constexpr int kSteps = kTile * kChunks / kThreads;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
  }
}

// A fragments of a warp's 16 rows (rows r0.., all D columns) of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const bf16* tile, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm4(a[kk], tile + (r0 + (lane & 15)) * (D + kPad) + kk * 16 +
                     (lane >> 4) * 8);
  }
}

// s (16 x 64) = a (16 x D) b^T, b a 64 x D row-major shared tile.
template <int D>
__device__ __forceinline__ void mma_abt(float (&s)[8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* b, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      ldsm4(r, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * (D + kPad) +
                   kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * np], a[kk], r[0], r[1]);
      mma(s[2 * np + 1], a[kk], r[2], r[3]);
    }
  }
}

// acc (16 x D) += p (16 x 64, float accumulators) b, b a 64 x D
// row-major shared tile; p is rounded to bf16.
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const float (&p)[8][4], const bf16* b,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p, kk);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldsm4_t(r, b + (kk * 16 + (lane & 15)) * (D + kPad) + dp * 16 +
                     (lane >> 4) * 8);
      mma(acc[2 * dp], a, r[0], r[1]);
      mma(acc[2 * dp + 1], a, r[2], r[3]);
    }
  }
}

// Write a warp's 16 x D float accumulators times `mul` as bf16 rows
// row0 and row0 + 8 of a strided (S, D) slab.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           int row0,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int t) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(base + row0 * row_stride + col) =
        __floats2bfloat162_rn(acc[nd][0] * mul0, acc[nd][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(base + (row0 + 8) * row_stride +
                                       col) =
        __floats2bfloat162_rn(acc[nd][2] * mul1, acc[nd][3] * mul1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale_log2) {
  constexpr int LD = D + kPad;
  __shared__ __align__(16) bf16 sQ[kTile * LD];
  __shared__ __align__(16) bf16 sK[kTile * LD];
  __shared__ __align__(16) bf16 sV[kTile * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;   // most key tiles first
  const int h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int row0 = q0 + warp * 16 + g;         // and row0 + 8
  const bf16* kb = k + n * sk.n + h * sk.h;
  const bf16* vb = v + n * sv.n + h * sv.h;

  load_tile<D>(sQ, q + n * sq.n + h * sq.h + q0 * sq.s, sq.s);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a<D>(qa, sQ, warp * 16, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();                           // last tile's reads done
    load_tile<D>(sK, kb + kt * kTile * sk.s, sk.s);
    load_tile<D>(sV, vb + kt * kTile * sv.s, sv.s);
    __syncthreads();

    float s[8][4];
    mma_abt<D>(s, qa, sK, lane);
    const bool diag = kt == qt;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (diag && kt * kTile + nt * 8 + 2 * t + (e & 1) >
                        row0 + (e >> 1) * 8) {
          x = -INFINITY;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    // every row sees key 0 in its first tile, so mx is finite from there
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= al0;
      acc[nd][1] *= al0;
      acc[nd][2] *= al1;
      acc[nd][3] *= al1;
    }
    mma_pb<D>(acc, s, sV, lane);
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  store_rows<D>(o + n * so.n + h * so.h, so.s, row0, acc, 1.0f / l0,
                1.0f / l1, t);
  if (t == 0) {
    float* lb = lse + ((long long)n * H + h) * S;
    lb[row0] = m0 * kLn2 + logf(l0);
    lb[row0 + 8] = m1 * kLn2 + logf(l1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq,
                        int S, int H, Strides sq, Strides sk, Strides sv,
                        Strides so, Strides sdo, Strides sdq, float scale,
                        float scale_log2) {
  constexpr int LD = D + kPad;
  __shared__ __align__(16) bf16 sQ[kTile * LD];
  __shared__ __align__(16) bf16 sDO[kTile * LD];
  __shared__ __align__(16) bf16 sK[kTile * LD];
  __shared__ __align__(16) bf16 sV[kTile * LD];
  __shared__ float sLse[kTile];
  __shared__ float sDelta[kTile];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int rl = warp * 16 + g;                // local rows rl, rl + 8
  const int row0 = q0 + rl;
  const long long stat = ((long long)n * H + h) * S + q0;
  const bf16* kb = k + n * sk.n + h * sk.h;
  const bf16* vb = v + n * sv.n + h * sv.h;

  load_tile<D>(sQ, q + n * sq.n + h * sq.h + q0 * sq.s, sq.s);
  load_tile<D>(sDO, dout + n * sdo.n + h * sdo.h + q0 * sdo.s, sdo.s);
  load_tile<D>(sK, o + n * so.n + h * so.h + q0 * so.s, so.s);  // o, for delta
  __syncthreads();
  {
    // delta = rowsum(dO * o): two threads a row, half the columns each
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    float sum = 0.0f;
#pragma unroll 8
    for (int c = c0; c < c0 + D / 2; ++c) {
      sum += __bfloat162float(sDO[r * LD + c]) *
             __bfloat162float(sK[r * LD + c]);
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    if ((threadIdx.x & 1) == 0) {
      sDelta[r] = sum;
      delta[stat + r] = sum;
      sLse[r] = lse[stat + r] * kLog2e;
    }
  }
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, sQ, warp * 16, lane);
  load_a<D>(da, sDO, warp * 16, lane);
  const float lse0 = sLse[rl], lse1 = sLse[rl + 8];
  const float del0 = sDelta[rl], del1 = sDelta[rl + 8];

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, kb + kt * kTile * sk.s, sk.s);
    load_tile<D>(sV, vb + kt * kTile * sv.s, sv.s);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<D>(s, qa, sK, lane);
    mma_abt<D>(dp, da, sV, lane);
    const bool diag = kt == qt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = exp2f(s[nt][e] * scale_log2 - (lo ? lse0 : lse1));
        if (diag && kt * kTile + nt * 8 + 2 * t + (e & 1) >
                        row0 + (e >> 1) * 8) {
          p = 0.0f;
        }
        s[nt][e] = p * (dp[nt][e] - (lo ? del0 : del1));   // ds
      }
    }
    mma_pb<D>(acc, s, sK, lane);
  }
  store_rows<D>(dq + n * sdq.n + h * sdq.h, sdq.s, row0, acc, scale, scale,
                t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int H, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, float scale,
                         float scale_log2) {
  constexpr int LD = D + kPad;
  __shared__ __align__(16) bf16 sQ[kTile * LD];
  __shared__ __align__(16) bf16 sDO[kTile * LD];
  __shared__ __align__(16) bf16 sK[kTile * LD];
  __shared__ __align__(16) bf16 sV[kTile * LD];
  __shared__ float sLse[kTile];
  __shared__ float sDelta[kTile];

  const int kt = blockIdx.x;                   // most query tiles first
  const int nq = gridDim.x;
  const int h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int key0 = k0 + warp * 16 + g;         // and key0 + 8
  const long long stat = ((long long)n * H + h) * S;
  const bf16* qb = q + n * sq.n + h * sq.h;
  const bf16* db = dout + n * sdo.n + h * sdo.h;

  load_tile<D>(sK, k + n * sk.n + h * sk.h + k0 * sk.s, sk.s);
  load_tile<D>(sV, v + n * sv.n + h * sv.h + k0 * sv.s, sv.s);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, sK, warp * 16, lane);
  load_a<D>(va, sV, warp * 16, lane);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dka[nd][0] = dka[nd][1] = dka[nd][2] = dka[nd][3] = 0.0f;
    dva[nd][0] = dva[nd][1] = dva[nd][2] = dva[nd][3] = 0.0f;
  }
  for (int qt = kt; qt < nq; ++qt) {
    __syncthreads();
    load_tile<D>(sQ, qb + qt * kTile * sq.s, sq.s);
    load_tile<D>(sDO, db + qt * kTile * sdo.s, sdo.s);
    if (threadIdx.x < kTile) {
      sLse[threadIdx.x] = lse[stat + qt * kTile + threadIdx.x] * kLog2e;
      sDelta[threadIdx.x] = delta[stat + qt * kTile + threadIdx.x];
    }
    __syncthreads();

    // p^T (16 keys x 64 queries a warp) from s^T = k q^T
    float pt[8][4], dpt[8][4];
    mma_abt<D>(pt, ka, sQ, lane);
    const bool diag = qt == kt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        float p = exp2f(pt[nt][e] * scale_log2 - sLse[ql]);
        if (diag && qt * kTile + ql < key0 + (e >> 1) * 8) p = 0.0f;
        pt[nt][e] = p;
      }
    }
    mma_pb<D>(dva, pt, sDO, lane);             // dv += p^T dO
    mma_abt<D>(dpt, va, sDO, lane);            // dp^T = v dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        pt[nt][e] *= dpt[nt][e] - sDelta[ql];  // ds^T
      }
    }
    mma_pb<D>(dka, pt, sQ, lane);              // dk += ds^T q
  }
  store_rows<D>(dk + n * sdk.n + h * sdk.h, sdk.s, key0, dka, scale, scale,
                t);
  store_rows<D>(dv + n * sdv.n + h * sdv.h, sdv.s, key0, dva, 1.0f, 1.0f, t);
}

constexpr int kHeadDim = 64;                    // the one D compiled

bool bad_shape(int N, int S, int H, int D) {
  return D != kHeadDim || S <= 0 || S % kTile != 0 || N <= 0 ||
         N > 65535 || H <= 0 || H > 65535;
}

Strides at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// strides: (sequence, position, head) element strides of q, k, v, o.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, int N, int S, int H, int D,
                         const long long* strides, float scale,
                         void* stream) {
  if (bad_shape(N, S, H, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kTile, H, N);
  flash_fwd_kernel<kHeadDim><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, S, H,
      at(strides, 0), at(strides, 1), at(strides, 2), at(strides, 3),
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// strides: q, k, v, o, dO, dq. Writes delta (N, H, S) float32.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq, int N,
                            int S, int H, int D, const long long* strides,
                            float scale, void* stream) {
  if (bad_shape(N, S, H, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kTile, H, N);
  flash_bwd_dq_kernel<kHeadDim><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, lse, delta, (bf16*)dq, S, H, at(strides, 0),
      at(strides, 1), at(strides, 2), at(strides, 3), at(strides, 4),
      at(strides, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// strides: q, k, v, dO, dk, dv. Reads the delta flash_bwd_dq wrote.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int N,
                             int S, int H, int D, const long long* strides,
                             float scale, void* stream) {
  if (bad_shape(N, S, H, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kTile, H, N);
  flash_bwd_dkv_kernel<kHeadDim>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          lse, delta, (bf16*)dk, (bf16*)dv, S, H, at(strides, 0),
          at(strides, 1), at(strides, 2), at(strides, 3), at(strides, 4),
          at(strides, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

extern "C" int flash_head_dim() { return kHeadDim; }
extern "C" int flash_tile() { return kTile; }

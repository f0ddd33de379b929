// Causal flash attention for Hopper (sm_90a) in the forms that
// csrc/flash_attention.cu does not take: float32 at head widths
// D = 16, 32, 64 and 128, and bf16 at D = 16, 32 and 128.
//
// Replaces, in those forms, the same library Pallas TPU kernels as
// flash_attention.cu (jax.experimental.pallas.ops.tpu.flash_attention,
// called by the JAX package's models/gpt2.py flash_causal_attention, which
// sets no condition on the dtype or on D):
//   flash_fwd_<f32|bf16>_d<D>     <- _flash_attention_impl
//   flash_bwd_dq_<f32|bf16>_d<D>  <- _flash_attention_bwd_dq
//   flash_bwd_dkv_<f32|bf16>_d<D> <- _flash_attention_bwd_dkv
// It computes what flash_attention.cu computes (see its note): o and the
// float32 lse (N, H, S) forward; dq and delta = rowsum(dO o), written for
// the dk/dv kernel, launched after it on the same stream; dk and dv. The
// operands are (N, S, H, D) tensors given by a base pointer and three
// element strides (sequence, position, head), last dimension contiguous.
//
// Design: simple tiled kernels, right first. A CTA owns one work item, a
// 64-row tile of queries (forward, dq) or keys (dk/dv) of one head of one
// sequence, and walks the other side's 64-row tiles in a loop: the keys
// up to the diagonal, or the queries from it. Heaviest items come first in
// the grid. Tiles are copied into shared memory by all threads (no TMA, no
// pipelining), with rows padded so that reads hit distinct banks; the
// diagonal tile alone is masked. No atomics anywhere, so two calls give
// the same bits.
//   float32: every product in float32 FFMA with float32 sums (no TF32:
//   the port's float32 matmuls run at "highest" precision, and TF32 keeps
//   about three digits). 256 threads; thread (rg, cg) of a 16 x 16 grid
//   owns rows 4 rg .. 4 rg + 3 of the item and the columns cg + 16 j of
//   a 64-wide score tile (4) and of a D-wide output (D / 16): a score is
//   a dot product over D from shared memory, a row's softmax statistics
//   reduce over the 16 lanes of its row group, and p (or ds) goes through
//   shared memory into the products with v, k, dO or q. Softmax in the
//   log2 domain with exp2f (no fast math).
//   bf16: mma.sync.m16n8k16 (bf16 in, float32 accumulate) fed by
//   ldmatrix, 128 threads, each warp 16 rows of the item. p and ds round
//   to bf16 only as product operands, as in flash_attention.cu; the
//   C fragments of s = q k^T map onto the A fragments of p v. The dk/dv
//   kernel takes a query tile in two halves of 32 to keep its dk and dv
//   accumulators (D floats a thread at D = 128) out of local memory.
//   Why not templates of flash_attention.cu's wgmma/TMA design: its tile
//   shapes, 128-byte swizzle and register split are laid out around D =
//   64, the one width GPT-2's configurations use at full size; the other
//   widths run only in small configurations and tests, where a simple
//   kernel that is right is enough (a faster design is later work).
//
// Bound on an H100 SXM: the products' FLOPs (2 D a causal (query, key)
// pair and product: forward 2 products, dq 3, dk/dv 4) over 67 TFLOP/s
// in float32 or 989 in bf16, against the bytes of the operands and
// outputs over 3.35 TB/s. At (8, 1024, 12, 64) in float32: forward 12.9
// GFLOP, 0.19 ms; dq 19.4 GFLOP, 0.29 ms; dk/dv 25.8 GFLOP, 0.39 ms.
// These kernels issue a shared-memory load for every few FFMAs, so they
// are held well below that. Measured on an NVIDIA H100 80GB HBM3 at a
// 700 W limit (chip_smoke.py, (8, 1024, 768 / D, D), ms forward / dq /
// dk-dv): float32 D = 64 0.629 / 0.822 / 1.031 (SDPA forward 0.501),
// D = 16 0.788 / 1.104 / 1.490, D = 32 0.609 / 0.891 / 1.158, D = 128
// 0.587 / 1.112 / 1.363; bf16 D = 16 0.149 / 0.197 / 0.216 (SDPA forward
// 0.154), D = 32 0.128 / 0.179 / 0.206 (0.083), D = 128 0.083 / 0.117 /
// 0.161 (0.041; the bf16 bound is 0.015 ms by bytes). ptxas (sm_90a):
// 64 to 196 registers, no spills but 8 bytes in three instantiations and
// 28 in the bf16 dk/dv kernel at D = 128 (255 registers).
//
// Interface: plain C, loaded with ctypes. dtype 0 is float32, 1 bf16.
// Each function launches on the given stream and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a form or
// shape it does not take (the forms above; S a multiple of 64), or the
// error of raising the kernel's shared-memory limit.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;               // S must be a multiple of this
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long n, s, h;                    // sequence, position, head
};

Strides at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// The item of this CTA: (tile, head, sequence), the grid's nt H N blocks
// taken tile index first, so that the heaviest tiles start first: the
// last tile for the forward and dq (its rows see the most keys), the
// first for dk/dv (its keys see the most queries).
struct Item {
  int tile, h, n;
};

__device__ __forceinline__ Item item_of(int nt, int H, bool heavy_last) {
  const int per = gridDim.x / nt;               // H N items a tile index
  const int t = blockIdx.x / per;
  const int rem = blockIdx.x - t * per;
  return Item{heavy_last ? nt - 1 - t : t, rem % H, rem / H};
}

// Row `row` of head h of sequence n of a strided (N, S, H, D) operand.
template <typename T>
__device__ __forceinline__ T* at_row(T* p, Strides st, int n, int h,
                                     int row) {
  return p + n * st.n + h * st.h + static_cast<long long>(row) * st.s;
}

// ------------------------------------------------------------------------
// float32: FFMA on a 16 x 16 thread grid, 256 threads.

constexpr int kF32Threads = 256;

template <int D>
struct F32 {
  static constexpr int kPitch = D + 1;        // odd: rows on distinct banks
  static constexpr int kTileFloats = kTile * kPitch;
  static constexpr int kPPitch = kTile + 1;
  static constexpr int kPFloats = kTile * kPPitch;
  static constexpr int kCols = D / 16;        // output columns a thread
  static constexpr unsigned fwd_smem() {
    return 4u * (3 * kTileFloats + kPFloats);
  }
  static constexpr unsigned bwd_smem() {
    return 4u * (4 * kTileFloats + kPFloats);
  }
};

// 64 rows of D floats from global (row stride `ss` elements) to shared.
template <int D>
__device__ __forceinline__ void f32_load(float* dst, const float* src,
                                         long long ss) {
  for (int i = threadIdx.x; i < kTile * D; i += kF32Threads) {
    const int r = i / D, c = i - r * D;
    dst[r * F32<D>::kPitch + c] = src[r * ss + c];
  }
}

// acc[i][j] = A[4 rg + i] . B[cg + 16 j] over D, rows from shared memory.
template <int D>
__device__ __forceinline__ void f32_scores(const float* A, const float* B,
                                           int rg, int cg,
                                           float acc[4][4]) {
  constexpr int P = F32<D>::kPitch;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * rg + i) * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(cg + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[i][j] += sum_t W[4 rg + i][t] V[t][cg + 16 j] over the 64 rows t of
// a tile: W the (64, 64) weights in shared memory, V a (64, D) tile.
template <int D>
__device__ __forceinline__ void f32_accum(const float* W, const float* V,
                                          int rg, int cg,
                                          float out[4][F32<D>::kCols]) {
  constexpr int P = F32<D>::kPitch, PP = F32<D>::kPPitch;
#pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    float w[4], v[F32<D>::kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(4 * rg + i) * PP + t];
#pragma unroll
    for (int j = 0; j < F32<D>::kCols; ++j) v[j] = V[t * P + cg + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < F32<D>::kCols; ++j)
        out[i][j] = fmaf(w[i], v[j], out[i][j]);
  }
}

// Reductions over the 16 lanes of a row group (lanes differ in bits 0-3).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int S, int H, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale_log2) {
  extern __shared__ float smem[];
  using L = F32<D>;
  float* Qs = smem;
  float* Ks = Qs + L::kTileFloats;
  float* Vs = Ks + L::kTileFloats;
  float* Ps = Vs + L::kTileFloats;
  const int nt = S / kTile;
  const Item it = item_of(nt, H, true);
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int q0 = it.tile * kTile;
  f32_load<D>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s);
  float m[4], l[4], acc[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) acc[i][j] = 0.0f;
  }
  for (int kt = 0; kt <= it.tile; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                    // the last tile's reads are done
    f32_load<D>(Ks, at_row(k, sk, it.n, it.h, k0), sk.s);
    f32_load<D>(Vs, at_row(v, sv, it.n, it.h, k0), sv.s);
    __syncthreads();
    float s[4][4];
    f32_scores<D>(Qs, Ks, rg, cg, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale_log2;
        if (kt == it.tile && k0 + cg + 16 * j > row) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        Ps[(4 * rg + i) * L::kPPitch + cg + 16 * j] = p;
      }
      l[i] = l[i] * alpha + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < L::kCols; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();                       // a row group's p rows: its warp
    f32_accum<D>(Ps, Vs, rg, cg, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    float* orow = at_row(o, so, it.n, it.h, row);
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) orow[cg + 16 * j] = acc[i][j] / l[i];
    if (cg == 0)
      lse[(static_cast<long long>(it.n) * H + it.h) * S + row] =
          (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  float* __restrict__ dq, int S, int H, Strides sq,
                  Strides sk, Strides sv, Strides so, Strides sdo,
                  Strides sdq, float scale, float scale_log2) {
  extern __shared__ float smem[];
  using L = F32<D>;
  float* Qs = smem;
  float* dOs = Qs + L::kTileFloats;
  float* Ks = dOs + L::kTileFloats;
  float* Vs = Ks + L::kTileFloats;
  float* Ps = Vs + L::kTileFloats;
  const int nt = S / kTile;
  const Item it = item_of(nt, H, true);
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int q0 = it.tile * kTile;
  const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
  f32_load<D>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s);
  f32_load<D>(dOs, at_row(dout, sdo, it.n, it.h, q0), sdo.s);
  f32_load<D>(Ks, at_row(o, so, it.n, it.h, q0), so.s);   // O, for delta
  __syncthreads();
  float dl[4], ls[4], acc[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < L::kCols; ++j)
      part = fmaf(dOs[r * L::kPitch + cg + 16 * j],
                  Ks[r * L::kPitch + cg + 16 * j], part);
    dl[i] = sum16(part);
    if (cg == 0) delta[stat + q0 + r] = dl[i];
    ls[i] = lse[stat + q0 + r] * kLog2e;
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) acc[i][j] = 0.0f;
  }
  for (int kt = 0; kt <= it.tile; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    f32_load<D>(Ks, at_row(k, sk, it.n, it.h, k0), sk.s);
    f32_load<D>(Vs, at_row(v, sv, it.n, it.h, k0), sv.s);
    __syncthreads();
    float s[4][4], dp[4][4];
    f32_scores<D>(Qs, Ks, rg, cg, s);
    f32_scores<D>(dOs, Vs, rg, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = kt == it.tile && k0 + cg + 16 * j > row;
        const float p = masked ? 0.0f : exp2f(s[i][j] * scale_log2 - ls[i]);
        Ps[(4 * rg + i) * L::kPPitch + cg + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncwarp();
    f32_accum<D>(Ps, Ks, rg, cg, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = at_row(dq, sdq, it.n, it.h, q0 + 4 * rg + i);
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) row[cg + 16 * j] = acc[i][j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int S, int H, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdk,
                   Strides sdv, float scale, float scale_log2) {
  extern __shared__ float smem[];
  using L = F32<D>;
  float* Ks = smem;
  float* Vs = Ks + L::kTileFloats;
  float* Qs = Vs + L::kTileFloats;
  float* dOs = Qs + L::kTileFloats;
  float* Ps = dOs + L::kTileFloats;
  const int nt = S / kTile;
  const Item it = item_of(nt, H, false);
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int k0 = it.tile * kTile;
  const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
  f32_load<D>(Ks, at_row(k, sk, it.n, it.h, k0), sk.s);
  f32_load<D>(Vs, at_row(v, sv, it.n, it.h, k0), sv.s);
  float gk[4][L::kCols], gv[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) gk[i][j] = gv[i][j] = 0.0f;
  for (int qt = it.tile; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    f32_load<D>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s);
    f32_load<D>(dOs, at_row(dout, sdo, it.n, it.h, q0), sdo.s);
    __syncthreads();
    float ls[4], dl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ls[j] = lse[stat + q0 + cg + 16 * j] * kLog2e;
      dl[j] = delta[stat + q0 + cg + 16 * j];
    }
    float st[4][4], dpt[4][4];          // [key][query]
    f32_scores<D>(Ks, Qs, rg, cg, st);
    f32_scores<D>(Vs, dOs, rg, cg, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = qt == it.tile && q0 + cg + 16 * j < key;
        const float p = masked ? 0.0f : exp2f(st[i][j] * scale_log2 - ls[j]);
        Ps[(4 * rg + i) * L::kPPitch + cg + 16 * j] = p;
        dpt[i][j] = p * (dpt[i][j] - dl[j]);
      }
    }
    __syncwarp();
    f32_accum<D>(Ps, dOs, rg, cg, gv);  // dv += p^T dO
    __syncwarp();                       // every lane has read p
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * rg + i) * L::kPPitch + cg + 16 * j] = dpt[i][j];
    __syncwarp();
    f32_accum<D>(Ps, Qs, rg, cg, gk);   // dk += ds^T q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* krow = at_row(dk, sdk, it.n, it.h, k0 + 4 * rg + i);
    float* vrow = at_row(dv, sdv, it.n, it.h, k0 + 4 * rg + i);
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) {
      krow[cg + 16 * j] = gk[i][j] * scale;
      vrow[cg + 16 * j] = gv[i][j];
    }
  }
}

// ------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 fed by ldmatrix, 4 warps of 16 rows each.

constexpr int kBfThreads = 128;

template <int D>
struct Bf {
  static constexpr int kPitch = D + 8;        // +16 bytes: ldmatrix's 8
                                              // rows fall on distinct banks
  static constexpr int kTileElems = kTile * kPitch;
  static constexpr int kNt = D / 8;           // output n-tiles of a warp
  static constexpr unsigned fwd_smem() { return 2u * 3 * kTileElems; }
  static constexpr unsigned dq_smem() {
    return 2u * 4 * kTileElems + 4u * kTile;
  }
  static constexpr unsigned dkv_smem() {
    return 2u * 4 * kTileElems + 8u * kTile;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 rows of D bf16 from global (row stride `ss` elements, rows 16-byte
// aligned) to shared, 16 bytes a thread at a time.
template <int D>
__device__ __forceinline__ void bf_load(bf16* dst, const bf16* src,
                                        long long ss) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < kTile * C; i += kBfThreads) {
    const int r = i / C, c = i - r * C;
    *reinterpret_cast<uint4*>(dst + r * Bf<D>::kPitch + 8 * c) =
        *reinterpret_cast<const uint4*>(src + r * ss + 8 * c);
  }
}

// c[t] (t < NT n-tiles of 8) = A[16 rows] B[8 NT rows]^T over D: A's rows
// from `a` (this warp's first row), B's from `b`, both row-major in shared
// memory. The C fragment: c[t][0..1] row g, columns 8 t + 2 tig + {0, 1};
// c[t][2..3] row g + 8 (g = lane / 4, tig = lane % 4).
template <int D, int NT>
__device__ __forceinline__ void mma_abt(const bf16* a, const bf16* b,
                                        int lane, float c[NT][4]) {
  constexpr int P = Bf<D>::kPitch;
#pragma unroll
  for (int t = 0; t < NT; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.0f;
  const uint32_t a_lane = smem_addr(
      a + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
  const uint32_t b_lane = smem_addr(
      b + ((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_lane + 32 * kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[4];
      ldsm_x4(bfr, b_lane + 2 * (16 * np * P + 16 * kk));
      mma(c[2 * np], af, bfr[0], bfr[1]);
      mma(c[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// out[t] (D / 8 n-tiles) += W[16 rows][16 KS] V[16 KS rows][D]: W the C
// fragments of a 16 x 16 KS product (rounded to bf16 here), V row-major
// in shared memory from `v` (read transposed by ldmatrix).
template <int D, int KS>
__device__ __forceinline__ void mma_wv(const float w[2 * KS][4],
                                       const bf16* v, int lane,
                                       float out[Bf<D>::kNt][4]) {
  constexpr int P = Bf<D>::kPitch;
  const uint32_t v_lane = smem_addr(
      v + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t af[4] = {pack(w[2 * kk][0], w[2 * kk][1]),
                            pack(w[2 * kk][2], w[2 * kk][3]),
                            pack(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                            pack(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, v_lane + 2 * (16 * kk * P + 16 * dp));
      mma(out[2 * dp], af, bfr[0], bfr[1]);
      mma(out[2 * dp + 1], af, bfr[2], bfr[3]);
    }
  }
}

// Reductions over the quad that holds a row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Write a warp's 16 x D float32 accumulator as bf16 rows, times `scale`.
template <int D>
__device__ __forceinline__ void bf_store(bf16* p, Strides st, int n, int h,
                                         int row0, int lane,
                                         const float acc[Bf<D>::kNt][4],
                                         float s0, float s1) {
  const int g = lane >> 2, tig = lane & 3;
  bf16* r0 = at_row(p, st, n, h, row0 + g);
  bf16* r1 = at_row(p, st, n, h, row0 + g + 8);
#pragma unroll
  for (int t = 0; t < Bf<D>::kNt; ++t) {
    const int col = 8 * t + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(r0 + col) =
        __floats2bfloat162_rn(acc[t][0] * s0, acc[t][1] * s0);
    *reinterpret_cast<__nv_bfloat162*>(r1 + col) =
        __floats2bfloat162_rn(acc[t][2] * s1, acc[t][3] * s1);
  }
}

template <int D>
__global__ void __launch_bounds__(kBfThreads)
    fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int H, Strides sq,
                    Strides sk, Strides sv, Strides so, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using L = Bf<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::kTileElems;
  bf16* Vs = Ks + L::kTileElems;
  const int nt = S / kTile;
  const Item it = item_of(nt, H, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = it.tile * kTile;
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  bf_load<D>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[L::kNt][4];
#pragma unroll
  for (int t = 0; t < L::kNt; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  for (int kt = 0; kt <= it.tile; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    bf_load<D>(Ks, at_row(k, sk, it.n, it.h, k0), sk.s);
    bf_load<D>(Vs, at_row(v, sv, it.n, it.h, k0), sv.s);
    __syncthreads();
    float s[8][4];
    mma_abt<D, 8>(Qs + 16 * warp * L::kPitch, Ks, lane, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale_log2;
        if (kt == it.tile && k0 + 8 * t + 2 * tig + (e & 1) > rows[e >> 1])
          x = -INFINITY;
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = exp2f(s[t][e] - m[e >> 1]);
        sum[e >> 1] += s[t][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int t = 0; t < L::kNt; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }
    mma_wv<D, 4>(s, Vs, lane, acc);
  }
  bf_store<D>(o, so, it.n, it.h, q0 + 16 * warp, lane, acc, 1.0f / l[0],
              1.0f / l[1]);
  if (tig == 0) {
    const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[stat + rows[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int D>
__global__ void __launch_bounds__(kBfThreads)
    dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   bf16* __restrict__ dq, int S, int H, Strides sq,
                   Strides sk, Strides sv, Strides so, Strides sdo,
                   Strides sdq, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using L = Bf<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + L::kTileElems;
  bf16* Ks = dOs + L::kTileElems;
  bf16* Vs = Ks + L::kTileElems;
  float* dls = reinterpret_cast<float*>(Vs + L::kTileElems);
  const int nt = S / kTile;
  const Item it = item_of(nt, H, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = it.tile * kTile;
  const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
  bf_load<D>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s);
  bf_load<D>(dOs, at_row(dout, sdo, it.n, it.h, q0), sdo.s);
  bf_load<D>(Ks, at_row(o, so, it.n, it.h, q0), so.s);   // O, for delta
  __syncthreads();
  {
    // delta of row tid / 2 from the two halves of its D columns
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const bf16* a = dOs + r * L::kPitch + half * (D / 2);
    const bf16* b = Ks + r * L::kPitch + half * (D / 2);
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      part = fmaf(__bfloat162float(a[c]), __bfloat162float(b[c]), part);
    part += __shfl_xor_sync(kFull, part, 1);
    if (half == 0) {
      dls[r] = part;
      delta[stat + q0 + r] = part;
    }
  }
  __syncthreads();
  const int rl[2] = {16 * warp + g, 16 * warp + g + 8};
  const float ls[2] = {lse[stat + q0 + rl[0]] * kLog2e,
                       lse[stat + q0 + rl[1]] * kLog2e};
  const float dl[2] = {dls[rl[0]], dls[rl[1]]};
  float acc[L::kNt][4];
#pragma unroll
  for (int t = 0; t < L::kNt; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  for (int kt = 0; kt <= it.tile; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    bf_load<D>(Ks, at_row(k, sk, it.n, it.h, k0), sk.s);
    bf_load<D>(Vs, at_row(v, sv, it.n, it.h, k0), sv.s);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_abt<D, 8>(Qs + 16 * warp * L::kPitch, Ks, lane, s);
    mma_abt<D, 8>(dOs + 16 * warp * L::kPitch, Vs, lane, dp);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked = kt == it.tile &&
                            k0 + 8 * t + 2 * tig + (e & 1) > q0 + rl[r];
        const float p =
            masked ? 0.0f : exp2f(s[t][e] * scale_log2 - ls[r]);
        s[t][e] = p * (dp[t][e] - dl[r]);
      }
    mma_wv<D, 4>(s, Ks, lane, acc);     // dq += ds k
  }
  bf_store<D>(dq, sdq, it.n, it.h, q0 + 16 * warp, lane, acc, scale, scale);
}

template <int D>
__global__ void __launch_bounds__(kBfThreads)
    dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int H, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdk,
                    Strides sdv, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using L = Bf<D>;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + L::kTileElems;
  bf16* Qs = Vs + L::kTileElems;
  bf16* dOs = Qs + L::kTileElems;
  float* lss = reinterpret_cast<float*>(dOs + L::kTileElems);
  float* dls = lss + kTile;
  const int nt = S / kTile;
  const Item it = item_of(nt, H, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = it.tile * kTile;
  const int keys[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
  bf_load<D>(Ks, at_row(k, sk, it.n, it.h, k0), sk.s);
  bf_load<D>(Vs, at_row(v, sv, it.n, it.h, k0), sv.s);
  float gk[L::kNt][4], gv[L::kNt][4];
#pragma unroll
  for (int t = 0; t < L::kNt; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[t][e] = gv[t][e] = 0.0f;
  for (int qt = it.tile; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    bf_load<D>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s);
    bf_load<D>(dOs, at_row(dout, sdo, it.n, it.h, q0), sdo.s);
    if (threadIdx.x < kTile) {
      lss[threadIdx.x] = lse[stat + q0 + threadIdx.x] * kLog2e;
      dls[threadIdx.x] = delta[stat + q0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int h0 = 32 * half;         // the half's first query of the tile
      float st[4][4], dpt[4][4];        // [key][query]
      mma_abt<D, 4>(Ks + 16 * warp * L::kPitch, Qs + h0 * L::kPitch, lane,
                    st);
      mma_abt<D, 4>(Vs + 16 * warp * L::kPitch, dOs + h0 * L::kPitch, lane,
                    dpt);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = h0 + 8 * t + 2 * tig + (e & 1);
          const bool masked = qt == it.tile && q0 + ql < keys[e >> 1];
          const float p =
              masked ? 0.0f : exp2f(st[t][e] * scale_log2 - lss[ql]);
          st[t][e] = p;
          dpt[t][e] = p * (dpt[t][e] - dls[ql]);
        }
      mma_wv<D, 2>(st, dOs + h0 * L::kPitch, lane, gv);   // dv += p^T dO
      mma_wv<D, 2>(dpt, Qs + h0 * L::kPitch, lane, gk);   // dk += ds^T q
    }
  }
  bf_store<D>(dk, sdk, it.n, it.h, k0 + 16 * warp, lane, gk, scale, scale);
  bf_store<D>(dv, sdv, it.n, it.h, k0 + 16 * warp, lane, gv, 1.0f, 1.0f);
}

// ------------------------------------------------------------------------
// Host side.

bool bad_shape(int N, int S, int H) {
  return S <= 0 || S % kTile != 0 || N <= 0 || H <= 0 ||
         static_cast<long long>(S / kTile) * H * N > 0x7fffffffLL;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, unsigned bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

unsigned grid_of(int N, int S, int H) {
  return static_cast<unsigned>((S / kTile) * H * N);
}

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
            int N, int S, int H, const long long* st, float scale_log2,
            cudaStream_t stream) {
  const unsigned smem = F32<D>::fwd_smem();
  const cudaError_t err = set_smem(fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_f32_kernel<D><<<grid_of(N, S, H), kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, S,
      H, at(st, 0), at(st, 1), at(st, 2), at(st, 3), scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* o,
             float* lse, int N, int S, int H, const long long* st,
             float scale_log2, cudaStream_t stream) {
  const unsigned smem = Bf<D>::fwd_smem();
  const cudaError_t err = set_smem(fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_bf16_kernel<D><<<grid_of(N, S, H), kBfThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, S, H,
      at(st, 0), at(st, 1), at(st, 2), at(st, 3), scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int dq_f32(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, int N,
           int S, int H, const long long* st, float scale,
           cudaStream_t stream) {
  const unsigned smem = F32<D>::bwd_smem();
  const cudaError_t err = set_smem(dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dq_f32_kernel<D><<<grid_of(N, S, H), kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, lse, delta, (float*)dq, S, H, at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), at(st, 4), at(st, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int dq_bf16(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const float* lse, float* delta, void* dq,
            int N, int S, int H, const long long* st, float scale,
            cudaStream_t stream) {
  const unsigned smem = Bf<D>::dq_smem();
  const cudaError_t err = set_smem(dq_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dq_bf16_kernel<D><<<grid_of(N, S, H), kBfThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, lse, delta, (bf16*)dq, S, H, at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), at(st, 4), at(st, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int N,
            int S, int H, const long long* st, float scale,
            cudaStream_t stream) {
  const unsigned smem = F32<D>::bwd_smem();
  const cudaError_t err = set_smem(dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dkv_f32_kernel<D><<<grid_of(N, S, H), kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, S, H, at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), at(st, 4), at(st, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv,
             int N, int S, int H, const long long* st, float scale,
             cudaStream_t stream) {
  const unsigned smem = Bf<D>::dkv_smem();
  const cudaError_t err = set_smem(dkv_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dkv_bf16_kernel<D><<<grid_of(N, S, H), kBfThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, S, H, at(st, 0), at(st, 1), at(st, 2),
      at(st, 3), at(st, 4), at(st, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry point per form, named as ops/flash_attention.py counts its
// launches, each with flash_attention.cu's signature (D must be the
// form's): float32 at D = 16, 32, 64, 128; bf16 at D = 16, 32, 128 (bf16
// at D = 64 is flash_attention.cu's). Strides: forward q, k, v, o; dq q,
// k, v, o, dO, dq (it writes delta (N, H, S) float32); dk/dv q, k, v, dO,
// dk, dv (it reads the delta that dq wrote).
#define FLASH_TILED_FORM(TAG, DIM)                                           \
  extern "C" int flash_fwd_##TAG##_d##DIM(                                   \
      const void* q, const void* k, const void* v, void* o, float* lse,      \
      int N, int S, int H, int D, const long long* strides, float scale,     \
      void* stream) {                                                        \
    if (D != DIM || bad_shape(N, S, H)) return (int)cudaErrorInvalidValue;   \
    return fwd_##TAG<DIM>(q, k, v, o, lse, N, S, H, strides,                 \
                          scale * kLog2e, (cudaStream_t)stream);             \
  }                                                                          \
  extern "C" int flash_bwd_dq_##TAG##_d##DIM(                                \
      const void* q, const void* k, const void* v, const void* o,            \
      const void* dout, const float* lse, float* delta, void* dq, int N,     \
      int S, int H, int D, const long long* strides, float scale,            \
      void* stream) {                                                        \
    if (D != DIM || bad_shape(N, S, H)) return (int)cudaErrorInvalidValue;   \
    return dq_##TAG<DIM>(q, k, v, o, dout, lse, delta, dq, N, S, H,          \
                         strides, scale, (cudaStream_t)stream);              \
  }                                                                          \
  extern "C" int flash_bwd_dkv_##TAG##_d##DIM(                               \
      const void* q, const void* k, const void* v, const void* dout,         \
      const float* lse, const float* delta, void* dk, void* dv, int N,       \
      int S, int H, int D, const long long* strides, float scale,            \
      void* stream) {                                                        \
    if (D != DIM || bad_shape(N, S, H)) return (int)cudaErrorInvalidValue;   \
    return dkv_##TAG<DIM>(q, k, v, dout, lse, delta, dk, dv, N, S, H,        \
                          strides, scale, (cudaStream_t)stream);             \
  }

FLASH_TILED_FORM(f32, 16)
FLASH_TILED_FORM(f32, 32)
FLASH_TILED_FORM(f32, 64)
FLASH_TILED_FORM(f32, 128)
FLASH_TILED_FORM(bf16, 16)
FLASH_TILED_FORM(bf16, 32)
FLASH_TILED_FORM(bf16, 128)

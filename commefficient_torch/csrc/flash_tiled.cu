// Causal flash attention for Hopper (sm_90a) in the kernels that
// csrc/flash_attention.cu does not hold: float32 at head widths D = 16,
// 32, 64 and 128 (forward, dq, dk/dv) and the bf16 forward at D = 16 (its
// dq and dk/dv, and every bf16 kernel at D = 32, 64 and 128, are
// flash_attention.cu's wgmma kernels).
//
// Replaces, in those forms, the same library Pallas TPU kernels as
// flash_attention.cu (jax.experimental.pallas.ops.tpu.flash_attention,
// called by the JAX package's models/gpt2.py flash_causal_attention, which
// sets no condition on the dtype or on D):
//   flash_fwd_<f32|bf16>_d<D>  <- _flash_attention_impl
//   flash_bwd_dq_f32_d<D>      <- _flash_attention_bwd_dq
//   flash_bwd_dkv_f32_d<D>     <- _flash_attention_bwd_dkv
// It computes what flash_attention.cu computes (see its note): o and the
// float32 lse (N, H, S) forward; dq and delta = rowsum(dO o), written for
// the dk/dv kernel, launched after it on the same stream; dk and dv. The
// operands are (N, S, H, D) tensors given by a base pointer and three
// element strides (sequence, position, head), last dimension contiguous.
//
// Design: tiled kernels. A CTA owns one work item, a tile of queries
// (forward, dq: 64 rows; the bf16 forward 128) or 64 keys (dk/dv) of one
// head of one sequence, and walks the other side's 64-row tiles in a
// loop: the keys up to the diagonal, or the queries from it. Heaviest
// items come first in the grid. Rows in shared memory are padded so that
// reads hit distinct banks; the diagonal tile alone is masked. No atomics
// anywhere, so two calls give the same bits. Softmax in the log2 domain,
// with exp2f (no fast math) but in the bf16 forward.
//   float32 (forward, dq, dk/dv): mma.sync.m16n8k8 on the TF32 tensor cores
//   with a 3xTF32 split, 128 threads, each warp 16 rows of the item. An
//   operand x is split into hi = tf32(x) and lo = tf32(x - hi) (rounded to
//   nearest, ties away, by an add and a mask), and a product is a_lo b_hi +
//   a_hi b_lo + a_hi b_hi (lo lo, 2^-22 of it, is left out): about 21 bits
//   of each operand, where one TF32 product keeps 11 and misses the float32
//   check more than ten times over (tests/test_torch_attention.py emulates
//   both). Each of the three terms runs over several independent
//   accumulators in turn, so that two MMAs on one accumulator are never back
//   to back: with one or two warps a scheduler, that is what hides the MMAs'
//   latency. The tile that every warp reads as the B operand (K, V in the
//   forward and dq; q, dO in dk/dv) is split once where it is staged, into a
//   hi and a lo plane; a warp's own rows (the A operand) stay float32 and
//   are split as they are read, except K and V at D = 128, where dk/dv
//   stages 32 queries at a time and so has room for their planes. p and ds
//   go from the C fragment of s (row g, columns 2 tig, 2 tig + 1 of each
//   8-column n-tile) into the A fragment of the next product (columns tig,
//   tig + 4) as they lie: the k-step is reordered to match, and B's rows are
//   read in that order, so no shuffle. The tensor cores truncate their sums,
//   so each 16 x 8 output tile of o += p v, dq += ds k, dv += p^T dO and dk
//   += ds^T q sums one stage (up to 64 keys or queries) from zero and is
//   added to its accumulator in float32 (the forward's after the online
//   softmax's rescale of it): a sum over S kept on the tensor cores drifted
//   to 1.8e-5 of the largest dk at S = 1024, against 4.3e-6 at most this
//   way. What is left comes from those truncating sums, not from the split:
//   summed in float32, 3xTF32 products read at most 1.4e-6 of the largest
//   value, and a model of the tensor cores' sums, stage by stage as here,
//   9.5e-7 to 4.5e-6 (tests/test_torch_attention.py, S = 256). p = exp2f(s
//   log2(e) / sqrt(D) - lse log2(e)) in the backward. Rows are D + 4 floats:
//   every fragment read (row g or 2 tig, column tig or g) hits 32 distinct
//   banks. The forward copies K and V by cp.async into their hi planes and
//   splits them there in place (q and the hi and lo planes of K and V: 5
//   tiles, 169 KB at D = 128), each copy in flight while the other operand's
//   product runs. The dq kernel loads the next K and V tile into registers
//   while it computes (D <= 64). dk and dv at D = 128 take their queries in
//   stages of 32 to keep their accumulators (D floats a thread) in
//   registers. Why mma.sync and not wgmma: wgmma takes TF32 operands only
//   K-major, so ds k and ds^T q would need transposed copies of ds, k and q
//   in shared memory.
//   bf16 forward: mma.sync.m16n8k16 (bf16 in, float32 accumulate) fed by
//   ldmatrix. p rounds to bf16 only as a product operand, as in
//   flash_attention.cu; the C fragments of s = q k^T map onto the A
//   fragments of p v. It takes 128 queries with 4 warps
//   of 32 rows (two m-tiles sharing each K and V fragment that ldmatrix
//   reads, where with 16 rows a warp one 512-byte ldmatrix fed two MMAs), so
//   each K and V tile that crosses from L2 serves twice the queries of a
//   64-query item; it copies K and V by cp.async through two stages, one
//   __syncthreads a tile, the next tile's copy in flight during this tile's
//   products (rows of D + 8: ldmatrix's eight 16-byte rows fall on distinct
//   banks), and takes exp2 from the special-function unit with the scale
//   folded into its FFMA, as flash_attention.cu does. It is instantiated
//   at D = 16 only, where it beats SDPA's forward: at D = 32 and 128 it
//   lost to cuDNN's wgmma forward by 1.1 and 1.5 times and gave way to
//   flash_attention.cu's wgmma forward template, as the bf16 dq and dk/dv
//   that were here (128 threads of 16 rows, synchronous tile loads; 1.5
//   and 1.9 times SDPA's backward at D = 32 and 128) gave way, at every
//   D, to its backward templates.
//
// Bound on an H100 SXM: the products' FLOPs (2 D a causal (query, key)
// pair and product: forward 2 products, dq 3, dk/dv 4) over 989 TFLOP/s
// in bf16 or, in float32, 3 x FLOPs over 495 TFLOP/s (the TF32 tensor
// cores in 3xTF32), against the bytes of the operands and outputs over
// 3.35 TB/s. At (8, 1024, 12, 64) in float32: forward 12.9 GFLOP, dq
// 19.4, dk/dv 25.8: 0.078 / 0.117 / 0.156 ms (at the FFMA rate, 67
// TFLOP/s: 0.19 / 0.29 / 0.39). Measured on an NVIDIA H100 80GB HBM3 at
// a 700 W limit (scripts/k3_tiled_ab.py, (8, 1024, 768 / D, D), ms forward
// / dq / dk-dv): float32 D = 16 0.330 / 0.424 / 0.524 (SDPA forward 1.47,
// backward 3.57), D = 32 0.288 / 0.357 / 0.471 (0.781, 1.91), D = 64
// 0.300 / 0.372 / 0.459 (0.497, 1.20), D = 128 0.368 / 0.456 / 0.696
// (0.376, 1.22): the forward 21-27% of its bound, the backward 22-34%, each
// below SDPA's float32 kernels (themselves 3xTF32 mma.sync: PyTorch's
// memory-efficient kernels); at D = 128 dk/dv's K, V and 32-query stages
// fill 203 KB of shared memory, one CTA of 4 warps an SM, whose stage
// loads nothing hides. The bf16 forward at D = 16 0.131 (SDPA 0.154; the
// bf16 bound is 0.015 ms by bytes). ptxas (sm_90a): the float32 forward 96
// to 255 registers (48 and 16 bytes spilled at D = 64 and 128), the
// backward 156 to 255 (32 bytes spilled in dk/dv at D = 128); the bf16
// forward 158, no spills.
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// given stream and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a form or shape it does not take (the forms
// above; S a multiple of 64), or the error of raising the kernel's
// shared-memory limit.

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async: 16 bytes from global to shared, bypassing L1 (.cg); the
// copies a thread issued since its last commit form one group, and
// wait<N> returns once all but its N most recent groups have landed (for
// this thread's own copies: a __syncthreads after it shows them to all)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of D elements from global (row stride `ss` elements, rows
// 16-byte aligned) into shared rows of Pitch elements: thread t copies
// the 16-byte chunks t, t + Threads, ... (chunk i: row i / (chunks a row))
template <typename T, int D, int Pitch, int Threads>
__device__ __forceinline__ void cp_rows(T* dst, const T* src, long long ss,
                                        int rows) {
  constexpr int C = D * static_cast<int>(sizeof(T)) / 16;  // chunks a row
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < rows * C; i += Threads) {
    const int r = i / C, c = i - r * C;
    cp_async16(dst + r * Pitch + E * c, src + r * ss + E * c);
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

// ------------------------------------------------------------------------
// float32 backward: mma.sync m16n8k8 on the TF32 tensor cores, each
// product in three (3xTF32), float32 accumulation; 4 warps of 16 rows.

constexpr int kTfThreads = 128;

template <int D>
struct Tf {
  // D + 4 floats a row: the fragments' reads (row g or 2 tig, column tig
  // or g) fall on 32 distinct banks at every D (see the header note)
  static constexpr int kPitch = D + 4;
  static constexpr int kTileFloats = kTile * kPitch;
  static constexpr int kNt = D / 8;           // output n-tiles of a warp
  // the dq kernel loads the next K and V tile into registers while it
  // computes with the current one (D floats a thread), up to D = 64; at
  // D = 128 there is no room
  static constexpr bool kDqPrefetch = D <= 64;
  // forward: q as read; K and V each a hi and a lo plane, copied as read
  // into the hi plane and split there
  static constexpr unsigned fwd_smem() { return 4u * 5 * kTileFloats; }
  // dq: q and dO as read, K and V split into hi and lo planes, delta
  static constexpr unsigned dq_smem() {
    return 4u * (6 * kTileFloats + kTile);
  }
  // dk/dv: the queries staged at a time, a whole tile or, at D = 128, 32
  // rows (which keeps the dk and dv accumulators in registers); K and V
  // as read, or at D = 128 split once into planes, which that shorter
  // stage leaves room for (a warp's K and V rows would otherwise be split
  // again for every 32 queries)
  static constexpr int kCols = D > 64 ? 32 : kTile;
  static constexpr bool kKvPlanes = D > 64;
  static constexpr unsigned dkv_smem() {
    return 4u * ((kKvPlanes ? 4 : 2) * kTileFloats + 4 * kCols * kPitch +
                 2 * kCols);
  }
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi) (the difference
// is exact), about 21 bits of x's 24 together
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b, one m16n8k8 TF32 product. A product in 3xTF32 is three of
// them, the two small terms first: c += a_lo b_hi, c += a_hi b_lo, c +=
// a_hi b_hi (a_lo b_lo, about 2^-22 of the product, is left out). The
// callers issue each term over several independent accumulators in turn,
// so that two MMAs on one accumulator are not back to back (with one warp
// a scheduler, nothing else would hide the wait between them).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 rows of D floats from global (row stride `ss` elements, rows 16-byte
// aligned) to shared as read, 16 bytes a thread at a time.
template <int D>
__device__ __forceinline__ void tf_load(float* dst, const float* src,
                                        long long ss) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < kTile * C; i += kTfThreads) {
    const int r = i / C, c = i - r * C;
    *reinterpret_cast<float4*>(dst + r * Tf<D>::kPitch + 4 * c) =
        *reinterpret_cast<const float4*>(src + r * ss + 4 * c);
  }
}

// A thread's share (Rows D / 512 float4) of Rows rows of D floats from
// global (row stride `ss` elements, rows 16-byte aligned), into registers.
template <int D, int Rows = kTile>
__device__ __forceinline__ void tf_fetch(float4 (&r)[Rows * D / 512],
                                         const float* src, long long ss) {
  constexpr int C = D / 4;
#pragma unroll
  for (int i = 0; i < Rows * D / 512; ++i) {
    const int idx = threadIdx.x + i * kTfThreads;
    const int row = idx / C, c = idx - row * C;
    r[i] = *reinterpret_cast<const float4*>(src + row * ss + 4 * c);
  }
}

// The rows tf_fetch read, split once into a hi and a lo plane of TF32
// values in shared memory.
template <int D, int Rows = kTile>
__device__ __forceinline__ void tf_stage(uint32_t* hi, uint32_t* lo,
                                         const float4 (&r)[Rows * D / 512]) {
  constexpr int C = D / 4;
#pragma unroll
  for (int i = 0; i < Rows * D / 512; ++i) {
    const int idx = threadIdx.x + i * kTfThreads;
    const int row = idx / C, c = idx - row * C;
    uint4 h, l;
    split(r[i].x, h.x, l.x);
    split(r[i].y, h.y, l.y);
    split(r[i].z, h.z, l.z);
    split(r[i].w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + row * Tf<D>::kPitch + 4 * c) = h;
    *reinterpret_cast<uint4*>(lo + row * Tf<D>::kPitch + 4 * c) = l;
  }
}

// An A operand already split into hi and lo planes.
struct Planes {
  const uint32_t* hi;
  const uint32_t* lo;
};

// The A fragment at `o` (rows g, g + 8 at `o` and `o + R`, columns tig,
// tig + 4): float32 rows split as they are read, or a pair of planes.
template <int R>
__device__ __forceinline__ void frag_a(const float* a, int o, uint32_t ah[4],
                                       uint32_t al[4]) {
  split(a[o], ah[0], al[0]);
  split(a[o + R], ah[1], al[1]);
  split(a[o + 4], ah[2], al[2]);
  split(a[o + R + 4], ah[3], al[3]);
}

template <int R>
__device__ __forceinline__ void frag_a(Planes a, int o, uint32_t ah[4],
                                       uint32_t al[4]) {
  const int at[4] = {o, o + R, o + 4, o + R + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ah[e] = a.hi[at[e]];
    al[e] = a.lo[at[e]];
  }
}

// c[t] (t < NT n-tiles of 8) = A[16 rows] B[8 NT rows]^T over D in
// 3xTF32: A's rows from `a` (this warp's first row): float32, split as
// they are read (a warp reads only its own rows), or Planes; B's rows
// from the planes bh, bl. The A fragment: rows g, g + 8, columns 8 kk +
// tig, + 4; B's: row 8 t + g, the same columns; C: c[t][0..1] row g,
// columns 8 t + 2 tig + {0, 1}, c[t][2..3] row g + 8 (g = lane / 4, tig
// = lane % 4). Each term runs over the NT n-tiles in turn.
template <int D, int NT, typename A>
__device__ __forceinline__ void tf_abt(A a, const uint32_t* bh,
                                       const uint32_t* bl, int lane,
                                       float c[NT][4]) {
  constexpr int P = Tf<D>::kPitch;
  const int at = (lane >> 2) * P + (lane & 3);
#pragma unroll
  for (int t = 0; t < NT; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int o = at + 8 * kk;
    uint32_t ah[4], al[4];
    frag_a<8 * P>(a, o, ah, al);
    uint32_t b_h[NT][2], b_l[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int b = o + 8 * t * P;
      b_h[t][0] = bh[b];
      b_h[t][1] = bh[b + 4];
      b_l[t][0] = bl[b];
      b_l[t][1] = bl[b + 4];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(c[t], al, b_h[t][0], b_h[t][1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(c[t], ah, b_l[t][0], b_l[t][1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(c[t], ah, b_h[t][0], b_h[t][1]);
  }
}

// out[j] (D / 8 n-tiles) += W[16 rows][8 KS] V[8 KS rows][D]: W the C
// fragments of a 16 x 8 KS product (split here), V's rows from the planes
// vh, vl. The C fragment of n-tile t is taken as the A fragment of k-step
// t as it lies, which reorders the step's k: A's columns tig and tig + 4
// hold W's columns 8 t + 2 tig and 8 t + 2 tig + 1, so B reads V's rows
// 8 t + 2 tig and 8 t + 2 tig + 1 (column 8 j + g). No shuffles. The
// n-tiles go in groups of G, each term over the group in turn; each
// n-tile's KS k-steps sum from zero on the tensor cores and then add to
// out[j] in float32: the tensor cores' sums truncate, so a long sum kept
// there (dk over up to S queries) would drift toward zero.
template <int D, int KS>
__device__ __forceinline__ void tf_wv(const float w[KS][4],
                                      const uint32_t* vh, const uint32_t* vl,
                                      int lane, float out[Tf<D>::kNt][4]) {
  constexpr int P = Tf<D>::kPitch;
  const int vt = 2 * (lane & 3) * P + (lane >> 2);
  uint32_t ah[KS][4], al[KS][4];
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    split(w[t][0], ah[t][0], al[t][0]);
    split(w[t][2], ah[t][1], al[t][1]);
    split(w[t][1], ah[t][2], al[t][2]);
    split(w[t][3], ah[t][3], al[t][3]);
  }
  constexpr int G = Tf<D>::kNt < 4 ? Tf<D>::kNt : 4;
#pragma unroll
  for (int j0 = 0; j0 < Tf<D>::kNt; j0 += G) {
    float c[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) c[g][0] = c[g][1] = c[g][2] = c[g][3] = 0.0f;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      uint32_t b_h[G][2], b_l[G][2];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int b = vt + 8 * t * P + 8 * (j0 + g);
        b_h[g][0] = vh[b];
        b_h[g][1] = vh[b + P];
        b_l[g][0] = vl[b];
        b_l[g][1] = vl[b + P];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) mma_tf32(c[g], al[t], b_h[g][0], b_h[g][1]);
#pragma unroll
      for (int g = 0; g < G; ++g) mma_tf32(c[g], ah[t], b_l[g][0], b_l[g][1]);
#pragma unroll
      for (int g = 0; g < G; ++g) mma_tf32(c[g], ah[t], b_h[g][0], b_h[g][1]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[j0 + g][e] += c[g][e];
  }
}

// Write a warp's 16 x D accumulator as float32 rows, times `scale`.
template <int D>
__device__ __forceinline__ void tf_store(float* p, Strides st, int n, int h,
                                         int row0, int lane,
                                         const float acc[Tf<D>::kNt][4],
                                         float scale) {
  const int g = lane >> 2, tig = lane & 3;
  float* r0 = at_row(p, st, n, h, row0 + g);
  float* r1 = at_row(p, st, n, h, row0 + g + 8);
#pragma unroll
  for (int j = 0; j < Tf<D>::kNt; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(r0 + col) =
        make_float2(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<float2*>(r1 + col) =
        make_float2(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// The 64 rows of D floats that cp_rows copied into the hi plane `hi`,
// split there in place: hi = tf32(x), lo = tf32(x - hi). Each thread
// splits the chunks it copied itself (cp_rows' order), so its own
// cp_wait is all it waits for.
template <int D>
__device__ __forceinline__ void tf_split(uint32_t* hi, uint32_t* lo) {
  constexpr int C = D / 4;
#pragma unroll
  for (int j = 0; j < kTile * C / kTfThreads; ++j) {
    const int i = threadIdx.x + j * kTfThreads;
    const int at = (i / C) * Tf<D>::kPitch + 4 * (i % C);
    const float4 x = *reinterpret_cast<const float4*>(hi + at);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// The float32 forward: a CTA owns a 64-query item, each warp 16 of its
// rows. Per key tile: s = q k^T (tf_abt, over D from zero), the online
// softmax in registers, and o = alpha o + p v (tf_wv: the tile's 64 keys
// summed from zero on the tensor cores, then added in float32). K and V
// arrive by cp.async into their hi planes and are split there; each copy
// is in flight while the other operand's product runs: V_t's during the
// split of K_t and s, K_t+1's during the softmax and p v, V_t+1's during
// the next split of K and s. Three __syncthreads a tile.
template <int D>
__global__ void __launch_bounds__(kTfThreads)
    fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int S, int H, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale_log2) {
  extern __shared__ __align__(16) float smem_tf[];
  using L = Tf<D>;
  constexpr int P = L::kPitch;
  float* Qs = smem_tf;
  uint32_t* Kh = reinterpret_cast<uint32_t*>(Qs + L::kTileFloats);
  uint32_t* Kl = Kh + L::kTileFloats;
  uint32_t* Vh = Kl + L::kTileFloats;
  uint32_t* Vl = Vh + L::kTileFloats;
  const int nt = S / kTile;
  const Item it = item_of(nt, H, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = it.tile * kTile;
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  // the groups in flight, oldest first: (q, K_0), V_0; then K_t+1 and
  // V_t+1, issued during tile t
  cp_rows<float, D, P, kTfThreads>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s,
                                   kTile);
  cp_rows<float, D, P, kTfThreads>(reinterpret_cast<float*>(Kh),
                                   at_row(k, sk, it.n, it.h, 0), sk.s, kTile);
  cp_commit();
  cp_rows<float, D, P, kTfThreads>(reinterpret_cast<float*>(Vh),
                                   at_row(v, sv, it.n, it.h, 0), sv.s, kTile);
  cp_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[L::kNt][4];
#pragma unroll
  for (int j = 0; j < L::kNt; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const float* Qw = Qs + 16 * warp * P;
  for (int kt = 0; kt <= it.tile; ++kt) {
    const int k0 = kt * kTile;
    const bool diag = kt == it.tile;    // the only tile masked
    cp_wait<1>();                       // this thread's K_t (and q) landed
    tf_split<D>(Kh, Kl);
    __syncthreads();                    // K_t's planes and q for all
    float s[8][4];
    tf_abt<D, 8>(Qw, Kh, Kl, lane, s);
    cp_wait<0>();                       // this thread's V_t landed
    tf_split<D>(Vh, Vl);
    __syncthreads();                    // V_t's planes; K_t read by all
    if (!diag) {
      cp_rows<float, D, P, kTfThreads>(
          reinterpret_cast<float*>(Kh),
          at_row(k, sk, it.n, it.h, k0 + kTile), sk.s, kTile);
      cp_commit();
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale_log2;
        if (diag && k0 + 8 * t + 2 * tig + (e & 1) > rows[e >> 1])
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
    for (int j = 0; j < L::kNt; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    tf_wv<D, 8>(s, Vh, Vl, lane, acc);  // o += p v
    __syncthreads();                    // V_t read by all
    if (!diag) {
      cp_rows<float, D, P, kTfThreads>(
          reinterpret_cast<float*>(Vh),
          at_row(v, sv, it.n, it.h, k0 + kTile), sv.s, kTile);
      cp_commit();
    }
  }
#pragma unroll
  for (int j = 0; j < L::kNt; ++j) {
    acc[j][0] /= l[0];
    acc[j][1] /= l[0];
    acc[j][2] /= l[1];
    acc[j][3] /= l[1];
  }
  tf_store<D>(o, so, it.n, it.h, q0 + 16 * warp, lane, acc, 1.0f);
  if (tig == 0) {
    const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[stat + rows[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// One key tile of the dq kernel's walk (k0 its first key; diag: the
// diagonal tile, the only one masked, by a warp-uniform branch), its K
// and V planes staged.
template <int D>
__device__ __forceinline__ void dq_f32_step(
    const float* Qw, const float* dOw, const uint32_t* Kh,
    const uint32_t* Kl, const uint32_t* Vh, const uint32_t* Vl, int lane,
    int k0, bool diag, const int rows[2], const float ls[2],
    const float dl[2], float scale_log2, float acc[Tf<D>::kNt][4]) {
  const int tig = lane & 3;
  float s[8][4], dp[8][4];
  tf_abt<D, 8>(Qw, Kh, Kl, lane, s);
  tf_abt<D, 8>(dOw, Vh, Vl, lane, dp);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[t][e] = exp2f(s[t][e] * scale_log2 - ls[e >> 1]);
  if (diag) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * t + 2 * tig + (e & 1) > rows[e >> 1]) s[t][e] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] *= dp[t][e] - dl[e >> 1];
  tf_wv<D, 8>(s, Kh, Kl, lane, acc);    // dq += ds k
}

template <int D>
__global__ void __launch_bounds__(kTfThreads)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  float* __restrict__ dq, int S, int H, Strides sq,
                  Strides sk, Strides sv, Strides so, Strides sdo,
                  Strides sdq, float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem_tf[];
  using L = Tf<D>;
  constexpr int P = L::kPitch;
  float* Qs = smem_tf;
  float* dOs = Qs + L::kTileFloats;
  uint32_t* Kh = reinterpret_cast<uint32_t*>(dOs + L::kTileFloats);
  uint32_t* Kl = Kh + L::kTileFloats;
  uint32_t* Vh = Kl + L::kTileFloats;
  uint32_t* Vl = Vh + L::kTileFloats;
  float* dls = reinterpret_cast<float*>(Vl + L::kTileFloats);
  float* Os = reinterpret_cast<float*>(Kh);   // O, for delta, before K
  const int nt = S / kTile;
  const Item it = item_of(nt, H, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q0 = it.tile * kTile;
  const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
  tf_load<D>(Qs, at_row(q, sq, it.n, it.h, q0), sq.s);
  tf_load<D>(dOs, at_row(dout, sdo, it.n, it.h, q0), sdo.s);
  tf_load<D>(Os, at_row(o, so, it.n, it.h, q0), so.s);
  __syncthreads();
  {
    // delta of row tid / 2 from the two halves of its D columns
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const float* a = dOs + r * P + half * (D / 2);
    const float* b = Os + r * P + half * (D / 2);
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) part = fmaf(a[c], b[c], part);
    part += __shfl_xor_sync(kFull, part, 1);
    if (half == 0) {
      dls[r] = part;
      delta[stat + q0 + r] = part;
    }
  }
  __syncthreads();
  const int rl[2] = {16 * warp + g, 16 * warp + g + 8};
  const int rows[2] = {q0 + rl[0], q0 + rl[1]};
  const float ls[2] = {lse[stat + rows[0]] * kLog2e,
                       lse[stat + rows[1]] * kLog2e};
  const float dl[2] = {dls[rl[0]], dls[rl[1]]};
  const float* Qw = Qs + 16 * warp * P;
  const float* dOw = dOs + 16 * warp * P;
  float acc[L::kNt][4];
#pragma unroll
  for (int j = 0; j < L::kNt; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float4 nk[D / 8], nv[D / 8];          // the next K and V tile
  if (L::kDqPrefetch) {
    tf_fetch<D>(nk, at_row(k, sk, it.n, it.h, 0), sk.s);
    tf_fetch<D>(nv, at_row(v, sv, it.n, it.h, 0), sv.s);
  }
  for (int kt = 0; kt <= it.tile; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                    // the last tile's reads are done
    if (!L::kDqPrefetch) {
      tf_fetch<D>(nk, at_row(k, sk, it.n, it.h, k0), sk.s);
      tf_fetch<D>(nv, at_row(v, sv, it.n, it.h, k0), sv.s);
    }
    tf_stage<D>(Kh, Kl, nk);
    tf_stage<D>(Vh, Vl, nv);
    __syncthreads();
    if (L::kDqPrefetch && kt < it.tile) {  // in flight during this tile
      tf_fetch<D>(nk, at_row(k, sk, it.n, it.h, k0 + kTile), sk.s);
      tf_fetch<D>(nv, at_row(v, sv, it.n, it.h, k0 + kTile), sv.s);
    }
    dq_f32_step<D>(Qw, dOw, Kh, Kl, Vh, Vl, lane, k0, kt == it.tile, rows,
                   ls, dl, scale_log2, acc);
  }
  tf_store<D>(dq, sdq, it.n, it.h, q0 + 16 * warp, lane, acc, scale);
}

// One pass of the dk/dv kernel over a staged stage of kCols queries (q0
// the first; diag: on the diagonal tile, the only one masked). KV: the
// warp's K and V rows as float32 or as Planes.
template <int D, typename KV>
__device__ __forceinline__ void dkv_f32_pass(
    KV Kw, KV Vw, const uint32_t* Qh, const uint32_t* Ql,
    const uint32_t* dOh, const uint32_t* dOl, const float* lss,
    const float* dls, int lane, int q0, bool diag, const int keys[2],
    float scale_log2, float gk[Tf<D>::kNt][4], float gv[Tf<D>::kNt][4]) {
  constexpr int NT = Tf<D>::kCols / 8;  // query n-tiles a pass
  const int tig = lane & 3;
  float st[NT][4], dpt[NT][4];          // [key][query]
  tf_abt<D, NT>(Kw, Qh, Ql, lane, st);
  tf_abt<D, NT>(Vw, dOh, dOl, lane, dpt);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[t][e] = exp2f(st[t][e] * scale_log2 -
                       lss[8 * t + 2 * tig + (e & 1)]);
  if (diag) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (q0 + 8 * t + 2 * tig + (e & 1) < keys[e >> 1]) st[t][e] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[t][e] = st[t][e] * (dpt[t][e] - dls[8 * t + 2 * tig + (e & 1)]);
  tf_wv<D, NT>(st, dOh, dOl, lane, gv);   // dv += p^T dO
  tf_wv<D, NT>(dpt, Qh, Ql, lane, gk);    // dk += ds^T q
}

// The dk/dv kernel's walk over the query stages from its diagonal on,
// with K and V in shared memory as float32 rows or as planes (KV).
template <int D, typename KV>
__device__ __forceinline__ void dkv_f32_walk(
    KV Kw, KV Vw, uint32_t* Qh, uint32_t* Ql, uint32_t* dOh, uint32_t* dOl,
    float* lss, float* dls, const float* q, const float* dout,
    const float* lse, const float* delta, Strides sq, Strides sdo, Item it,
    int nt, long long stat, int warp, int lane, const int keys[2],
    float scale_log2, float gk[Tf<D>::kNt][4], float gv[Tf<D>::kNt][4]) {
  constexpr int R = Tf<D>::kCols;
  for (int qt = it.tile; qt < nt; ++qt) {
#pragma unroll 1
    for (int h0 = 0; h0 < kTile; h0 += R) {
      const int q0 = qt * kTile + h0;
      __syncthreads();                  // the last stage's reads are done
      {
        float4 nq[R * D / 512], ndo[R * D / 512];
        tf_fetch<D, R>(nq, at_row(q, sq, it.n, it.h, q0), sq.s);
        tf_fetch<D, R>(ndo, at_row(dout, sdo, it.n, it.h, q0), sdo.s);
        tf_stage<D, R>(Qh, Ql, nq);
        tf_stage<D, R>(dOh, dOl, ndo);
      }
      if (threadIdx.x < R) {
        lss[threadIdx.x] = lse[stat + q0 + threadIdx.x] * kLog2e;
        dls[threadIdx.x] = delta[stat + q0 + threadIdx.x];
      }
      __syncthreads();
      // on the diagonal, a stage whose queries all precede this warp's
      // keys adds nothing (a warp-uniform branch)
      if (qt > it.tile || h0 + R > 16 * warp)
        dkv_f32_pass<D>(Kw, Vw, Qh, Ql, dOh, dOl, lss, dls, lane, q0,
                        qt == it.tile, keys, scale_log2, gk, gv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTfThreads)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int S, int H, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdk,
                   Strides sdv, float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem_tf[];
  using L = Tf<D>;
  constexpr int P = L::kPitch;
  constexpr int R = L::kCols;
  float* kv = smem_tf;                  // K, V: 2 tiles, or 4 planes
  uint32_t* Qh = reinterpret_cast<uint32_t*>(
      kv + (L::kKvPlanes ? 4 : 2) * L::kTileFloats);
  uint32_t* Ql = Qh + R * P;
  uint32_t* dOh = Ql + R * P;
  uint32_t* dOl = dOh + R * P;
  float* lss = reinterpret_cast<float*>(dOl + R * P);
  float* dls = lss + R;
  const int nt = S / kTile;
  const Item it = item_of(nt, H, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int k0 = it.tile * kTile;
  const int keys[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
  const int w0 = 16 * warp * P;         // the warp's first row
  float gk[L::kNt][4], gv[L::kNt][4];
#pragma unroll
  for (int j = 0; j < L::kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.0f;
  if constexpr (L::kKvPlanes) {
    uint32_t* Kh = reinterpret_cast<uint32_t*>(kv);
    uint32_t* Kl = Kh + L::kTileFloats;
    uint32_t* Vh = Kl + L::kTileFloats;
    uint32_t* Vl = Vh + L::kTileFloats;
    {
      float4 nk[D / 8], nv[D / 8];
      tf_fetch<D>(nk, at_row(k, sk, it.n, it.h, k0), sk.s);
      tf_fetch<D>(nv, at_row(v, sv, it.n, it.h, k0), sv.s);
      tf_stage<D>(Kh, Kl, nk);
      tf_stage<D>(Vh, Vl, nv);
    }
    dkv_f32_walk<D>(Planes{Kh + w0, Kl + w0}, Planes{Vh + w0, Vl + w0}, Qh,
                    Ql, dOh, dOl, lss, dls, q, dout, lse, delta, sq, sdo, it,
                    nt, stat, warp, lane, keys, scale_log2, gk, gv);
  } else {
    float* Ks = kv;
    float* Vs = Ks + L::kTileFloats;
    tf_load<D>(Ks, at_row(k, sk, it.n, it.h, k0), sk.s);
    tf_load<D>(Vs, at_row(v, sv, it.n, it.h, k0), sv.s);
    dkv_f32_walk<D>(static_cast<const float*>(Ks + w0),
                    static_cast<const float*>(Vs + w0), Qh, Ql, dOh, dOl,
                    lss, dls, q, dout, lse, delta, sq, sdo, it, nt, stat,
                    warp, lane, keys, scale_log2, gk, gv);
  }
  tf_store<D>(dk, sdk, it.n, it.h, k0 + 16 * warp, lane, gk, scale);
  tf_store<D>(dv, sdv, it.n, it.h, k0 + 16 * warp, lane, gv, 1.0f);
}

// ------------------------------------------------------------------------
// bf16 forward: mma.sync m16n8k16 fed by ldmatrix.

constexpr int kBfFwdThreads = 128;      // the forward: 4 warps
constexpr int kBfFwdMt = 2;             // ... of 2 m-tiles of 16 rows
constexpr int kBfFwdRows = 128;         // the forward's queries an item

template <int D>
struct Bf {
  static constexpr int kPitch = D + 8;        // +16 bytes: ldmatrix's 8
                                              // rows fall on distinct banks
  static constexpr int kTileElems = kTile * kPitch;
  static constexpr int kNt = D / 8;           // output n-tiles of a warp
  // forward: q (kBfFwdRows rows) and two stages of K and V
  static constexpr unsigned fwd_smem() {
    return 2u * (kBfFwdRows + 4 * kTile) * kPitch;
  }
};

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

// c[i][t] (MT m-tiles of 16 rows, NT n-tiles of 8) = A[16 MT rows]
// B[8 NT rows]^T over D, each B fragment read once for the MT m-tiles:
// A's rows from `a` (this warp's first row), B's from `b`, both row-major
// in shared memory. The C fragment: c[i][t][0..1] row g of m-tile i,
// columns 8 t + 2 tig + {0, 1}; c[i][t][2..3] row g + 8 (g = lane / 4,
// tig = lane % 4).
template <int D, int NT, int MT>
__device__ __forceinline__ void mma_abt_m(const bf16* a, const bf16* b,
                                          int lane, float c[MT][NT][4]) {
  constexpr int P = Bf<D>::kPitch;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      c[i][t][0] = c[i][t][1] = c[i][t][2] = c[i][t][3] = 0.0f;
  const uint32_t a_lane = smem_addr(
      a + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
  const uint32_t b_lane = smem_addr(
      b + ((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm_x4(af[i], a_lane + 2 * (16 * i * P + 16 * kk));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[4];
      ldsm_x4(bfr, b_lane + 2 * (16 * np * P + 16 * kk));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma(c[i][2 * np], af[i], bfr[0], bfr[1]);
        mma(c[i][2 * np + 1], af[i], bfr[2], bfr[3]);
      }
    }
  }
}

// out[i][t] (D / 8 n-tiles) += W[i] V over 16 KS rows of V, each V
// fragment read once for the MT m-tiles: W[i] the C fragments of m-tile
// i's 16 x 16 KS product (rounded to bf16 here), V row-major in shared
// memory from `v` (read transposed by ldmatrix).
template <int D, int KS, int MT>
__device__ __forceinline__ void mma_wv_m(const float w[MT][2 * KS][4],
                                         const bf16* v, int lane,
                                         float out[MT][Bf<D>::kNt][4]) {
  constexpr int P = Bf<D>::kPitch;
  const uint32_t v_lane = smem_addr(
      v + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      af[i][0] = pack(w[i][2 * kk][0], w[i][2 * kk][1]);
      af[i][1] = pack(w[i][2 * kk][2], w[i][2 * kk][3]);
      af[i][2] = pack(w[i][2 * kk + 1][0], w[i][2 * kk + 1][1]);
      af[i][3] = pack(w[i][2 * kk + 1][2], w[i][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, v_lane + 2 * (16 * kk * P + 16 * dp));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma(out[i][2 * dp], af[i], bfr[0], bfr[1]);
        mma(out[i][2 * dp + 1], af[i], bfr[2], bfr[3]);
      }
    }
  }
}

// 2^x by the special-function unit (ex2.approx.ftz), as flash_attention.cu
// takes it: the bf16 forward rounds p to bf16 for its product with v
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 forward: a CTA owns a 128-query item (kBfFwdRows), each of
// its 4 warps 32 rows as two m-tiles of 16 (kBfFwdMt), which share every
// K and V fragment that ldmatrix reads: half the shared-memory reads of a
// warp of 16 rows a product. It walks the 64-key tiles up to its last
// query. K and V go through two stages by cp.async, one __syncthreads a
// tile: past it, tile t has landed for every thread and every warp is
// done with tile t - 1, so tile t + 1's copy goes into that stage at once
// and is in flight during tile t's products. A key tile past a warp's
// last query adds nothing to it (a warp-uniform branch), and in an item
// that S cuts to 64 queries the upper two warps only copy. The row
// maximum is taken on the raw scores and the scale folded into the
// exponent's FFMA: p = 2^(s scale log2(e) - m).
template <int D>
__global__ void __launch_bounds__(kBfFwdThreads, 2)
    fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int H, Strides sq,
                    Strides sk, Strides sv, Strides so, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using L = Bf<D>;
  constexpr int P = L::kPitch, T = L::kTileElems, MT = kBfFwdMt;
  constexpr int WR = 16 * MT;           // a warp's rows
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + kBfFwdRows * P;       // stage b: K at 2 b T, V at 2 b T + T
  const int nq = (S + kBfFwdRows - 1) / kBfFwdRows;
  const Item it = item_of(nq, H, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = it.tile * kBfFwdRows;
  const int qrows = min(kBfFwdRows, S - q0);
  const int w0 = q0 + WR * warp;        // the warp's first query
  const bool active = w0 < S;
  const int nk = (q0 + qrows - 1) / kTile + 1;  // key tiles of the item
  cp_rows<bf16, D, P, kBfFwdThreads>(Qs, at_row(q, sq, it.n, it.h, q0),
                                     sq.s, qrows);
  cp_rows<bf16, D, P, kBfFwdThreads>(KV, at_row(k, sk, it.n, it.h, 0), sk.s,
                                     kTile);
  cp_rows<bf16, D, P, kBfFwdThreads>(KV + T, at_row(v, sv, it.n, it.h, 0),
                                     sv.s, kTile);
  cp_commit();
  // [m-tile][row g, row g + 8]
  float m[MT][2], l[MT][2];
  float acc[MT][L::kNt][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.0f;
#pragma unroll
    for (int t = 0; t < L::kNt; ++t)
      acc[i][t][0] = acc[i][t][1] = acc[i][t][2] = acc[i][t][3] = 0.0f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    const bf16* Ks = KV + 2 * (kt & 1) * T;
    cp_wait<0>();                       // this thread's copies of tile t
    __syncthreads();                    // ... every thread's; t - 1 read
    if (kt + 1 < nk) {                  // tile t + 1, in flight during t
      bf16* nxt = KV + 2 * ((kt + 1) & 1) * T;
      cp_rows<bf16, D, P, kBfFwdThreads>(
          nxt, at_row(k, sk, it.n, it.h, k0 + kTile), sk.s, kTile);
      cp_rows<bf16, D, P, kBfFwdThreads>(
          nxt + T, at_row(v, sv, it.n, it.h, k0 + kTile), sv.s, kTile);
      cp_commit();
    }
    if (!active || k0 > w0 + WR - 1) continue;
    const bool diag = k0 + kTile - 1 > w0;  // some key past some row
    float s[MT][8][4];
    mma_abt_m<D, 8, MT>(Qs + WR * warp * P, Ks, lane, s);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = w0 + 16 * i + g;   // rows r0 and r0 + 8
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (diag && k0 + 8 * t + 2 * tig + (e & 1) > r0 + 8 * (e >> 1))
            s[i][t][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[i][t][e]);
        }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[i][r], quad_max(mx[r]) * scale_log2);
        alpha[r] = fast_exp2(m[i][r] - m_new);
        m[i][r] = m_new;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][t][e] = fast_exp2(fmaf(s[i][t][e], scale_log2,
                                      -m[i][e >> 1]));
          sum[e >> 1] += s[i][t][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[i][r] = l[i][r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int t = 0; t < L::kNt; ++t) {
        acc[i][t][0] *= alpha[0];
        acc[i][t][1] *= alpha[0];
        acc[i][t][2] *= alpha[1];
        acc[i][t][3] *= alpha[1];
      }
    }
    mma_wv_m<D, 4, MT>(s, Ks + T, lane, acc);
  }
  if (!active) return;
  const long long stat = (static_cast<long long>(it.n) * H + it.h) * S;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r0 = w0 + 16 * i;
    bf_store<D>(o, so, it.n, it.h, r0, lane, acc[i], 1.0f / l[i][0],
                1.0f / l[i][1]);
    if (tig == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lse[stat + r0 + g + 8 * r] = (m[i][r] + log2f(l[i][r])) * kLn2;
    }
  }
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
  const unsigned smem = Tf<D>::fwd_smem();
  const cudaError_t err = set_smem(fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_f32_kernel<D><<<grid_of(N, S, H), kTfThreads, smem, stream>>>(
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
  const unsigned grid = static_cast<unsigned>(
      (S + kBfFwdRows - 1) / kBfFwdRows * H * N);
  fwd_bf16_kernel<D><<<grid, kBfFwdThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, S, H,
      at(st, 0), at(st, 1), at(st, 2), at(st, 3), scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int dq_f32(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, int N,
           int S, int H, const long long* st, float scale,
           cudaStream_t stream) {
  const unsigned smem = Tf<D>::dq_smem();
  const cudaError_t err = set_smem(dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dq_f32_kernel<D><<<grid_of(N, S, H), kTfThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, lse, delta, (float*)dq, S, H, at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), at(st, 4), at(st, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int N,
            int S, int H, const long long* st, float scale,
            cudaStream_t stream) {
  const unsigned smem = Tf<D>::dkv_smem();
  const cudaError_t err = set_smem(dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dkv_f32_kernel<D><<<grid_of(N, S, H), kTfThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, S, H, at(st, 0), at(st, 1),
      at(st, 2), at(st, 3), at(st, 4), at(st, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry point per kernel, named as ops/flash_attention.py counts its
// launches, each with flash_attention.cu's signature (D must be the
// form's): float32 at D = 16, 32, 64, 128 forward, dq and dk/dv; bf16 at
// D = 16 the forward (its dq and dk/dv, and every bf16 kernel at D = 32,
// 64 and 128, are flash_attention.cu's).
// Strides: forward q, k, v, o; dq q, k, v, o, dO, dq (it writes delta (N,
// H, S) float32); dk/dv q, k, v, dO, dk, dv (it reads the delta that dq
// wrote).
#define FLASH_TILED_FWD(TAG, DIM)                                            \
  extern "C" int flash_fwd_##TAG##_d##DIM(                                   \
      const void* q, const void* k, const void* v, void* o, float* lse,      \
      int N, int S, int H, int D, const long long* strides, float scale,     \
      void* stream) {                                                        \
    if (D != DIM || bad_shape(N, S, H)) return (int)cudaErrorInvalidValue;   \
    return fwd_##TAG<DIM>(q, k, v, o, lse, N, S, H, strides,                 \
                          scale * kLog2e, (cudaStream_t)stream);             \
  }
#define FLASH_TILED_BWD(TAG, DIM)                                            \
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
#define FLASH_TILED_FORM(TAG, DIM) \
  FLASH_TILED_FWD(TAG, DIM)        \
  FLASH_TILED_BWD(TAG, DIM)

FLASH_TILED_FORM(f32, 16)
FLASH_TILED_FORM(f32, 32)
FLASH_TILED_FORM(f32, 64)
FLASH_TILED_FORM(f32, 128)
FLASH_TILED_FWD(bf16, 16)

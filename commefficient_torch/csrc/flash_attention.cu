// Causal flash attention for Hopper (sm_90a) in bf16: forward, dq and
// dk/dv at head widths D = 32, 64 (GPT-2's) and 128, and dq and dk/dv at
// D = 16 (its forward is flash_tiled.cu's).
//
// Replaces the library Pallas TPU kernel that the JAX package's
// models/gpt2.py flash_causal_attention calls
// (jax.experimental.pallas.ops.tpu.flash_attention):
//   flash_fwd, flash_fwd_bf16_d<32|128>  <- _flash_attention_impl
//                    (forward, writes o and the row statistics the
//                    backward reads)
//   flash_bwd_dq, flash_bwd_dq_bf16_d<16|32|128>   <- _flash_attention_bwd_dq
//   flash_bwd_dkv, flash_bwd_dkv_bf16_d<16|32|128> <- _flash_attention_bwd_dkv
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
// All the kernels are warp-specialised wgmma kernels fed by TMA. A
// persistent grid, one CTA per SM, each CTA of three warpgroups: a
// producer whose one elected thread issues TMA loads (cp.async.bulk.tensor
// through a 4-D (D, H, S, N) tensor map of the strided operand, 128-byte
// swizzle, rows past S read as zeros) into a 4-stage ring guarded by
// full/empty mbarriers, and gives up its registers (setmaxnreg 24); two
// consumer warpgroups (setmaxnreg 240) that run every product as
// wgmma.mma_async (bf16 in, float32 accumulate). A CTA walks work items
// (tile, head, sequence), heaviest tile first, in a zigzag over the CTAs;
// the ring runs on across items, and the item's fixed operands (Q; Q and
// dO; or K and V) are double-buffered, so the next item's loads overlap
// this one's work. Within a consumer, tile j's first products are issued
// before tile j - 1's last ones, so the softmax (or the elementwise step)
// of one tile overlaps the other's tensor-core work.
//   forward: items (128-row query tile, head, sequence); K and V tiles of
//   128 keys (32 KB a stage) stream through the ring. Each consumer owns
//   64 query rows: s = q k^T as m64n128k16 from shared memory (both
//   K-major), the online softmax in the log2 domain on the accumulator
//   fragments (a thread owns rows g and g + 8 of its warp's 16, so a row
//   reduces over a quad), the diagonal tile alone masked, then o += p v as
//   m64n64k16 with p rounded to bf16 in registers (the accumulator maps
//   onto the A fragment) and v read MN-major. o is normalised and written
//   as bf16, lse as float32.
//   dq: items (128-row query tile, head, sequence), the forward's walk;
//   the same K and V stages. Each consumer owns 64 query rows. At the
//   start of an item it computes delta = rowsum(dO o) for its rows from
//   the item's dO tile and an O tile (one buffer, released as soon as
//   delta is read, so the next item's O loads behind it) and writes it
//   once for flash_bwd_dkv, launched after it on the same stream; lse
//   arrives by bulk copy beside Q and dO. Per key tile: s = q k^T and dp =
//   dO v^T (m64n128k16, shared memory, K-major), p = exp2(s scale log2e -
//   lse log2e) masked on the diagonal, ds = p (dp - delta) in place, then
//   dq += ds k (m64n64k16, ds rounded to bf16 in registers, k read
//   MN-major). dq (x 1/sqrt(D)) is written once as bf16.
//   dk/dv: items (128-key tile, head, sequence); K and V stay in shared
//   memory as A operands; Q and dO tiles of 64 rows stream through the
//   ring with their lse and delta (bulk copies). Each consumer owns 64 keys
//   and, per query tile from the diagonal down, computes s^T = k q^T and
//   dp^T = v dO^T (m64n64k16, shared memory), p^T = exp2(s^T scale log2e -
//   lse log2e) masked on the diagonal, ds^T = p^T (dp^T - delta), then
//   dv += p^T dO and dk += ds^T q with p^T and ds^T as bf16 register A
//   operands and dO, q read MN-major. A query tile that lies wholly before
//   a consumer's keys is skipped. dk (x 1/sqrt(D)) and dv are written once
//   each as bf16.
// The three kernels are templates over D (Bw<D> lays each width out, Fw<D>
// the forward's buffers); their D = 64 instantiations are the kernels
// above, the same SASS instruction for instruction as before the
// templates. The other widths:
//   D = 32 and 16: rows of 64 and 32 bytes under the 64-byte and 32-byte
//   swizzles (TMA and the wgmma descriptors' layout field agree; the
//   group stride 512 and 256 bytes); every tile and stage as at D = 64,
//   so the products are the same shapes with a half or a quarter of the
//   depth (o += p v and dq += ds k m64n32k16 and m64n16k16, dk and dv
//   too), and the item's elementwise work, one exp2 per score, two and
//   four times D = 64's per FLOP, is what bounds them. At D = 16 a quad's
//   four threads read 8 bytes each of a 32-byte row for delta.
//   D = 128: each tile in two parts of 64 columns, each a 128-byte-
//   swizzled TMA box of its own, part 1 R rows x 128 bytes after part 0;
//   a K-major operand steps into part 1 after four 16-deep slices, an
//   MN-major one (n128) reads part 1 through the descriptor's leading byte
//   offset. The forward keeps 128-key stages (s and o 64 floats a thread
//   each, p's bf16 A fragments 32: no spills at 240 registers) and o += p
//   v as m64n128k16, with one Q buffer and three stages (Fw<128>). dq
//   takes 64 keys a stage (s and dp m64n64, 32 floats a thread
//   each beside dq's 64) and one buffer of Q and dO (231,008 bytes of
//   shared memory with O and four stages), so the first consumer's rows
//   end one key tile before the item's diagonal: it releases that stage
//   unread, once it has landed. dk/dv takes 32 queries a stage (s^T and
//   dp^T m64n32, 16 floats a thread each beside dk's and dv's 64 each):
//   no spills at 240 registers.
//   The forward at D = 32 and 128 also takes turns: its two consumer
//   warpgroups issue their products one after the other (two named
//   barriers, FlashAttention-3's ping-pong), so one's softmax runs beside
//   the other's products and their exp2 phases do not coincide.
// No atomics anywhere, so two calls give the same bits. p and ds round to
// bf16 only as product operands, in all three kernels. The TPU kernel's
// block structure (512-wide blocks, the sequential grid that carries the
// softmax state in VMEM scratch) is not carried over: the loop over tiles
// inside the CTA takes its place.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the GPT-2
// shape N 8, H 12, S 1024, D 64: the forward needs 2 causal products,
// 12.9 GFLOP (13 us), and moves 50.7 MB: 15 us by bytes; dk/dv needs 4
// causal products, 25.8 GFLOP: 26 us by operations; dq 3 products, 19.3
// GFLOP (20 us), and 76 MB: 23 us by bytes. What holds the kernels back at
// D = 64 is the exponential: an SM's special-function units give 16 exp2
// a clock against 4,096 bf16 tensor-core FLOPs, and the forward and dq do
// one exp2 per score against 4 D = 256 FLOPs (forward) or 6 D = 384 (dq),
// so exp2 alone takes about as long as the products (about 13 us at the
// main shape); dk/dv does one against 512. Measured on an NVIDIA H100
// 80GB HBM3 at a 700 W limit (chip_smoke.py): forward 0.047 ms (272
// TFLOP/s), dq 0.054 ms (359-361 TFLOP/s), dk/dv 0.075 ms (343-346
// TFLOP/s). At (8, 1024, 768 / D, D) the other widths do the same FLOPs
// (dq's bound 0.023 ms by bytes, dk/dv's 0.026 by operations) with two
// and four times the exp2 at D = 32 and 16, half at D = 128; measured
// (scripts/k3_tiled_ab.py, interleaved with the mma.sync pair they
// replace) dq 0.118 / 0.073 / 0.054 ms and dk/dv 0.154 / 0.101 / 0.078 at
// D = 16 / 32 / 128, each pair below SDPA's backward (0.447 / 0.259 /
// 0.145); the forward 0.074 ms at D = 32 (24 heads: twice D = 64's
// scores, each key tile cheaper than D = 64's) and 0.040-0.042 at D = 128
// (6 heads), against the mma.sync forward's 0.092 and 0.061 and SDPA's
// 0.083 and 0.041 (cuDNN's wgmma forward, which the D = 128 forward only
// ties).
//
// Build (nvcc -Xptxas -v, sm_90a): every kernel 168 registers at launch
// (384 threads; 24 for the producer, 240 for the consumers after
// setmaxnreg), no spills, no wgmma serialisation; 164,992 (forward),
// 215,152 (dq: Q and dO x 2, O, 4 stages of K and V, lse) and 134,240
// (dk/dv) bytes of dynamic shared memory at D = 64; the forward 83,072 /
// 230,488 at D = 32 / 128, dq 55,408 / 108,656 / 231,008 and dk/dv 35,936
// / 68,704 / 198,752 at D = 16 / 32 / 128: one CTA an SM.
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// given stream and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a shape it does not take (D not its width, S
// not a multiple of 64), -1 when the driver refuses a tensor map, or the
// error of raising the kernel's shared-memory limit.

#include <cmath>
#include <cstdint>
#include <cuda.h>               // CUtensorMap (the driver is reached through
                                // cudaGetDriverEntryPoint: no -lcuda)
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A shape the kernel of head width `want` does not take.
bool bad_shape(int N, int S, int H, int D, int want) {
  return D != want || S <= 0 || S % kTile != 0 || N <= 0 || N > 65535 ||
         H <= 0 || H > 65535;
}

Strides at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// ------------------------------------------------------------------------
// Hopper: TMA into an mbarrier ring, wgmma, producer and consumer
// warpgroups.

constexpr int kBlock = 128;       // rows of a work item (queries of the
                                  // forward and dq, keys of dk/dv); keys
                                  // of a forward stage
constexpr int kQBlock = 64;       // dk/dv: query rows of a stage (D <= 64)
constexpr int kStages = 4;        // depth of the TMA ring (the forward's
                                  // at D = 128: Fw<128>::kRing)
constexpr int kWg = 128;          // threads of a warpgroup
constexpr int kWsThreads = 3 * kWg;           // producer + two consumers
constexpr int kConsumerThreads = 2 * kWg;
constexpr int kEncodeFailed = -1;             // a tensor map was refused

// The kernels' layout at head width D = 16, 32, 64 or 128 (the backward
// kernels' buffers here, the forward's in Fw<D>). A tile of R rows of an
// operand lies in shared memory as TMA wrote it: in
// kParts parts of R rows x kAtom columns, part p at p R kRowBytes, each
// part one TMA box under the swizzle that spans its row (D = 64: 128-byte
// rows, the 128-byte swizzle; D = 32: 64-byte rows, the 64-byte swizzle;
// D = 16: 32-byte rows, the 32-byte swizzle; D = 128: two parts of
// 128-byte rows, the 128-byte swizzle). The swizzle repeats every 8 rows
// (kGroupBytes).
template <int D>
struct Bw {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "the kernels take D = 16, 32, 64 or 128");
  static constexpr int kAtom = D < 64 ? D : 64;
  static constexpr int kParts = D / kAtom;
  static constexpr uint32_t kRowBytes = 2 * kAtom;
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;
  // the descriptor's layout field: 1 the 128-byte swizzle, 2 the 64-byte,
  // 3 the 32-byte
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  __host__ __device__ static constexpr uint32_t tile_bytes(int rows) {
    return rows * 2u * D;
  }
  // dq: an item's Q and dO (dO kDqQBytes after Q) in kDqBufs buffers, one
  // O tile (read once an item, for delta), kStages stages of kDqKeys keys
  // of K and V, the buffers' lse, then the barriers q[kDqBufs],
  // q_empty[kDqBufs], o, o_empty, full[s], empty[s]. At D = 128 the stages
  // take 64 keys (s and dp, 64 floats a thread each, beside dq's 64) and
  // Q and dO one buffer (shared memory).
  static constexpr int kDqKeys = D == 128 ? 64 : kBlock;
  static constexpr int kDqBufs = D == 128 ? 1 : 2;
  static constexpr uint32_t kDqQBytes = tile_bytes(kBlock);
  static constexpr uint32_t kDqKBytes = tile_bytes(kDqKeys);
  static constexpr uint32_t kDqO = 2 * kDqBufs * kDqQBytes;
  static constexpr uint32_t kDqK = kDqO + kDqQBytes;
  static constexpr uint32_t kDqStat = kDqK + 2 * kStages * kDqKBytes;
  static constexpr uint32_t kDqBar = kDqStat + kDqBufs * 4 * kBlock;
  static constexpr uint32_t kDqSmem =
      kDqBar + 8 * (2 * kDqBufs + 2 + 2 * kStages) + 1024;
  // dk/dv: two K, V buffers, kStages stages of kDkvRows rows of Q and dO,
  // the stages' lse and delta, then the barriers kv[2], kv_empty[2],
  // full[s], empty[s]. At D = 128 a stage takes 32 queries (dk and dv, 64
  // floats a thread each, beside s^T and dp^T).
  static constexpr int kDkvRows = D == 128 ? 32 : kQBlock;
  static constexpr uint32_t kDkvKBytes = tile_bytes(kBlock);
  static constexpr uint32_t kDkvQBytes = tile_bytes(kDkvRows);
  static constexpr uint32_t kDkvStatBytes = 4 * kDkvRows;
  static constexpr uint32_t kDkvStage = 4 * kDkvKBytes;
  static constexpr uint32_t kDkvStat = kDkvStage + 2 * kStages * kDkvQBytes;
  static constexpr uint32_t kDkvBar = kDkvStat + 2 * kStages * kDkvStatBytes;
  static constexpr uint32_t kDkvSmem = kDkvBar + 8 * (4 + 2 * kStages) + 1024;
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
                "a backward kernel exceeds an SM's shared memory");

  // wgmma descriptor of a tile from `addr`: the group stride as the stride
  // byte offset, `lbo` as the leading one. K-major swizzled layouts read
  // no leading offset; an MN-major operand reads it as the stride between
  // its parts (mn_lbo), where it has two.
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo = kGroupBytes) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(kGroupBytes >> 4) << 32) | (kLayout << 62);
  }
  __host__ __device__ static constexpr uint32_t mn_lbo(int rows) {
    return kParts > 1 ? rows * kRowBytes : kGroupBytes;
  }
  // descriptor step to the kk-th 16-deep slice of a K-major tile of `rows`
  // rows: 32 bytes along the row, the next part every kAtom / 16 steps
  __host__ __device__ static constexpr uint64_t kstep(int kk, int rows) {
    return ((kk / (kAtom / 16)) * rows * kRowBytes + (kk % (kAtom / 16)) * 32)
           >> 4;
  }
  // an MN-major operand's 16 rows of depth
  static constexpr uint64_t kMNStep = (16 * kRowBytes) >> 4;
  // where TMA put 16-byte chunk c of row r: the swizzle xors the chunk
  // index with the row's bits 0-2 (128 bytes), 1-2 (64) or 2 (32)
  __device__ static int chunk(int r, int c) {
    return kRowBytes == 128  ? c ^ (r & 7)
           : kRowBytes == 64 ? c ^ ((r >> 1) & 3)
                             : c ^ ((r >> 2) & 1);
  }
};

// The forward's layout at D = 32, 64 or 128, in Bw<D>'s rows, swizzles and
// parts, from a 1024-byte aligned base: kBufs Q buffers of kBlock rows
// (with two, a CTA's next work item loads while the current one runs),
// kRing stages of kBlock keys of K and V, then the barriers q[kBufs],
// q_empty[kBufs], k[s], v[s], empty[s]. A stage is released once its p v
// has run, after the next tile's q k^T was issued: a ring of three holds
// the two tiles being read and one in flight. At D = 128 a tile is 32 KB,
// and two Q buffers would leave room for two stages, so no load in flight:
// one Q buffer (its next item's load waits for the item's last q k^T)
// and three stages, 230,488 bytes. (Two Q buffers and two stages, K
// released after its q k^T and V after its p v, as FlashAttention-3 runs
// this width, measured no faster on an H100.) kTurns: the consumers issue
// their products in turns, so their exp2 phases do not coincide; D = 64
// keeps the schedule it had before the template.
template <int D>
struct Fw {
  static_assert(D == 32 || D == 64 || D == 128,
                "the forward takes D = 32, 64 or 128");
  static constexpr int kBufs = D == 128 ? 1 : 2;
  static constexpr int kRing = D == 128 ? 3 : kStages;
  static constexpr bool kTurns = D != 64;
  static constexpr uint32_t kTileBytes = Bw<D>::tile_bytes(kBlock);
  static constexpr uint32_t kK = kBufs * kTileBytes;
  static constexpr uint32_t kBar = kK + 2 * kRing * kTileBytes;
  static constexpr uint32_t kSmem =
      kBar + 8 * (2 * kBufs + 3 * kRing) + 1024;
  static_assert(kSmem <= 232448, "the forward exceeds an SM's shared memory");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: one box of a 4-D tensor map (coordinates innermost first) into
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A backward tile of `rows` positions from row0: one box a part.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int h,
                                         int row0, int n) {
#pragma unroll
  for (int p = 0; p < Bw<D>::kParts; ++p) {
    tma_load(dst + p * rows * Bw<D>::kRowBytes, map, bar, p * Bw<D>::kAtom, h,
             row0, n);
  }
}

// Bulk copy of contiguous bytes (16-byte aligned) into shared memory.
// Order this thread's earlier generic-proxy reads of shared memory before
// later TMA writes into the same bytes (the buffer is then released).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barrier `id` (1 or 2; 0 is __syncthreads') of the two consumer
// warpgroups: sync waits until both have reached it, this warpgroup by
// syncing, the other by arriving.
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128) (+)= a b^T, a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= a b^T, a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += a b, a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 32) (+)= a b^T, a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) += a b, a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 128) += a b, a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 16) += a b, a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// The backward's products by the width of their accumulator (N = 2 x its
// floats a thread): both operands K-major (ss), or A from registers and B
// MN-major (rs).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  wgmma_ss_n32(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  wgmma_ss_n64(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  wgmma_ss_n128(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  wgmma_rs_n16(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  wgmma_rs_n32(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  wgmma_rs_n64(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  wgmma_rs_n128(d, a, b, accumulate);
}

// The bf16 A operand of k-step kk (accumulator columns 16 kk .. 16 kk + 15)
// from a warpgroup's float accumulators: the wgmma accumulator and register
// A layouts agree thread by thread, as for mma.sync.
template <int N>
__device__ __forceinline__ void frag_to_a(uint32_t (&a)[4],
                                          const float (&d)[N], int kk) {
  a[0] = pack(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack(d[8 * kk + 6], d[8 * kk + 7]);
}

// Write a thread's part of a 64 x 2 N accumulator times `mul` as bf16:
// rows row0 and row0 + 8 (those below S) of a strided (S, D) slab.
template <int N>
__device__ __forceinline__ void store_frag(bf16* base, long long row_stride,
                                           int row0, int S,
                                           const float (&d)[N], float mul0,
                                           float mul1, int t) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const int col = 8 * c + 2 * t;
    if (row0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(base + row0 * row_stride + col) =
          __floats2bfloat162_rn(d[4 * c] * mul0, d[4 * c + 1] * mul0);
    }
    if (row0 + 8 < S) {
      *reinterpret_cast<__nv_bfloat162*>(base + (row0 + 8) * row_stride +
                                         col) =
          __floats2bfloat162_rn(d[4 * c + 2] * mul1, d[4 * c + 3] * mul1);
    }
  }
}

// The forward's online softmax over one tile of raw scores s = q k^T (64
// rows x 128 keys a warpgroup), in place: s becomes p = exp2((s - m)
// scale log2e) with m the running row max of the raw scores (rows g and
// g + 8 of the warp: m0, m1), l the running row sum of this thread's
// columns, al the factor that rescales the earlier sums. Only the diagonal
// tile (`key0` its first key) is masked.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1,
                                             bool diag, int key0, int row0,
                                             int t, float scale_log2) {
  if (diag) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + 8 * c + 2 * t + (e & 1) > row0 + (e >> 1) * 8) {
          sc[4 * c + e] = -INFINITY;
        }
      }
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  // every row sees key 0 in its first tile, so mx is finite from there
  al0 = fast_exp2((m0 - mx0) * scale_log2);
  al1 = fast_exp2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    sc[4 * c] = fast_exp2(fmaf(sc[4 * c], scale_log2, -ms0));
    sc[4 * c + 1] = fast_exp2(fmaf(sc[4 * c + 1], scale_log2, -ms0));
    sc[4 * c + 2] = fast_exp2(fmaf(sc[4 * c + 2], scale_log2, -ms1));
    sc[4 * c + 3] = fast_exp2(fmaf(sc[4 * c + 3], scale_log2, -ms1));
    s0 += sc[4 * c] + sc[4 * c + 1];
    s1 += sc[4 * c + 2] + sc[4 * c + 3];
  }
  l0 = l0 * al0 + s0;
  l1 = l1 * al1 + s1;
}

// Work items of the persistent kernels: (tile, head, sequence), heaviest
// tile first. In round r a CTA takes item r G + blockIdx.x (r even) or
// r G + G - 1 - blockIdx.x (r odd), G = gridDim.x: the zigzag evens out
// the causal triangle's falling work per item (at the GPT-2 shape the
// busiest SM gets 27 key tiles of the forward's 26.2 average, 30 by plain
// striding).
struct Item {
  int tile, h, n;
};

__device__ __forceinline__ int item_index(int r) {
  return r * gridDim.x +
         ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

__device__ __forceinline__ Item item_at(int i, int first_tile, int step,
                                        int H, int N) {
  const int hn = i % (H * N);
  return Item{first_tile + step * (i / (H * N)), hn % H, hn / H};
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int S,
                     int H, int N, Strides so, float scale_log2) {
  using L = Bw<D>;
  using F = Fw<D>;
  constexpr int kBufs = F::kBufs, kRing = F::kRing;
  constexpr int kBufShift = kBufs == 2 ? 1 : 0;
  constexpr uint32_t kTBytes = F::kTileBytes;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t bar0 = base + F::kBar;
  const int n_qt = (S + kBlock - 1) / kBlock;
  const int items = n_qt * H * N;
  // Q buffer b at base + b kTBytes; stage s: K at base + kK + 2 s
  // kTBytes, V kTBytes after it; barriers from bar0: q[kBufs],
  // q_empty[kBufs], k[s], v[s], empty[s]
  auto sQ = [&](int b) { return base + b * kTBytes; };
  auto sK = [&](int s) { return base + F::kK + 2 * s * kTBytes; };
  auto bar_q = [&](int b) { return bar0 + 8 * b; };
  auto bar_qe = [&](int b) { return bar0 + 8 * (kBufs + b); };
  auto bar_k = [&](int s) { return bar0 + 8 * (2 * kBufs + s); };
  auto bar_v = [&](int s) { return bar0 + 8 * (2 * kBufs + kRing + s); };
  auto bar_e = [&](int s) {
    return bar0 + 8 * (2 * kBufs + 2 * kRing + s);
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(bar_q(b), 1);
      mbar_init(bar_qe(b), kConsumerThreads);
    }
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // producer warpgroup: one thread keeps the ring full, across items
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int jg = 0;                              // K/V tiles loaded so far
      for (int it = 0; it * (int)gridDim.x < items; ++it) {
        const int i = item_index(it);
        if (i >= items) break;
        const Item w = item_at(i, n_qt - 1, -1, H, N);
        const int b = it & (kBufs - 1);
        if (it >= kBufs) {
          mbar_wait(bar_qe(b), ((it >> kBufShift) - 1) & 1);
        }
        mbar_expect_tx(bar_q(b), kTBytes);
        tma_tile<D>(sQ(b), &tq, bar_q(b), kBlock, w.h, w.tile * kBlock, w.n);
        for (int j = 0; j <= w.tile; ++j, ++jg) {
          const int s = jg % kRing;
          if (jg >= kRing) mbar_wait(bar_e(s), (jg / kRing - 1) & 1);
          mbar_expect_tx(bar_k(s), kTBytes);
          tma_tile<D>(sK(s), &tk, bar_k(s), kBlock, w.h, j * kBlock, w.n);
          mbar_expect_tx(bar_v(s), kTBytes);
          tma_tile<D>(sK(s) + kTBytes, &tv, bar_v(s), kBlock, w.h,
                      j * kBlock, w.n);
        }
      }
    }
    return;
  }

  // consumer warpgroups: 64 query rows each, 16 a warp
  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - kWg;
  const int wg = ct / kWg, warp = (ct / 32) % 4, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  // Fw<D>::kTurns: the two consumers issue their products in turns
  // (named barrier 1 + wg is this warpgroup's turn; the first is the first
  // warpgroup's), so that one's softmax runs beside the other's products
  auto take_turn = [&]() {
    if constexpr (F::kTurns) consumers_sync(1 + wg);
  };
  auto pass_turn = [&]() {
    if constexpr (F::kTurns) consumers_arrive(2 - wg);
  };
  if constexpr (F::kTurns) {
    if (wg == 0) consumers_arrive(1);
  }
  // s = q k^T for 64 rows x 128 keys, both operands K-major
  auto issue_qk = [&](float (&sc)[64], uint64_t qdesc, int s) {
    const uint64_t kdesc = L::desc(sK(s));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n128(sc, qdesc + L::kstep(kk, kBlock),
                    kdesc + L::kstep(kk, kBlock), kk);
    }
  };
  // o += p v: p as bf16 from registers, v MN-major
  auto issue_pv = [&](float (&acc)[D / 2],
                      const uint32_t (&pa)[kBlock / 16][4], int s) {
    const uint64_t vdesc = L::desc(sK(s) + kTBytes, L::mn_lbo(kBlock));
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      wgmma_rs(acc, pa[kk], vdesc + L::kMNStep * kk, 1);
    }
  };

  float acc[D / 2], sc[64];
  uint32_t pa[kBlock / 16][4];
  int jg = 0;                                  // K/V tiles consumed so far
  for (int it = 0; it * (int)gridDim.x < items; ++it) {
    const int i = item_index(it);
    if (i >= items) break;
    const Item w = item_at(i, n_qt - 1, -1, H, N);
    // nk: key tiles to the diagonal
    const int b = it & (kBufs - 1), nk = w.tile + 1;
    const int row0 = w.tile * kBlock + wg * 64 + warp * 16 + g;  // + 8
    const uint64_t qdesc = L::desc(sQ(b) + wg * 64 * L::kRowBytes);
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, al0, al1;

    mbar_wait(bar_q(b), (it >> kBufShift) & 1);
    int s = jg % kRing;
    mbar_wait(bar_k(s), (jg / kRing) & 1);
    take_turn();
    wgmma_fence();
    issue_qk(sc, qdesc, s);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    if (nk == 1) mbar_arrive(bar_qe(b));       // q is read for the last time
    softmax_tile(sc, m0, m1, l0, l1, al0, al1, nk == 1, 0, row0, t,
                 scale_log2);
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) frag_to_a(pa[kk], sc, kk);

    // tile j's q k^T runs on the tensor cores while tile j - 1's p v is
    // issued behind it; tile j's softmax overlaps that p v
    for (int j = 1; j < nk; ++j) {
      const int sp = s, jj = jg + j;
      s = jj % kRing;
      mbar_wait(bar_k(s), (jj / kRing) & 1);
      mbar_wait(bar_v(sp), ((jj - 1) / kRing) & 1);
      take_turn();
      wgmma_fence();
      issue_qk(sc, qdesc, s);
      wgmma_commit();
      issue_pv(acc, pa, sp);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      if (j == nk - 1) mbar_arrive(bar_qe(b));
      softmax_tile(sc, m0, m1, l0, l1, al0, al1, j == nk - 1, j * kBlock,
                   row0, t, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_e(sp));
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c] *= al0;
        acc[4 * c + 1] *= al0;
        acc[4 * c + 2] *= al1;
        acc[4 * c + 3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) frag_to_a(pa[kk], sc, kk);
    }
    mbar_wait(bar_v(s), ((jg + nk - 1) / kRing) & 1);
    take_turn();
    wgmma_fence();
    issue_pv(acc, pa, s);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_e(s));
    jg += nk;

    l0 += __shfl_xor_sync(kFull, l0, 1);
    l0 += __shfl_xor_sync(kFull, l0, 2);
    l1 += __shfl_xor_sync(kFull, l1, 1);
    l1 += __shfl_xor_sync(kFull, l1, 2);
    store_frag(o + w.n * so.n + w.h * so.h, so.s, row0, S, acc, 1.0f / l0,
               1.0f / l1, t);
    if (t == 0) {
      float* lb = lse + ((long long)w.n * H + w.h) * S;
      if (row0 < S) lb[row0] = m0 * scale_log2 * kLn2 + logf(l0);
      if (row0 + 8 < S) lb[row0 + 8] = m1 * scale_log2 * kLn2 + logf(l1);
    }
  }
}

// rowsum(dO o) of rows r and r + 8 of a 128-row dO tile and O tile as TMA
// wrote them (each part's rows kRowBytes long, 16-byte chunks swizzled by
// the row): the four threads of a quad (t) sum a quarter of each part's
// chunks, the quad reduces.
template <int D>
__device__ __forceinline__ float2 row_delta(const uint8_t* dout,
                                            const uint8_t* o, int r, int t) {
  using L = Bw<D>;
  constexpr int kPer = L::kRowBytes / 64;      // chunks a thread of a row
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if constexpr (kPer == 0) {
      // 32-byte rows: 8 bytes a thread, half of chunk t / 2
      const int off = row * L::kRowBytes + (L::chunk(row, t >> 1) << 4) +
                      8 * (t & 1);
      const uint2 a = *reinterpret_cast<const uint2*>(dout + off);
      const uint2 b = *reinterpret_cast<const uint2*>(o + off);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 fa = __bfloat1622float2(pa[e]);
        const float2 fb = __bfloat1622float2(pb[e]);
        sum[h] = fmaf(fa.x, fb.x, sum[h]);
        sum[h] = fmaf(fa.y, fb.y, sum[h]);
      }
    }
#pragma unroll
    for (int p = 0; p < L::kParts; ++p) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int off = p * kBlock * L::kRowBytes + row * L::kRowBytes +
                        (L::chunk(row, kPer * t + k) << 4);
        const uint4 a = *reinterpret_cast<const uint4*>(dout + off);
        const uint4 b = *reinterpret_cast<const uint4*>(o + off);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(pa[e]);
          const float2 fb = __bfloat1622float2(pb[e]);
          sum[h] = fmaf(fa.x, fb.x, sum[h]);
          sum[h] = fmaf(fa.y, fb.y, sum[h]);
        }
      }
    }
    sum[h] += __shfl_xor_sync(kFull, sum[h], 1);
    sum[h] += __shfl_xor_sync(kFull, sum[h], 2);
  }
  return make_float2(sum[0], sum[1]);
}

// dq's elementwise step over one key tile (64 rows x 2 N keys a
// warpgroup), in place: s becomes ds = p (dp - delta), p = exp2(s scale
// log2e - lse log2e) masked on the diagonal tile (`key0` its first key).
// ls0, ls1 are the rows' lse times log2e, dl0, dl1 their delta.
template <int N>
__device__ __forceinline__ void dq_tile(float (&sc)[N], const float (&dp)[N],
                                        float ls0, float ls1, float dl0,
                                        float dl1, bool diag, int key0,
                                        int row0, int t, float scale_log2) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool lo = e < 2;
      float p = fast_exp2(fmaf(sc[4 * c + e], scale_log2, lo ? -ls0 : -ls1));
      if (diag && key0 + 8 * c + 2 * t + (e & 1) > row0 + (e >> 1) * 8) {
        p = 0.0f;
      }
      sc[4 * c + e] = p * (dp[4 * c + e] - (lo ? dl0 : dl1));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq,
                        int S, int H, int N, Strides sdq, float scale,
                        float scale_log2) {
  using L = Bw<D>;
  constexpr int kKeys = L::kDqKeys, kBufs = L::kDqBufs;
  constexpr int kBufShift = kBufs == 2 ? 1 : 0;
  constexpr uint32_t kQBytes = L::kDqQBytes, kKBytes = L::kDqKBytes;
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar0 = base + L::kDqBar;
  const int n_qt = (S + kBlock - 1) / kBlock;
  const int items = n_qt * H * N;
  // Q of buffer b at base + 2 b kQBytes, dO kQBytes after it, its lse at
  // base + kDqStat + b 4 kBlock; O at base + kDqO; stage s: K at base +
  // kDqK + 2 s kKBytes, V kKBytes after it; barriers from bar0:
  // q[kBufs], q_empty[kBufs], o, o_empty, full[s], empty[s]
  auto sQ = [&](int b) { return base + 2 * b * kQBytes; };
  const uint32_t sO = base + L::kDqO;
  auto sK = [&](int s) { return base + L::kDqK + 2 * s * kKBytes; };
  auto sL = [&](int b) { return base + L::kDqStat + b * 4 * kBlock; };
  auto bar_q = [&](int b) { return bar0 + 8 * b; };
  auto bar_qe = [&](int b) { return bar0 + 8 * (kBufs + b); };
  const uint32_t bar_o = bar0 + 8 * (2 * kBufs);
  const uint32_t bar_oe = bar0 + 8 * (2 * kBufs + 1);
  auto bar_f = [&](int s) { return bar0 + 8 * (2 * kBufs + 2 + s); };
  auto bar_e = [&](int s) {
    return bar0 + 8 * (2 * kBufs + 2 + kStages + s);
  };
  auto generic = [&](uint32_t a) { return smem + (a - raw); };
  // key tiles of an item's walk: to the diagonal of its last rows (at 64
  // keys a tile, none wholly past S)
  auto key_tiles = [&](int tile) {
    if constexpr (kKeys == kBlock) {
      return tile + 1;
    } else {
      const int to_diag = (tile + 1) * (kBlock / kKeys);
      const int in_s = (S + kKeys - 1) / kKeys;
      return to_diag < in_s ? to_diag : in_s;
    }
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(bar_q(b), 1);
      mbar_init(bar_qe(b), kConsumerThreads);
    }
    mbar_init(bar_o, 1);
    mbar_init(bar_oe, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // producer warpgroup: one thread keeps the ring full, across items
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int jg = 0;                              // K/V tiles loaded so far
      for (int it = 0; it * (int)gridDim.x < items; ++it) {
        const int i = item_index(it);
        if (i >= items) break;
        const Item w = item_at(i, n_qt - 1, -1, H, N);
        const int b = it & (kBufs - 1), q0 = w.tile * kBlock;
        const int rows = S - q0 < kBlock ? S - q0 : kBlock;
        if (it >= kBufs) {
          mbar_wait(bar_qe(b), ((it >> kBufShift) - 1) & 1);
        }
        mbar_expect_tx(bar_q(b), 2 * kQBytes + 4 * rows);
        tma_tile<D>(sQ(b), &tq, bar_q(b), kBlock, w.h, q0, w.n);
        tma_tile<D>(sQ(b) + kQBytes, &tdo, bar_q(b), kBlock, w.h, q0, w.n);
        bulk_load(sL(b), lse + ((long long)w.n * H + w.h) * S + q0, 4 * rows,
                  bar_q(b));
        if (it >= 1) mbar_wait(bar_oe, (it - 1) & 1);
        mbar_expect_tx(bar_o, kQBytes);
        tma_tile<D>(sO, &to, bar_o, kBlock, w.h, q0, w.n);
        const int nk = key_tiles(w.tile);
        for (int j = 0; j < nk; ++j, ++jg) {
          const int s = jg % kStages;
          if (jg >= kStages) mbar_wait(bar_e(s), (jg / kStages - 1) & 1);
          mbar_expect_tx(bar_f(s), 2 * kKBytes);
          tma_tile<D>(sK(s), &tk, bar_f(s), kKeys, w.h, j * kKeys, w.n);
          tma_tile<D>(sK(s) + kKBytes, &tv, bar_f(s), kKeys, w.h,
                      j * kKeys, w.n);
        }
      }
    }
    return;
  }

  // consumer warpgroups: 64 query rows each, 16 a warp
  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - kWg;
  const int wg = ct / kWg, warp = (ct / 32) % 4, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rl = wg * 64 + warp * 16 + g;      // row in the tile, and + 8
  // s = q k^T and dp = dO v^T for 64 rows x kKeys keys, all K-major
  auto issue_s = [&](float (&sc)[kKeys / 2], float (&dp)[kKeys / 2],
                     uint64_t qdesc, int s) {
    const uint64_t kdesc = L::desc(sK(s));
    const uint64_t ddesc = qdesc + (kQBytes >> 4);
    const uint64_t vdesc = kdesc + (kKBytes >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(sc, qdesc + L::kstep(kk, kBlock), kdesc + L::kstep(kk, kKeys),
               kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(dp, ddesc + L::kstep(kk, kBlock), vdesc + L::kstep(kk, kKeys),
               kk);
    }
  };
  // dq += ds k: ds as bf16 from registers, k MN-major
  auto issue_dq = [&](float (&acc)[D / 2],
                      const uint32_t (&da)[kKeys / 16][4], int s) {
    const uint64_t kdesc = L::desc(sK(s), L::mn_lbo(kKeys));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs(acc, da[kk], kdesc + L::kMNStep * kk, 1);
    }
  };

  float acc[D / 2], sc[kKeys / 2], dp[kKeys / 2];
  uint32_t da[kKeys / 16][4];
  int jg = 0;                                  // K/V tiles consumed so far
  for (int it = 0; it * (int)gridDim.x < items; ++it) {
    const int i = item_index(it);
    if (i >= items) break;
    const Item w = item_at(i, n_qt - 1, -1, H, N);
    const int b = it & (kBufs - 1);
    const int nk = key_tiles(w.tile);          // key tiles of the item
    // this warpgroup's: at 64 keys a tile, the first warpgroup's rows end
    // a tile before the item's diagonal
    int nkw = nk;
    if constexpr (kKeys < kBlock) {
      const int own = (w.tile * kBlock + wg * 64 + 64) / kKeys;
      nkw = own < nk ? own : nk;
    }
    const int row0 = w.tile * kBlock + rl;
    const uint64_t qdesc = L::desc(sQ(b) + wg * 64 * L::kRowBytes);

    // delta from this item's dO and O; lse of the rows (0 past S, where
    // q and dO are zero)
    mbar_wait(bar_q(b), (it >> kBufShift) & 1);
    mbar_wait(bar_o, it & 1);
    const float2 dl = row_delta<D>(generic(sQ(b) + kQBytes), generic(sO),
                                   rl, t);
    fence_proxy_async();
    mbar_arrive(bar_oe);                       // O is read
    const float* ls = reinterpret_cast<const float*>(generic(sL(b)));
    const float ls0 = row0 < S ? ls[rl] * kLog2e : 0.0f;
    const float ls1 = row0 + 8 < S ? ls[rl + 8] * kLog2e : 0.0f;
    if (t == 0) {
      float* db = delta + ((long long)w.n * H + w.h) * S;
      if (row0 < S) db[row0] = dl.x;
      if (row0 + 8 < S) db[row0 + 8] = dl.y;
    }
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.0f;

    int s = jg % kStages;
    mbar_wait(bar_f(s), (jg / kStages) & 1);
    wgmma_fence();
    issue_s(sc, dp, qdesc, s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (nkw == 1) mbar_arrive(bar_qe(b));      // q and dO read for the last
    dq_tile(sc, dp, ls0, ls1, dl.x, dl.y, nkw == 1, 0, row0, t, scale_log2);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) frag_to_a(da[kk], sc, kk);

    // tile j's two score products run on the tensor cores while tile j -
    // 1's ds k is issued behind them; tile j's elementwise step overlaps
    // that ds k
    for (int j = 1; j < nkw; ++j) {
      const int sp = s, jj = jg + j;
      s = jj % kStages;
      mbar_wait(bar_f(s), (jj / kStages) & 1);
      wgmma_fence();
      issue_s(sc, dp, qdesc, s);
      wgmma_commit();
      issue_dq(acc, da, sp);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      if (j == nkw - 1) mbar_arrive(bar_qe(b));
      dq_tile(sc, dp, ls0, ls1, dl.x, dl.y, j == nkw - 1, j * kKeys, row0, t,
              scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(bar_e(sp));                  // k, v of tile j - 1 read
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) frag_to_a(da[kk], sc, kk);
    }
    wgmma_fence();
    issue_dq(acc, da, s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_e(s));
    if constexpr (kKeys < kBlock) {
      // the item's tiles past this warpgroup's rows: released unread,
      // each once it has landed (so the arrival counts for this fill)
      for (int j = nkw; j < nk; ++j) {
        const int jj = jg + j;
        mbar_wait(bar_f(jj % kStages), (jj / kStages) & 1);
        mbar_arrive(bar_e(jj % kStages));
      }
    }
    jg += nk;

    store_frag(dq + w.n * sdq.n + w.h * sdq.h, sdq.s, row0, S, acc, scale,
               scale, t);
  }
}

// dk/dv's elementwise step over one query tile (64 keys x 2 N queries a
// warpgroup), in place: s^T becomes p^T = exp2(s^T scale log2e - lse
// log2e), masked on the diagonal (query < key), and dp^T becomes ds^T =
// p^T (dp^T - delta). lse and delta of the tile's queries are read from
// shared memory once per column pair of the thread.
template <int N>
__device__ __forceinline__ void dkv_tile(float (&pt)[N], float (&dpt)[N],
                                         const float2* ls, const float2* dl,
                                         bool diag, int q0, int key0, int t,
                                         float scale_log2) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float2 l2 = ls[4 * c + t], d2 = dl[4 * c + t];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lq = ((e & 1) ? l2.y : l2.x) * kLog2e;
      const float dq = (e & 1) ? d2.y : d2.x;
      float p = fast_exp2(fmaf(pt[4 * c + e], scale_log2, -lq));
      if (diag && q0 + 8 * c + 2 * t + (e & 1) < key0 + (e >> 1) * 8) {
        p = 0.0f;
      }
      pt[4 * c + e] = p;
      dpt[4 * c + e] = p * (dpt[4 * c + e] - dq);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int H, int N, Strides sdk, Strides sdv, float scale,
                         float scale_log2) {
  using L = Bw<D>;
  constexpr int kRows = L::kDkvRows;          // queries a stage
  constexpr uint32_t kKBytes = L::kDkvKBytes, kQBytes = L::kDkvQBytes;
  constexpr uint32_t kStat = L::kDkvStatBytes;
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar0 = base + L::kDkvBar;
  const int n_kt = (S + kBlock - 1) / kBlock;
  const int items = n_kt * H * N;
  // K of buffer b at base + 2 b kKBytes, V kKBytes after it; stage s: Q
  // at base + kDkvStage + 2 s kQBytes, dO kQBytes after it, its lse at
  // base + kDkvStat + s kStat, its delta kStages kStat after that;
  // barriers from bar0: kv[2], kv_empty[2], full[s], empty[s]
  auto sK = [&](int b) { return base + 2 * b * kKBytes; };
  auto sQ = [&](int s) { return base + L::kDkvStage + 2 * s * kQBytes; };
  auto sL = [&](int s) { return base + L::kDkvStat + s * kStat; };
  auto sD = [&](int s) { return sL(s) + kStages * kStat; };
  auto bar_kv = [&](int b) { return bar0 + 8 * b; };
  auto bar_kve = [&](int b) { return bar0 + 8 * (2 + b); };
  auto bar_f = [&](int s) { return bar0 + 8 * (4 + s); };
  auto bar_e = [&](int s) { return bar0 + 8 * (4 + kStages + s); };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_kv(b), 1);
      mbar_init(bar_kve(b), kConsumerThreads);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int jg = 0;                              // Q/dO tiles loaded so far
      for (int it = 0; it * (int)gridDim.x < items; ++it) {
        const int i = item_index(it);
        if (i >= items) break;
        const Item w = item_at(i, 0, 1, H, N);
        const int b = it & 1;
        const int q_first = w.tile * (kBlock / kRows);
        const long long stat = ((long long)w.n * H + w.h) * S;
        if (it >= 2) mbar_wait(bar_kve(b), ((it >> 1) - 1) & 1);
        mbar_expect_tx(bar_kv(b), 2 * kKBytes);
        tma_tile<D>(sK(b), &tk, bar_kv(b), kBlock, w.h, w.tile * kBlock,
                    w.n);
        tma_tile<D>(sK(b) + kKBytes, &tv, bar_kv(b), kBlock, w.h,
                    w.tile * kBlock, w.n);
        for (int qi = q_first; qi < S / kRows; ++qi, ++jg) {
          const int s = jg % kStages, q0 = qi * kRows;
          if (jg >= kStages) mbar_wait(bar_e(s), (jg / kStages - 1) & 1);
          mbar_expect_tx(bar_f(s), 2 * kQBytes + 2 * kStat);
          tma_tile<D>(sQ(s), &tq, bar_f(s), kRows, w.h, q0, w.n);
          tma_tile<D>(sQ(s) + kQBytes, &tdo, bar_f(s), kRows, w.h, q0, w.n);
          bulk_load(sL(s), lse + stat + q0, kStat, bar_f(s));
          bulk_load(sD(s), delta + stat + q0, kStat, bar_f(s));
        }
      }
    }
    return;
  }

  // consumer warpgroups: 64 keys each, 16 a warp
  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - kWg;
  const int wg = ct / kWg, warp = (ct / 32) % 4, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  // s^T = k q^T and dp^T = v dO^T, 64 keys x kRows queries, K-major
  auto issue_s = [&](float (&pt)[kRows / 2], float (&dpt)[kRows / 2],
                     uint64_t kdesc, uint64_t vdesc, int s) {
    const uint64_t qd = L::desc(sQ(s));
    const uint64_t dd = L::desc(sQ(s) + kQBytes);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(pt, kdesc + L::kstep(kk, kBlock), qd + L::kstep(kk, kRows),
               kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(dpt, vdesc + L::kstep(kk, kBlock), dd + L::kstep(kk, kRows),
               kk);
    }
  };
  // dv += p^T dO and dk += ds^T q: A bf16 from registers, B MN-major
  auto issue_grad = [&](float (&dva)[D / 2], float (&dka)[D / 2],
                        const uint32_t (&pa)[kRows / 16][4],
                        const uint32_t (&da)[kRows / 16][4], int s) {
    const uint64_t qd = L::desc(sQ(s), L::mn_lbo(kRows));
    const uint64_t dd = L::desc(sQ(s) + kQBytes, L::mn_lbo(kRows));
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs(dva, pa[kk], dd + L::kMNStep * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs(dka, da[kk], qd + L::kMNStep * kk, 1);
    }
  };
  auto step = [&](float (&pt)[kRows / 2], float (&dpt)[kRows / 2], int s,
                  int q0, int kw0, int key0) {
    dkv_tile(pt, dpt, reinterpret_cast<const float2*>(smem + (sL(s) - raw)),
             reinterpret_cast<const float2*>(smem + (sD(s) - raw)),
             q0 < kw0 + 64, q0, key0, t, scale_log2);
  };

  float dka[D / 2], dva[D / 2], pt[kRows / 2], dpt[kRows / 2];
  uint32_t pa[kRows / 16][4], da[kRows / 16][4];
  int jg = 0;                                  // Q/dO tiles consumed so far
  for (int it = 0; it * (int)gridDim.x < items; ++it) {
    const int i = item_index(it);
    if (i >= items) break;
    const Item w = item_at(i, 0, 1, H, N);
    const int b = it & 1;
    const int q_first = w.tile * (kBlock / kRows);   // the diagonal's
    const int nq = S / kRows - q_first;
    const int kw0 = w.tile * kBlock + wg * 64;   // the warpgroup's first key
    const int key0 = kw0 + warp * 16 + g;        // and key0 + 8
    const uint64_t kdesc = L::desc(sK(b) + wg * 64 * L::kRowBytes);
    const uint64_t vdesc = kdesc + (kKBytes >> 4);
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dka[r] = dva[r] = 0.0f;
    // the query tiles that lie wholly before the second warpgroup's keys
    // add nothing there: that warpgroup starts after them
    const int j0 = wg * (64 / kRows);
    for (int j = 0; j < j0 && j < nq; ++j) {
      mbar_wait(bar_f((jg + j) % kStages), ((jg + j) / kStages) & 1);
      mbar_arrive(bar_e((jg + j) % kStages));
    }
    if (j0 >= nq) mbar_arrive(bar_kve(b));
    if (j0 < nq) {
      mbar_wait(bar_kv(b), (it >> 1) & 1);
      int s = (jg + j0) % kStages;
      int q0 = (q_first + j0) * kRows;
      mbar_wait(bar_f(s), ((jg + j0) / kStages) & 1);
      wgmma_fence();
      issue_s(pt, dpt, kdesc, vdesc, s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pt);
      fence_regs(dpt);
      if (j0 == nq - 1) mbar_arrive(bar_kve(b));   // k, v read for the last
      step(pt, dpt, s, q0, kw0, key0);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        frag_to_a(pa[kk], pt, kk);
        frag_to_a(da[kk], dpt, kk);
      }
      // tile j's two score products run while tile j - 1's two gradient
      // products are issued behind them; tile j's elementwise step
      // overlaps those
      for (int j = j0 + 1; j < nq; ++j) {
        const int sp = s;
        s = (jg + j) % kStages;
        q0 = (q_first + j) * kRows;
        mbar_wait(bar_f(s), ((jg + j) / kStages) & 1);
        wgmma_fence();
        issue_s(pt, dpt, kdesc, vdesc, s);
        wgmma_commit();
        issue_grad(dva, dka, pa, da, sp);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(pt);
        fence_regs(dpt);
        if (j == nq - 1) mbar_arrive(bar_kve(b));
        step(pt, dpt, s, q0, kw0, key0);
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        mbar_arrive(bar_e(sp));
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          frag_to_a(pa[kk], pt, kk);
          frag_to_a(da[kk], dpt, kk);
        }
      }
      wgmma_fence();
      issue_grad(dva, dka, pa, da, s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(bar_e(s));
    }
    jg += nq;

    store_frag(dk + w.n * sdk.n + w.h * sdk.h, sdk.s, key0, S, dka, scale,
               scale, t);
    store_frag(dv + w.n * sdv.n + w.h * sdv.h, sdv.s, key0, S, dva, 1.0f,
               1.0f, t);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime, so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D tensor map (D, H, S, N) of a strided (N, S, H, D) bf16 operand,
// read in boxes of `rows` positions of one head and one swizzle row
// (Bw<D>::kAtom columns: 128 bytes under the 128-byte swizzle, or at D =
// 32 64 bytes under the 64-byte one). Rows past S read as zeros; the box
// never crosses into the next sequence.
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int N, int S, int H,
                Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)N};
  const cuuint64_t bytes[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                               (cuuint64_t)st.n * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Bw<D>::kAtom, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, bytes, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Bw<D>::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : Bw<D>::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise a kernel's dynamic shared-memory limit. Being a runtime call, it
// also makes the device's primary context current on the calling thread,
// which the driver's tensor-map encoder needs: PyTorch's autograd runs a
// backward on a thread of its own, where a kernel wrapper may make the
// first CUDA call. So it comes before the tensor maps.
template <typename Kernel>
cudaError_t bind_and_set_smem(Kernel kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// CTAs of a persistent kernel: one per SM (the kernels take one SM
// each), at most one per work item; -1 if the device cannot be queried.
int persistent_grid(int items) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  return items < sms ? items : sms;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int N, int S, int H, int dim, const long long* strides, float scale,
        void* stream) {
  using F = Fw<D>;
  if (bad_shape(N, S, H, dim, D)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = bind_and_set_smem(flash_fwd_kernel<D>, F::kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(&tq, q, N, S, H, at(strides, 0), kBlock) ||
      !tensor_map<D>(&tk, k, N, S, H, at(strides, 1), kBlock) ||
      !tensor_map<D>(&tv, v, N, S, H, at(strides, 2), kBlock)) {
    return kEncodeFailed;
  }
  const int grid = persistent_grid((S + kBlock - 1) / kBlock * H * N);
  if (grid < 0) return (int)cudaGetLastError();
  flash_fwd_kernel<D><<<grid, kWsThreads, F::kSmem, (cudaStream_t)stream>>>(
      tq, tk, tv, (bf16*)o, lse, S, H, N, at(strides, 3), scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, int N,
           int S, int H, int dim, const long long* strides, float scale,
           void* stream) {
  using L = Bw<D>;
  if (bad_shape(N, S, H, dim, D)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      bind_and_set_smem(flash_bwd_dq_kernel<D>, L::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, to, tdo;
  if (!tensor_map<D>(&tq, q, N, S, H, at(strides, 0), kBlock) ||
      !tensor_map<D>(&tk, k, N, S, H, at(strides, 1), L::kDqKeys) ||
      !tensor_map<D>(&tv, v, N, S, H, at(strides, 2), L::kDqKeys) ||
      !tensor_map<D>(&to, o, N, S, H, at(strides, 3), kBlock) ||
      !tensor_map<D>(&tdo, dout, N, S, H, at(strides, 4), kBlock)) {
    return kEncodeFailed;
  }
  const int grid = persistent_grid((S + kBlock - 1) / kBlock * H * N);
  if (grid < 0) return (int)cudaGetLastError();
  flash_bwd_dq_kernel<D><<<grid, kWsThreads, L::kDqSmem,
                           (cudaStream_t)stream>>>(
      tq, tk, tv, to, tdo, lse, delta, (bf16*)dq, S, H, N, at(strides, 5),
      scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int N,
            int S, int H, int dim, const long long* strides, float scale,
            void* stream) {
  using L = Bw<D>;
  if (bad_shape(N, S, H, dim, D)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      bind_and_set_smem(flash_bwd_dkv_kernel<D>, L::kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map<D>(&tq, q, N, S, H, at(strides, 0), L::kDkvRows) ||
      !tensor_map<D>(&tk, k, N, S, H, at(strides, 1), kBlock) ||
      !tensor_map<D>(&tv, v, N, S, H, at(strides, 2), kBlock) ||
      !tensor_map<D>(&tdo, dout, N, S, H, at(strides, 3), L::kDkvRows)) {
    return kEncodeFailed;
  }
  const int grid = persistent_grid((S + kBlock - 1) / kBlock * H * N);
  if (grid < 0) return (int)cudaGetLastError();
  flash_bwd_dkv_kernel<D><<<grid, kWsThreads, L::kDkvSmem,
                            (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, lse, delta, (bf16*)dk, (bf16*)dv, S, H, N,
      at(strides, 4), at(strides, 5), scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points, named as ops/flash_attention.py's route table names
// them, each with the dynamic shared memory of its launch beside it as
// <name>_smem_bytes. The forward, one a head width: flash_fwd at D = 64,
// flash_fwd_bf16_d<D> at D = 32 and 128 (D = 16's is flash_tiled.cu's);
// strides q, k, v, o.
#define FLASH_FWD(NAME, DIM)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      float* lse, int N, int S, int H, int D,                 \
                      const long long* strides, float scale, void* stream) {  \
    return fwd<DIM>(q, k, v, o, lse, N, S, H, D, strides, scale, stream);     \
  }                                                                           \
  extern "C" int NAME##_smem_bytes() { return (int)Fw<DIM>::kSmem; }

FLASH_FWD(flash_fwd, 64)
FLASH_FWD(flash_fwd_bf16_d32, 32)
FLASH_FWD(flash_fwd_bf16_d128, 128)

// The backward, one pair a head width: flash_bwd_dq and flash_bwd_dkv at
// D = 64, flash_bwd_dq_bf16_d<D> and flash_bwd_dkv_bf16_d<D> at D = 16, 32
// and 128. dq: strides q, k, v, o, dO, dq; writes delta (N, H, S) float32.
// dk/dv: strides q, k, v, dO, dk, dv; reads the delta that dq wrote.
#define FLASH_BWD(DQ, DKV, DIM)                                               \
  extern "C" int DQ(const void* q, const void* k, const void* v,              \
                    const void* o, const void* dout, const float* lse,        \
                    float* delta, void* dq, int N, int S, int H, int D,       \
                    const long long* strides, float scale, void* stream) {    \
    return bwd_dq<DIM>(q, k, v, o, dout, lse, delta, dq, N, S, H, D,          \
                       strides, scale, stream);                               \
  }                                                                           \
  extern "C" int DKV(const void* q, const void* k, const void* v,             \
                     const void* dout, const float* lse, const float* delta,  \
                     void* dk, void* dv, int N, int S, int H, int D,          \
                     const long long* strides, float scale, void* stream) {   \
    return bwd_dkv<DIM>(q, k, v, dout, lse, delta, dk, dv, N, S, H, D,        \
                        strides, scale, stream);                              \
  }                                                                           \
  extern "C" int DQ##_smem_bytes() { return (int)Bw<DIM>::kDqSmem; }          \
  extern "C" int DKV##_smem_bytes() { return (int)Bw<DIM>::kDkvSmem; }

FLASH_BWD(flash_bwd_dq, flash_bwd_dkv, 64)
FLASH_BWD(flash_bwd_dq_bf16_d16, flash_bwd_dkv_bf16_d16, 16)
FLASH_BWD(flash_bwd_dq_bf16_d32, flash_bwd_dkv_bf16_d32, 32)
FLASH_BWD(flash_bwd_dq_bf16_d128, flash_bwd_dkv_bf16_d128, 128)

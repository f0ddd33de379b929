// Host gather of the PyTorch port: gather the round's client batches out of
// the packed uint8 image store, augment them and normalise them, in one
// multithreaded pass, uint8 -> float32 NHWC. The same C ABI and the same
// arithmetic as the JAX package's native/fedloader.cpp, so a library built
// from either source with the same flags computes the same bits.
//
//   fedloader_gather_augment(...)  - reflect-pad crop, flip, normalise
//   fedloader_gather_normalize(...) - gather and normalise only
//
// Determinism: each item draws from a splitmix64 stream seeded by
// (seed, item index), so the output does not depend on the thread count.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// reflect index into [0, n): torchvision "reflect" padding semantics
inline int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

struct AugmentJob {
  const uint8_t* images;   // (num_images, H, W, C) packed
  const int64_t* idx;      // (n,) flat image indices
  float* out;              // (n, H, W, C) float32
  int64_t n;
  int h, w, c;
  int pad;                 // crop shift radius (0 = no crop)
  int flip;                // 1 = random horizontal flip
  const float* mean;       // (C,)
  const float* stdinv;     // (C,) 1/std
  float scale;             // 1/255 for uint8 sources
  uint64_t seed;
};

void augment_range(const AugmentJob& j, int64_t lo, int64_t hi) {
  const int64_t plane = (int64_t)j.h * j.w * j.c;
  for (int64_t i = lo; i < hi; ++i) {
    const uint8_t* src = j.images + j.idx[i] * plane;
    float* dst = j.out + i * plane;
    uint64_t r = splitmix64(j.seed ^ (uint64_t)i * 0x2545F4914F6CDD1Dull);
    int dy = 0, dx = 0, do_flip = 0;
    if (j.pad > 0) {
      dy = (int)(r % (2 * j.pad + 1)) - j.pad;
      r = splitmix64(r);
      dx = (int)(r % (2 * j.pad + 1)) - j.pad;
      r = splitmix64(r);
    }
    if (j.flip) do_flip = (int)(r & 1);

    for (int y = 0; y < j.h; ++y) {
      const int sy = reflect(y + dy, j.h);
      for (int x = 0; x < j.w; ++x) {
        int xx = do_flip ? (j.w - 1 - x) : x;
        const int sx = reflect(xx + dx, j.w);
        const uint8_t* px = src + ((int64_t)sy * j.w + sx) * j.c;
        float* q = dst + ((int64_t)y * j.w + x) * j.c;
        for (int ch = 0; ch < j.c; ++ch) {
          q[ch] = ((float)px[ch] * j.scale - j.mean[ch]) * j.stdinv[ch];
        }
      }
    }
  }
}

void run_threaded(const AugmentJob& j, int num_threads) {
  if (num_threads <= 1 || j.n < 64) {
    augment_range(j, 0, j.n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (j.n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(j.n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&j, lo, hi] { augment_range(j, lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

void fedloader_gather_augment(const uint8_t* images, const int64_t* idx,
                              float* out, int64_t n, int h, int w, int c,
                              int pad, int flip, const float* mean,
                              const float* std, uint64_t seed,
                              int num_threads) {
  std::vector<float> stdinv(c);
  for (int ch = 0; ch < c; ++ch) stdinv[ch] = 1.0f / std[ch];
  AugmentJob j{images, idx, out, n, h, w, c, pad, flip,
               mean, stdinv.data(), 1.0f / 255.0f, seed};
  run_threaded(j, num_threads);
}

void fedloader_gather_normalize(const uint8_t* images, const int64_t* idx,
                                float* out, int64_t n, int h, int w, int c,
                                const float* mean, const float* std,
                                int num_threads) {
  std::vector<float> stdinv(c);
  for (int ch = 0; ch < c; ++ch) stdinv[ch] = 1.0f / std[ch];
  AugmentJob j{images, idx, out, n, h, w, c, /*pad=*/0, /*flip=*/0,
               mean, stdinv.data(), 1.0f / 255.0f, /*seed=*/0};
  run_threaded(j, num_threads);
}

}  // extern "C"

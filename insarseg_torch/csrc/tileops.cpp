// Host tile-preprocessing kernels of the port's data path (own copy of
// insarseg/native/tileops.cpp, the same functions and arithmetic, so the
// port's native loader gives the JAX package's arrays bit for bit). Host
// C++ only, no CUDA: driven through ctypes by
// insarseg_torch/data/native_loader.py, which builds it at first use with
// g++ -O3 -shared -fPIC into insarseg_torch/_build/, never into the source
// tree. Fused uint8 -> normalized-float conversion, the two mask
// contracts, threaded batch assembly and the host overlap-add stitch: one
// pass over the bytes, no numpy temporaries, the GIL released.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dst = (src/255 - mean) / std, fused as dst = src * a + b.
void normalize_u8(const uint8_t* src, float* dst, int64_t n, float mean,
                  float std_) {
  const float a = 1.0f / (255.0f * std_);
  const float b = -mean / std_;
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = static_cast<float>(src[i]) * a + b;
  }
}

// Legacy mask contract: the reference's ToTensor()/255 + .long() truncation
// maps exactly-255 pixels to class 1 and everything else to 0
// (SURVEY.md 2.2.16).
void mask_legacy(const uint8_t* src, int32_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = src[i] == 255 ? 1 : 0;
  }
}

// Index contract: raw class ids (keeps ignore_index usable).
void mask_index(const uint8_t* src, int32_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = static_cast<int32_t>(src[i]);
  }
}

// Batch assembly: normalize B tiles of hw pixels each from an array of
// source pointers into one contiguous (B, hw) float block, threaded.
void normalize_batch(const uint8_t** srcs, float* dst, int32_t batch,
                     int64_t hw, float mean, float std_, int32_t n_threads) {
  if (n_threads <= 1 || batch <= 1) {
    for (int32_t i = 0; i < batch; ++i) {
      normalize_u8(srcs[i], dst + i * hw, hw, mean, std_);
    }
    return;
  }
  std::vector<std::thread> threads;
  int32_t per = (batch + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int32_t lo = t * per;
    int32_t hi = lo + per < batch ? lo + per : batch;
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      for (int32_t i = lo; i < hi; ++i) {
        normalize_u8(srcs[i], dst + i * hw, hw, mean, std_);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Weighted overlap-add stitch accumulation on the host (a stream of tiles
// into a scene accumulator), the host twin of data/stitch.py for pipelines
// that stitch on the CPU while the card runs the next scene.
// acc += tile * w ; den += w over the (r0:r0+t, c0:c0+t) window.
void stitch_accumulate(float* acc, float* den, int64_t H, int64_t W,
                       int64_t C, const float* tile, const float* win,
                       int64_t t, int64_t r0, int64_t c0) {
  for (int64_t r = 0; r < t; ++r) {
    float* acc_row = acc + ((r0 + r) * W + c0) * C;
    float* den_row = den + (r0 + r) * W + c0;
    const float* tile_row = tile + r * t * C;
    const float* win_row = win + r * t;
    for (int64_t c = 0; c < t; ++c) {
      const float w = win_row[c];
      den_row[c] += w;
      for (int64_t k = 0; k < C; ++k) {
        acc_row[c * C + k] += tile_row[c * C + k] * w;
      }
    }
  }
}

}  // extern "C"

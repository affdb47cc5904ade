// Polyphase windowed-sinc resampler — native host-side component.
//
// Same math as toucan_tpu_torch/frontend/audio.py::resample (torchaudio-compatible
// kernel: hann^2-windowed sinc, lowpass_width 6, rolloff 0.99), implemented
// with double accumulation and a thread pool over output blocks.  Used by
// the reference-audio front end (set_utterance_embedding, cloning), where
// each recording is resampled to 16 kHz before its mel; see
// toucan_tpu_torch/native/__init__.py for the ctypes loading + the parity test
// in tests/test_torch_native.py.
//
// Reference context: the PyTorch reference resamples through torchaudio's
// Resample (AudioPreprocessor.py:24-44); this is a first-party host-side
// equivalent (SURVEY.md section 2.9).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

inline double sinc(double x) {
  if (x == 0.0) return 1.0;
  double px = M_PI * x;
  return std::sin(px) / px;
}

}  // namespace

extern "C" {

// Computes ceil(new_sr * n / orig_sr): the output length for a call to
// toucan_resample with the same arguments (call first to size the buffer).
int64_t toucan_resample_out_len(int64_t n, int64_t orig_sr, int64_t new_sr) {
  if (orig_sr == new_sr) return n;
  return (n * new_sr + orig_sr - 1) / orig_sr;
}

// in (n float32 samples at orig_sr) -> out (float32 at new_sr).  Returns the
// number of samples written, or -1 if out_cap is too small.
int64_t toucan_resample(const float* in, int64_t n, int64_t orig_sr,
                        int64_t new_sr, float* out, int64_t out_cap,
                        int32_t n_threads) {
  if (orig_sr == new_sr) {
    if (out_cap < n) return -1;
    std::memcpy(out, in, sizeof(float) * n);
    return n;
  }
  const double lowpass_width = 6.0;
  const double rolloff = 0.99;
  int64_t g = gcd64(orig_sr, new_sr);
  int64_t orig = orig_sr / g, neu = new_sr / g;
  double base_freq = 0.5 * rolloff * static_cast<double>(orig < neu ? orig : neu);
  int64_t width =
      static_cast<int64_t>(std::ceil(lowpass_width * orig / base_freq));
  int64_t K = 2 * width + orig;
  double scale = base_freq / orig;

  // kernel[p][k], p in [0, neu), k in [0, K): taps for output phase p
  std::vector<double> kernel(static_cast<size_t>(neu * K));
  for (int64_t p = 0; p < neu; ++p) {
    for (int64_t k = 0; k < K; ++k) {
      double t = (-(double)p / neu + (double)(k - width) / orig) * base_freq;
      if (t < -lowpass_width) t = -lowpass_width;
      if (t > lowpass_width) t = lowpass_width;
      double w = std::cos(t * M_PI / lowpass_width / 2.0);
      kernel[p * K + k] = sinc(t) * w * w * scale;
    }
  }

  int64_t n_blocks = (n + orig - 1) / orig;
  int64_t total = toucan_resample_out_len(n, orig_sr, new_sr);
  if (out_cap < total) return -1;

  auto worker = [&](int64_t b_lo, int64_t b_hi) {
    for (int64_t b = b_lo; b < b_hi; ++b) {
      int64_t in_base = b * orig - width;  // first input sample of the block
      for (int64_t p = 0; p < neu; ++p) {
        int64_t oi = b * neu + p;
        if (oi >= total) break;
        const double* kp = &kernel[p * K];
        double acc = 0.0;
        int64_t k_lo = in_base < 0 ? -in_base : 0;
        int64_t k_hi = K;
        if (in_base + k_hi > n) k_hi = n - in_base;
        for (int64_t k = k_lo; k < k_hi; ++k) {
          acc += kp[k] * static_cast<double>(in[in_base + k]);
        }
        out[oi] = static_cast<float>(acc);
      }
    }
  };

  int threads = n_threads > 0
                    ? n_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (threads > 8) threads = 8;
  if (threads <= 1 || n_blocks < 64) {
    worker(0, n_blocks);
  } else {
    std::vector<std::thread> pool;
    int64_t per = (n_blocks + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
      int64_t lo = t * per;
      int64_t hi = lo + per < n_blocks ? lo + per : n_blocks;
      if (lo >= hi) break;
      pool.emplace_back(worker, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  return total;
}

}  // extern "C"

// Native F0 estimator — Boersma-style autocorrelation + Viterbi.
//
// Mirrors toucan_tpu_torch/frontend/pitch.py (which replaces the reference's
// praat-parselmouth C++ dependency, FastSpeech2/PitchCalculator.py:64-73)
// exactly: same windowing, window-autocorrelation correction, candidate
// generation with octave cost, and Viterbi smoothing with octave-jump /
// voicing-transition costs.  Dataset building calls this through ctypes
// (toucan_tpu_torch/native/__init__.py) for a large host-side speedup over the
// numpy path; numerical parity is tested in tests/test_torch_clone.py.
//
// Build: g++ -O3 -shared -fPIC f0.cpp -o libtoucanf0.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

constexpr double kOctaveCost = 0.01;
constexpr double kVoicingThreshold = 0.45;
constexpr double kSilenceThreshold = 0.03;
constexpr double kOctaveJumpCost = 0.35;
constexpr double kVoicedUnvoicedCost = 0.14;
constexpr int kMaxCandidates = 15;

struct Candidate {
  double freq;      // 0 = unvoiced
  double strength;
};

// direct autocorrelation for lags [0, max_lag]
void autocorr(const double* x, int n, int max_lag, double* out) {
  for (int lag = 0; lag <= max_lag; ++lag) {
    double acc = 0.0;
    const int m = n - lag;
    for (int i = 0; i < m; ++i) acc += x[i] * x[i + lag];
    out[lag] = acc;
  }
}

double parabolic_interp(const double* r, int len, int lag, double* val) {
  if (lag >= 1 && lag < len - 1) {
    const double a = r[lag - 1], b = r[lag], c = r[lag + 1];
    const double denom = a - 2.0 * b + c;
    if (std::fabs(denom) > 1e-12) {
      double delta = 0.5 * (a - c) / denom;
      delta = std::min(0.5, std::max(-0.5, delta));
      *val = b - 0.25 * (a - c) * delta;
      return lag + delta;
    }
  }
  *val = r[lag];
  return static_cast<double>(lag);
}

}  // namespace

extern "C" {

// audio: n samples (mono, any scale); out: caller-allocated, >= capacity
// frames.  Returns the number of frames written (0 on bad args).
int toucan_estimate_f0(const double* audio, int64_t n, double sr, int hop,
                       double fmin, double fmax, double* out,
                       int64_t capacity) {
  if (n <= 0 || hop <= 0 || fmin <= 0 || fmax <= fmin) return 0;
  int window_len = static_cast<int>(3.0 / fmin * sr);
  window_len += window_len % 2;
  if (window_len > n) window_len = static_cast<int>(n) - (n % 2 ? 1 : 0);
  if (window_len < 4) return 0;

  double global_peak = 1e-12;
  for (int64_t i = 0; i < n; ++i)
    global_peak = std::max(global_peak, std::fabs(audio[i]));

  const int n_frames =
      std::max<int>(1, static_cast<int>((n - window_len) / hop) + 1);
  if (n_frames > capacity) return 0;
  const int t_start =
      static_cast<int>((n - ((static_cast<int64_t>(n_frames) - 1) * hop +
                             window_len)) / 2);

  // hanning window (numpy.hanning: symmetric)
  std::vector<double> window(window_len);
  for (int i = 0; i < window_len; ++i)
    window[i] = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / (window_len - 1));

  const int lag_min = static_cast<int>(sr / fmax);
  const int lag_max =
      std::min(static_cast<int>(sr / fmin) + 1, window_len - 1);

  std::vector<double> win_ac(lag_max + 1);
  autocorr(window.data(), window_len, lag_max, win_ac.data());
  const double win_ac0 = win_ac[0];
  for (auto& v : win_ac) v /= win_ac0;

  std::vector<std::vector<Candidate>> cands(n_frames);
  std::vector<double> frame(window_len), ac(lag_max + 1), r(lag_max + 1);

  for (int fi = 0; fi < n_frames; ++fi) {
    const double* src = audio + t_start + static_cast<int64_t>(fi) * hop;
    double local_peak = 1e-12, mean = 0.0;
    for (int i = 0; i < window_len; ++i) {
      local_peak = std::max(local_peak, std::fabs(src[i]));
      mean += src[i];
    }
    mean /= window_len;
    for (int i = 0; i < window_len; ++i)
      frame[i] = (src[i] - mean) * window[i];

    autocorr(frame.data(), window_len, lag_max, ac.data());
    auto& c = cands[fi];
    if (ac[0] <= 0) {
      c.push_back({0.0, kVoicingThreshold + 2.0});
      continue;
    }
    for (int lag = 0; lag <= lag_max; ++lag)
      r[lag] = (ac[lag] / ac[0]) / std::max(win_ac[lag], 1e-6);

    // unvoiced candidate (pitch.py lines 70-72)
    const double unvoiced_strength =
        kVoicingThreshold +
        std::max(0.0, 2.0 - (local_peak / global_peak) /
                              (kSilenceThreshold / (1.0 + kVoicingThreshold)));
    c.push_back({0.0, unvoiced_strength});

    // local maxima in (lag_min+1, lag_max-1), value > 0
    std::vector<int> peaks;
    for (int lag = lag_min + 1; lag + 1 < lag_max; ++lag)
      if (r[lag] > r[lag - 1] && r[lag] >= r[lag + 1] && r[lag] > 0)
        peaks.push_back(lag);
    std::stable_sort(peaks.begin(), peaks.end(),
                     [&](int a, int b) { return r[a] > r[b]; });
    if (static_cast<int>(peaks.size()) > kMaxCandidates)
      peaks.resize(kMaxCandidates);
    for (int lag : peaks) {
      double r_ref;
      const double lag_ref = parabolic_interp(r.data(), lag_max + 1, lag, &r_ref);
      const double f = sr / lag_ref;
      if (f < fmin || f > fmax) continue;
      const double strength =
          r_ref - kOctaveCost * std::log2(fmin * lag_ref / sr);
      c.push_back({f, strength});
    }
  }

  // Viterbi (higher score = better), matching pitch.py _viterbi
  std::vector<std::vector<double>> score(n_frames);
  std::vector<std::vector<int>> back(n_frames);
  score[0].resize(cands[0].size());
  for (size_t j = 0; j < cands[0].size(); ++j) score[0][j] = cands[0][j].strength;
  for (int i = 1; i < n_frames; ++i) {
    const auto& prev = cands[i - 1];
    const auto& cur = cands[i];
    score[i].assign(cur.size(), -1e300);
    back[i].assign(cur.size(), 0);
    for (size_t b = 0; b < cur.size(); ++b) {
      for (size_t a = 0; a < prev.size(); ++a) {
        double cost;
        const double fa = prev[a].freq, fb = cur[b].freq;
        if (fa == 0.0 && fb == 0.0) cost = 0.0;
        else if (fa == 0.0 || fb == 0.0) cost = kVoicedUnvoicedCost;
        else cost = kOctaveJumpCost * std::fabs(std::log2(fa / fb));
        const double total = score[i - 1][a] - cost + cur[b].strength;
        if (total > score[i][b]) {
          score[i][b] = total;
          back[i][b] = static_cast<int>(a);
        }
      }
    }
  }

  int j = static_cast<int>(std::max_element(score[n_frames - 1].begin(),
                                            score[n_frames - 1].end()) -
                           score[n_frames - 1].begin());
  for (int i = n_frames - 1; i >= 0; --i) {
    out[i] = cands[i][j].freq;
    if (i > 0) j = back[i][j];
  }
  return n_frames;
}

}  // extern "C"

// BigVGAN's alias-free SnakeBeta activation in one launch, f32.
//
// Replaces toucan_tpu/kernels/pallas_aliasfree.py::fused_alias_free_snake_interior
// (the Pallas kernel _kernel).  With h the 12-tap kaiser_sinc_filter(0.25, 0.3,
// 12), clamp(i, n) = min(max(i, 0), n - 1), per channel:
//
//   y[2v+r] = 2 * sum_{q<6} h[11-2q-r] * x[clamp(v+q+r-3, T)]     r in {0, 1}
//   s[i]    = y[i] + sin^2(e^alpha * y[i]) / (e^beta + 1e-9)
//   z[u]    = sum_{j<12} h[j] * s[clamp(2u+j-5, 2T)]
//
// which is upsample2 -> snake_beta -> downsample2 with replicate padding at
// both edges.  The Pallas kernel zero-pads and leaves the <= 6 edge samples
// to its caller because its time-folded layout makes clamping awkward; here
// the edges are index clamps, so one launch computes every sample.
//
// What bounds it on the H100: bytes.  Each output needs 13 inputs of its
// channel and costs about 56 flops and two sines (two 6-tap up FIRs, two
// snakes, one 12-tap down FIR) against 8 bytes moved (one f32 read, one f32
// write): below the card's ~20 f32 flops per byte.  So the design keeps the 2x signal on
// chip: a block stages TT + 12 input samples of CG channels in shared
// memory (the 6-sample halo per side recomputed, clamped at the sequence
// edges), computes the 2TT + 12 snake samples its outputs read into shared
// memory, and decimates from there.  Device memory sees each input once
// (plus the 12/TT halo) and each output once.
//
// Layout: x and z are (B, C, T) contiguous, time innermost, as the BigVGAN
// convs leave them; the block's loads and stores walk time so they
// coalesce.  sinf, not __sinf: e^alpha * y is not small.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int TT = 128;           // output samples per block
constexpr int CG = 16;            // channels per block
constexpr int HALO = 6;           // input reach per side
constexpr int XW = TT + 2 * HALO; // staged input samples
constexpr int SW = 2 * TT + 12;   // staged 2x samples
constexpr float EPS = 1e-9f;

__global__ void __launch_bounds__(NT) alias_free_snake_kernel(
    const float* __restrict__ x, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ taps, float* __restrict__ z,
    int T, int C) {
  __shared__ float s_x[CG][XW + 1];
  __shared__ float s_s[CG][SW + 1];
  __shared__ float s_a[CG], s_ib[CG];
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * TT;
  const int c0 = blockIdx.y * CG;
  const size_t batch = (size_t)blockIdx.z * T * C;
  const float* xb = x + batch;
  float* zb = z + batch;
  float h[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) h[j] = taps[j];

  if (tid < CG) {
    const int c = min(c0 + tid, C - 1);
    s_a[tid] = expf(alpha[c]);
    s_ib[tid] = 1.0f / (expf(beta[c]) + EPS);
  }
  // x[clamp(u0 - 6 + l, T)] for l in [0, XW)
  for (int idx = tid; idx < CG * XW; idx += NT) {
    const int c = idx / XW, l = idx - c * XW;
    const int g = min(max(u0 - HALO + l, 0), T - 1);
    const int cc = c0 + c;
    float v = 0.f;
    if (cc < C) v = xb[(size_t)cc * T + g];
    s_x[c][l] = v;
  }
  __syncthreads();

  // s[clamp(2 u0 - 6 + m, 2T)] for m in [0, SW)
  for (int idx = tid; idx < CG * SW; idx += NT) {
    const int c = idx / SW, m = idx - c * SW;
    const int i = min(max(2 * u0 - HALO + m, 0), 2 * T - 1);
    const int v = i >> 1, r = i & 1;
    const float* xs = &s_x[c][v + r + 3 - u0];
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) acc += h[11 - 2 * q - r] * xs[q];
    const float y = 2.f * acc;
    const float sn = sinf(s_a[c] * y);
    s_s[c][m] = y + s_ib[c] * (sn * sn);
  }
  __syncthreads();

  // z[u0 + u] = sum_j h[j] * s[2(u0 + u) + j - 5]
  for (int idx = tid; idx < CG * TT; idx += NT) {
    const int c = idx / TT, u = idx - c * TT;
    const int g = u0 + u, cc = c0 + c;
    if (g >= T || cc >= C) continue;
    const float* ss = &s_s[c][2 * u + 1];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 12; ++j) acc += h[j] * ss[j];
    zb[(size_t)cc * T + g] = acc;
  }
}

}  // namespace

// x, z (B, C, T) f32 contiguous; alpha, beta (C,) log-scale SnakeBeta
// parameters; taps the 12-tap filter.
extern "C" int alias_free_snake_f32(const void* x, const void* alpha, const void* beta,
                                    const void* taps, void* z, int B, int T, int C,
                                    void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TT - 1) / TT, (C + CG - 1) / CG, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  alias_free_snake_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(alpha),
      static_cast<const float*>(beta), static_cast<const float*>(taps), static_cast<float*>(z),
      T, C);
  return (int)cudaGetLastError();
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

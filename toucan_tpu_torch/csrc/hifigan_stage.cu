// One HiFiGAN residual stage, fused into one launch, f32.
//
// Replaces toucan_tpu/kernels/pallas_resstack.py::fused_folded_resstacks
// (the Pallas kernel _resstack_kernel).  On x (B, T, C) it computes, for
// each of the three stacks s with kernel size k_s:
//
//   for d in (d0, d1, d2):
//     x_s = x_s + conv(k_s, 1)(lrelu(conv(k_s, d)(lrelu(x_s))))
//
// starting from x_s = x, and returns (x_0 + x_1 + x_2) / 3.  Every conv
// zero-pads its own input at the sequence edges: rows outside [0, T) are
// zero after every conv, as in _resstack_kernel.
//
// What bounds it on the H100: operations.  A stage does 2 * 18 convs'
// k * C * C multiply-adds per sample, 252 * T * C^2 flops in all (1.29
// TFLOP per vocoder call at 2048 mel frames), against a few hundred MB of
// activations.  This first version runs on the CUDA cores in f32, so its
// roof is the 67 TFLOP/s f32 rate.
//
// Design: a persistent grid; each block takes time tiles of `tile` output
// rows in turn and recomputes a halo of 60 rows per side (the receptive
// field of the k = 11 stack), so blocks never wait on each other.  The
// residual stream and the conv output of a tile, (tile + 120) x C each, do
// not fit in shared memory at C = 256 or 128, so each block keeps them in a
// private slice of a global scratch buffer that the wrapper allocates; it
// stays in L2 while the block works on it.  A conv is computed in output
// tiles of RT rows x COT channels, 4 x 4 per thread, walking 16 input
// channels at a time: the input rows the taps need (leaky ReLU applied as
// they are staged) and the taps' weights go to shared memory, and each
// thread does 16 FMAs per pair of 4-wide reads.  The valid region of the
// tile shrinks by each conv's padding, so every conv computes only the rows
// that later convs read.  Weights come packed once per load as
// (conv, tap, C_in, C_out); biases as (conv, C_out).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int CK = 16;        // input channels staged per step
constexpr int CKP = CK + 1;   // padded row of staged input (bank conflicts)
constexpr int N_STACKS = 3;
constexpr int N_ROUNDS = 3;

__host__ __device__ inline int stack_halo(int k, const int* dil) {
  int h = 0;
  for (int r = 0; r < N_ROUNDS; ++r) h += (k - 1) / 2 * (dil[r] + 1);
  return h;
}

// One conv over local rows [lo, hi) of a tile: dst = conv(lrelu(src)) + bias,
// or dst += ... when accumulate.  Row l of the tile is global row g0 + l.
// src and dst point into scratch that this block also writes, so they are
// read through the coherent path (no __restrict__ / __ldg).
template <int COT>
__device__ void conv_pass(const float* src, float* dst, bool accumulate,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          int C, int k, int d, int lo, int hi, int W, int g0, int T,
                          float slope, float* s_in, float* s_w) {
  constexpr int RT = 4096 / COT;  // output rows per tile
  constexpr int TXN = COT / 4;    // threads along channels
  constexpr int TYN = RT / 4;     // threads along rows
  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int pad = d * (k - 1) / 2;
  const int span = RT + (k - 1) * d;

  for (int r0 = lo; r0 < hi; r0 += RT) {
    for (int c0 = 0; c0 < C; c0 += COT) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;

      for (int ci0 = 0; ci0 < C; ci0 += CK) {
        __syncthreads();  // earlier readers of s_in/s_w and writers of src are done
        for (int idx = tid; idx < span * CK; idx += NT) {
          const int rr = idx / CK, cc = idx - rr * CK;
          const int l = r0 - pad + rr;
          float val = 0.f;
          if (l >= 0 && l < W) {
            val = src[(size_t)l * C + ci0 + cc];
            val = val >= 0.f ? val : slope * val;
          }
          s_in[rr * CKP + cc] = val;
        }
        for (int idx = tid; idx < k * CK * COT; idx += NT) {
          const int co = idx % COT;
          const int rest = idx / COT;
          const int ci = rest % CK;
          const int tap = rest / CK;
          s_w[idx] = w[((size_t)tap * C + ci0 + ci) * C + c0 + co];
        }
        __syncthreads();
        for (int tap = 0; tap < k; ++tap) {
          const float* in_t = s_in + tap * d * CKP;
          const float* w_t = s_w + tap * CK * COT;
#pragma unroll
          for (int ci = 0; ci < CK; ++ci) {
            float av[4], wv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a] = in_t[(ty + TYN * a) * CKP + ci];
#pragma unroll
            for (int q = 0; q < 4; ++q) wv[q] = w_t[ci * COT + tx + TXN * q];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(av[a], wv[q], acc[a][q]);
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int l = r0 + ty + TYN * a;
        if (l < hi) {
          const int g = g0 + l;
          const bool in_seq = g >= 0 && g < T;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int co = c0 + tx + TXN * q;
            const float val = in_seq ? acc[a][q] + bias[co] : 0.f;
            float* o = dst + (size_t)l * C + co;
            *o = accumulate ? *o + val : val;
          }
        }
      }
    }
  }
}

struct StageArgs {
  int B, T, C, tile, halo;
  int ks[N_STACKS];
  int dil[N_ROUNDS];
  float slope;
};

template <int COT>
__global__ void __launch_bounds__(NT) stage_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* out, float* scratch, StageArgs args) {
  extern __shared__ float smem[];
  const int C = args.C, T = args.T, tile = args.tile, halo = args.halo;
  const int W = tile + 2 * halo;
  const int max_span = 4096 / COT + (args.ks[N_STACKS - 1] - 1) * args.dil[N_ROUNDS - 1];
  float* s_in = smem;
  float* s_w = smem + max_span * CKP;
  float* xres = scratch + (size_t)blockIdx.x * 2 * W * C;
  float* tmp = xres + (size_t)W * C;
  const int tiles_t = (T + tile - 1) / tile;

  for (int job = blockIdx.x; job < args.B * tiles_t; job += gridDim.x) {
    const int b = job / tiles_t;
    const int t0 = (job - b * tiles_t) * tile;
    const int g0 = t0 - halo;
    const int n_out = min(tile, T - t0);
    const float* xb = x + (size_t)b * T * C;
    float* ob = out + (size_t)b * T * C;
    size_t w_off = 0;
    int conv = 0;
    for (int s = 0; s < N_STACKS; ++s) {
      const int k = args.ks[s];
      const int hs = stack_halo(k, args.dil);
      int lo = halo - hs, hi = halo + n_out + hs;
      __syncthreads();  // the previous stack's readers of xres are done
      for (int idx = threadIdx.x; idx < (hi - lo) * C; idx += NT) {
        const int l = lo + idx / C, c = idx % C;
        const int g = g0 + l;
        xres[(size_t)l * C + c] = (g >= 0 && g < T) ? xb[(size_t)g * C + c] : 0.f;
      }
      for (int r = 0; r < N_ROUNDS; ++r) {
        const int d = args.dil[r];
        lo += d * (k - 1) / 2;
        hi -= d * (k - 1) / 2;
        conv_pass<COT>(xres, tmp, false, w + w_off, bias + (size_t)conv * C, C, k, d,
                       lo, hi, W, g0, T, args.slope, s_in, s_w);
        w_off += (size_t)k * C * C;
        ++conv;
        lo += (k - 1) / 2;
        hi -= (k - 1) / 2;
        conv_pass<COT>(tmp, xres, true, w + w_off, bias + (size_t)conv * C, C, k, 1,
                       lo, hi, W, g0, T, args.slope, s_in, s_w);
        w_off += (size_t)k * C * C;
        ++conv;
      }
      __syncthreads();  // xres rows [halo, halo + n_out) are final for this stack
      for (int idx = threadIdx.x; idx < n_out * C; idx += NT) {
        const int r = idx / C, c = idx % C;
        const float v = xres[(size_t)(halo + r) * C + c];
        float* o = ob + (size_t)(t0 + r) * C + c;
        if (s == 0) *o = v;
        else if (s < N_STACKS - 1) *o += v;
        else *o = (*o + v) / (float)N_STACKS;
      }
    }
  }
}

template <int COT>
cudaError_t launch(const float* x, const float* w, const float* bias, float* out,
                   float* scratch, const StageArgs& args, int grid, cudaStream_t stream) {
  const int max_span = 4096 / COT + (args.ks[N_STACKS - 1] - 1) * args.dil[N_ROUNDS - 1];
  const size_t smem = ((size_t)max_span * CKP + (size_t)args.ks[N_STACKS - 1] * CK * COT)
                      * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<COT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  stage_kernel<COT><<<grid, NT, smem, stream>>>(x, w, bias, out, scratch, args);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, T, C); w packed (18 convs, k, C, C) in stack-major order with
// the dilated conv of each round before its k-wide dilation-1 conv; bias
// (18, C); scratch grid * 2 * (tile + 2 * halo) * C floats.  Kernel sizes
// and dilations must be ascending (the last of each is the widest).
extern "C" int hifigan_stage_f32(const void* x, const void* w, const void* bias, void* out,
                                 void* scratch, int B, int T, int C, int k0, int k1, int k2,
                                 int d0, int d1, int d2, int tile, int halo, int grid,
                                 float slope, void* stream) {
  StageArgs args{B, T, C, tile, halo, {k0, k1, k2}, {d0, d1, d2}, slope};
  if (B <= 0 || T <= 0 || tile <= 0 || grid <= 0 || C % 32 != 0 ||
      !(k0 <= k1 && k1 <= k2) || !(d0 <= d1 && d1 <= d2) ||
      halo < stack_halo(k2, args.dil))
    return (int)cudaErrorInvalidValue;
  const auto* xx = static_cast<const float*>(x);
  const auto* ww = static_cast<const float*>(w);
  const auto* bb = static_cast<const float*>(bias);
  auto* oo = static_cast<float*>(out);
  auto* ss = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (C % 64 == 0) return (int)launch<64>(xx, ww, bb, oo, ss, args, grid, st);
  return (int)launch<32>(xx, ww, bb, oo, ss, args, grid, st);
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

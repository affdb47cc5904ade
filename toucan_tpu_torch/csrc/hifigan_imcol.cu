// One HiFiGAN residual stage in the im2col kernel's int8 or bf16 mode.
//
// Replaces toucan_tpu/kernels/pallas_imcol.py::fused_imcol_resstacks (the
// Pallas kernel _stage_kernel) in its int8 and bf16 modes.  In samples, with
// the stage's time fold f, the stage (B, T, C) is cut into windows of
// n_s = (tile + 2 halo) f samples that start every step = tile f samples, the
// first at -left = -halo f; samples outside [0, T) are zero.  In each window,
// for each of the three stacks s with kernel size k_s, starting from the f32
// stream xb = x:
//
//   for d in (d0, d1, d2):
//     xt = mask(conv(k_s, d)(quant(lrelu(xb))) * (s * (a1 / 127)) + b1)
//     xb = xb + mask(conv(k_s, 1)(quant(lrelu(xt))) * (s * (a2 / 127)) + b2)
//
// where each conv is a *circular* SAME dilated conv over the window (the
// Pallas kernel rolls the window to build its taps), mask zeroes rows outside
// [0, T), and the central step rows of the three streams are averaged.
// int8: quant(v) = clip(rint(v * (127 / a)), 127) with a = max(max|v|, 1e-6)
// over every row and channel of the window (a dynamic scale per conv and
// window), int8 weights with per-output-channel scales s, exact int32 sums
// (__dp4a).  bf16: quant is a bf16 rounding, s = 1 and a / 127 = 1, f32 sums.
// The rows the wrap fills with garbage stay in the halo, but in int8 they
// enter the next conv's a, so every row of the window is computed and the
// window geometry is JAX's.  IEEE arithmetic in JAX's order: __fdiv_rn for
// 127 / a, a / 127 and / 3, __fmul_rn / __fadd_rn so that no FMA contraction
// moves a value across a rounding boundary.
//
// What bounds it on the H100: operations.  A stage does 252 * T * C^2
// integer (or bf16) operations of least work against T * C * 8 bytes of f32
// in and out; at the published dense int8 rate of 1979 TOP/s and 3.35 TB/s
// the operations are the larger bound.  This first version runs on the CUDA
// cores (__dp4a for int8, f32 FMA on bf16 values for bf16) and recomputes
// the halo rows (9-25 % more), so its real roof is far below the tensor
// cores'.
//
// Design: a persistent grid, one window per block at a time (48 to 96
// windows per stage at 512 mel frames).  The window's quantized operand,
// n_s x C int8 or bf16 (70-80 KB in int8 at the three stage shapes), lives
// in shared memory with a circular margin of (k - 1) / 2 * d rows copied on
// each side, so a tap's rows are read without a modulo.  The two f32
// streams xb and xt (n_s x C each) stay in a per-block slice of a global
// scratch buffer (L2-resident), as in K2 and K3.  Per conv: quantize the
// input into shared memory, copy the margins, then K3's register-tiled conv
// over all rows with weights staged 8 words of input channels at a time;
// the epilogue dequantizes, adds the bias, masks, writes the stream and
// keeps the running max of the next conv's |lrelu(input)|, reduced over the
// block for the next scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;  // threads per block
constexpr int KW = 8;    // 32-bit words of input channels staged per step
constexpr int N_STACKS = 3;
constexpr int N_ROUNDS = 3;

struct Int8Mode {
  using Acc = int;
  static constexpr int EPW = 4;  // elements per 32-bit word
  static __device__ inline int mac(uint32_t a, uint32_t b, int acc) {
    return __dp4a((int)a, (int)b, acc);
  }
  static __device__ inline float to_float(int acc) { return __int2float_rn(acc); }
};

struct Bf16Mode {
  using Acc = float;
  static constexpr int EPW = 2;
  static __device__ inline float mac(uint32_t a, uint32_t b, float acc) {
    // a bf16 is the high half of an f32: the products are exact in f32
    acc = __fmaf_rn(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
    return __fmaf_rn(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u), acc);
  }
  static __device__ inline float to_float(float acc) { return acc; }
};

__device__ inline float lrelu(float v, float slope) { return fmaxf(v, __fmul_rn(slope, v)); }

__device__ inline int8_t quant_i8(float v) {
  return (int8_t)__float2int_rn(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

// Stores element (l, c) of the operand (rows of wpr 32-bit words), quantized
// for the mode (int8: v is already scaled by 127 / a).
template <class M>
__device__ inline void put(uint32_t* op, int wpr, int l, int c, float v) {
  if constexpr (M::EPW == 4)
    reinterpret_cast<int8_t*>(op + (size_t)l * wpr)[c] = quant_i8(v);
  else
    reinterpret_cast<uint16_t*>(op + (size_t)l * wpr)[c] =
        __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The max of v over the block, returned to every thread.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // earlier readers of red are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < NT / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// One conv over all n rows of the window: reads the operand src (row 0 at
// src, rows [-pad, n + pad) readable), weights w packed (tap, C / EPW, C)
// words; calls epi(l, co, sum) for every row l and channel co.
template <class M, int COT, class Epi>
__device__ void conv_pass(const uint32_t* src, int wpr, const uint32_t* __restrict__ w,
                          int C, int k, int d, int n, uint32_t* s_w, Epi epi) {
  constexpr int RT = NT * 16 / COT;  // output rows per register tile
  constexpr int TXN = COT / 4;       // threads along channels
  constexpr int TYN = RT / 4;        // threads along rows
  using Acc = typename M::Acc;
  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int pad = d * (k - 1) / 2;
  const int cw_total = C / M::EPW;

  for (int r0 = 0; r0 < n; r0 += RT) {
    int row[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) row[a] = min(r0 + ty + TYN * a, n - 1) - pad;
    for (int c0 = 0; c0 < C; c0 += COT) {
      Acc acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0;

      for (int cw0 = 0; cw0 < cw_total; cw0 += KW) {
        __syncthreads();  // earlier readers of s_w and writers of src are done
        for (int idx = tid; idx < k * KW * COT; idx += NT) {
          const int co = idx % COT;
          const int rest = idx / COT;
          const int cw = rest % KW;
          const int tap = rest / KW;
          s_w[idx] = w[((size_t)tap * cw_total + cw0 + cw) * C + c0 + co];
        }
        __syncthreads();
        for (int tap = 0; tap < k; ++tap) {
          const uint32_t* w_t = s_w + tap * KW * COT;
          const uint32_t* in_t = src + cw0 + tap * d * wpr;
#pragma unroll
          for (int cw = 0; cw < KW; ++cw) {
            uint32_t av[4], wv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) av[a] = in_t[row[a] * wpr + cw];
#pragma unroll
            for (int q = 0; q < 4; ++q) wv[q] = w_t[cw * COT + tx + TXN * q];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[a][q] = M::mac(av[a], wv[q], acc[a][q]);
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int l = r0 + ty + TYN * a;
        if (l < n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) epi(l, c0 + tx + TXN * q, M::to_float(acc[a][q]));
        }
      }
    }
  }
}

struct ImcolArgs {
  int B, T, C, step, left, margin;
  int ks[N_STACKS];
  int dil[N_ROUNDS];
  float slope;
};

template <class M, int COT>
__global__ void __launch_bounds__(NT) imcol_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ w,
    const float* __restrict__ wscale, const float* __restrict__ bias, float* out,
    float* scratch, ImcolArgs args) {
  extern __shared__ uint32_t smem[];
  constexpr bool INT8 = M::EPW == 4;
  const int C = args.C, T = args.T, step = args.step, left = args.left;
  const int n_s = step + 2 * left, margin = args.margin;
  const float slope = args.slope;
  const int wpr = C / M::EPW + 1;  // words per operand row, padded by one
  uint32_t* op = smem + (size_t)margin * wpr;  // row 0 of the window
  uint32_t* s_w = smem + (size_t)(n_s + 2 * margin) * wpr;
  float* red = reinterpret_cast<float*>(s_w + args.ks[N_STACKS - 1] * KW * COT);
  float* xb = scratch + (size_t)blockIdx.x * 2 * n_s * C;
  float* xt = xb + (size_t)n_s * C;
  const int n_win = (T + step - 1) / step;

  for (int job = blockIdx.x; job < args.B * n_win; job += gridDim.x) {
    const int b = job / n_win;
    const int g0 = (job - b * n_win) * step - left;  // sample of window row 0
    const float* xbat = x + (size_t)b * T * C;
    float* obat = out + (size_t)b * T * C;
    // int8: the scale of each stack's first conv, max|lrelu(x)| over the window
    float a0 = 0.f;
    if (INT8) {
      float m = 0.f;
      for (int idx = threadIdx.x; idx < n_s * C; idx += NT) {
        const int g = g0 + idx / C;
        if (g >= 0 && g < T) m = fmaxf(m, fabsf(lrelu(xbat[(size_t)g * C + idx % C], slope)));
      }
      a0 = block_max(m, red);
    }
    size_t w_off = 0;
    int conv = 0;
    for (int s = 0; s < N_STACKS; ++s) {
      const int k = args.ks[s];
      __syncthreads();  // the previous stack's readers of xb are done
      for (int idx = threadIdx.x; idx < n_s * C; idx += NT) {
        const int g = g0 + idx / C;
        xb[idx] = (g >= 0 && g < T) ? xbat[(size_t)g * C + idx % C] : 0.f;
      }
      float a = a0;  // max|lrelu| of the next conv's input
      for (int r = 0; r < N_ROUNDS; ++r) {
        for (int half = 0; half < 2; ++half) {
          const int d = half == 0 ? args.dil[r] : 1;
          const float* src = half == 0 ? xb : xt;
          a = fmaxf(a, 1e-6f);
          const float qs = INT8 ? __fdiv_rn(127.f, a) : 1.f;
          const float aq = __fdiv_rn(a, 127.f);
          __syncthreads();  // src is written; the previous conv's readers of op are done
          for (int idx = threadIdx.x; idx < n_s * C; idx += NT) {
            float v = lrelu(src[idx], slope);
            if (INT8) v = __fmul_rn(v, qs);
            put<M>(op, wpr, idx / C, idx % C, v);
          }
          __syncthreads();
          // circular margins: rows [-margin, 0) <- [n_s - margin, n_s), [n_s, n_s + margin) <- [0, margin)
          for (int idx = threadIdx.x; idx < margin * wpr; idx += NT) {
            op[idx - margin * wpr] = op[(size_t)(n_s - margin) * wpr + idx];
            op[(size_t)n_s * wpr + idx] = op[idx];
          }
          const float* sc = wscale + (size_t)conv * C;
          const float* bi = bias + (size_t)conv * C;
          float m = 0.f;
          // conv_pass synchronizes before its first read of op
          if (half == 0) {
            conv_pass<M, COT>(op, wpr, w + w_off, C, k, d, n_s, s_w,
                              [&](int l, int co, float sum) {
                                const int g = g0 + l;
                                float v = 0.f;
                                if (g >= 0 && g < T)
                                  v = INT8 ? __fadd_rn(__fmul_rn(sum, __fmul_rn(sc[co], aq)), bi[co])
                                           : __fadd_rn(sum, bi[co]);
                                xt[(size_t)l * C + co] = v;
                                m = fmaxf(m, fabsf(lrelu(v, slope)));
                              });
          } else {
            conv_pass<M, COT>(op, wpr, w + w_off, C, k, d, n_s, s_w,
                              [&](int l, int co, float sum) {
                                const int g = g0 + l;
                                float v = 0.f;
                                if (g >= 0 && g < T)
                                  v = INT8 ? __fadd_rn(__fmul_rn(sum, __fmul_rn(sc[co], aq)), bi[co])
                                           : __fadd_rn(sum, bi[co]);
                                float* p = xb + (size_t)l * C + co;
                                const float nv = __fadd_rn(*p, v);
                                *p = nv;
                                m = fmaxf(m, fabsf(lrelu(nv, slope)));
                              });
          }
          if (INT8) a = block_max(m, red);
          w_off += (size_t)k * C * C / M::EPW;
          ++conv;
        }
      }
      __syncthreads();  // xb is final for this stack
      for (int idx = threadIdx.x; idx < step * C; idx += NT) {
        const int r = idx / C, c = idx % C;
        const int g = g0 + left + r;
        if (g >= T) continue;
        const float v = xb[(size_t)(left + r) * C + c];
        float* o = obat + (size_t)g * C + c;
        if (s == 0) *o = v;
        else if (s < N_STACKS - 1) *o = __fadd_rn(*o, v);
        else *o = __fdiv_rn(__fadd_rn(*o, v), (float)N_STACKS);
      }
    }
  }
}

template <class M, int COT>
cudaError_t launch(const float* x, const uint32_t* w, const float* wscale, const float* bias,
                   float* out, float* scratch, const ImcolArgs& args, int grid, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(imcol_kernel<M, COT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  imcol_kernel<M, COT><<<grid, NT, smem, stream>>>(x, w, wscale, bias, out, scratch, args);
  return cudaGetLastError();
}

template <class M>
cudaError_t launch_mode(const float* x, const uint32_t* w, const float* wscale,
                        const float* bias, float* out, float* scratch, const ImcolArgs& args,
                        int grid, int smem, cudaStream_t stream) {
  if (args.C % 64 == 0)
    return launch<M, 64>(x, w, wscale, bias, out, scratch, args, grid, smem, stream);
  return launch<M, 32>(x, w, wscale, bias, out, scratch, args, grid, smem, stream);
}

}  // namespace

// mode 0 = int8, 1 = bf16.  x, out (B, T, C) f32 with C in {32, 64, 128}; w
// the packed weights of the 18 convs (stack-major, the dilated conv of each
// round before its plain conv), (conv, tap, C/EPW, C, EPW) with EPW = 4 int8
// or 2 bf16 input channels per 32-bit word; wscale, bias (18, C) f32; step
// and left the window's output samples and left margin (tile * fold, halo *
// fold); margin the circular margin in rows, at least (k2 - 1) / 2 * d2;
// scratch grid * 2 * (step + 2 left) * C f32; smem the dynamic shared memory
// (see kernels/imcol.py).  Kernel sizes and dilations must be ascending.
extern "C" int hifigan_imcol(int mode, const void* x, const void* w, const void* wscale,
                             const void* bias, void* out, void* scratch, int B, int T, int C,
                             int k0, int k1, int k2, int d0, int d1, int d2, int step, int left,
                             int margin, int grid, int smem, float slope, void* stream) {
  ImcolArgs args{B, T, C, step, left, margin, {k0, k1, k2}, {d0, d1, d2}, slope};
  const int epw = mode == 0 ? 4 : 2;
  const int cot = C % 64 == 0 ? 64 : 32;
  const int n_s = step + 2 * left;
  const long need = 4L * ((long)(n_s + 2 * margin) * (C / epw + 1) + (long)k2 * KW * cot + NT / 32);
  if ((mode != 0 && mode != 1) || B <= 0 || T <= 0 || step <= 0 || left < 0 || grid <= 0 ||
      (C != 32 && C != 64 && C != 128) || !(k0 <= k1 && k1 <= k2) || !(d0 <= d1 && d1 <= d2) ||
      margin < (k2 - 1) / 2 * d2 || margin > n_s || smem < need)
    return (int)cudaErrorInvalidValue;
  const auto* xx = static_cast<const float*>(x);
  const auto* ww = static_cast<const uint32_t*>(w);
  const auto* sc = static_cast<const float*>(wscale);
  const auto* bb = static_cast<const float*>(bias);
  auto* oo = static_cast<float*>(out);
  auto* ss = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return (int)launch_mode<Int8Mode>(xx, ww, sc, bb, oo, ss, args, grid, smem, st);
  return (int)launch_mode<Bf16Mode>(xx, ww, sc, bb, oo, ss, args, grid, smem, st);
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

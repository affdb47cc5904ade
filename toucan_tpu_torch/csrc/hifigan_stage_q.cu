// One HiFiGAN residual stage in int8 or bf16, fused into one launch.
//
// Replaces toucan_tpu/kernels/pallas_stage.py::fused_stage_resstacks (the
// Pallas kernel _stage_kernel) in its int8 and bf16 modes.  On x (B, T, C),
// for each of the three stacks s with kernel size k_s, starting from the
// bf16 residual stream r = bf16(x):
//
//   for d in (d0, d1, d2):
//     q   = quant(lrelu(r))                      int8: clip(rint(v * 127/a1), 127)
//     m   = lrelu(conv(k_s, d)(q) * deq1 + b1')  bf16: bf16(v), deq = 1
//     r   = bf16(r + conv(k_s, 1)(quant2(m)) * deq2 + b2)
//
// and returns the f32 mean of the three streams.  int8: weights are int8
// with per-output-channel scales, sums are exact int32 (__dp4a), and
// deq1 = cs1 * a1/127 * 127/a2 and b1' = b1 * 127/a2 fold the dequant of the
// dilated conv and the requant of the next conv's input into one chain;
// rounding is half to even and the clip symmetric (+-127, never -128).
// bf16: bf16 operands and mid values, f32 sums.  The chain uses __fmul_rn /
// __fadd_rn so no FMA contraction can move a value across a rounding
// boundary.  Every conv zero-pads its input at the sequence edges: rows
// outside [0, T) of each quantized operand and of each residual update are
// zero, as in _stage_kernel.
//
// What bounds it on the H100: operations.  A stage does 252 * T * C^2
// integer (or bf16) operations against T * C * 8 bytes of f32 in and out;
// at the published dense int8 rate of 1979 TOP/s and 3.35 TB/s the
// operations are the larger bound for C >= 32.  This first version runs on
// the CUDA cores (__dp4a for int8, f32 FMA on bf16 values for bf16), so its
// real roof is far below the tensor cores'.
//
// Design: K2's (csrc/hifigan_stage.cu) persistent grid, time tiles and
// recomputed halo of 60 rows per side, with one change: both quantized conv
// operands of a tile, (tile + 120) x C int8 or bf16 each, live in shared
// memory (as int8 a (256 + 120) x 256 tile is 96 KB), so a conv reads its
// taps' rows straight from shared memory and only the weights are staged,
// 8 words of input channels at a time.  The bf16 residual stream stays in a
// per-block slice of a global scratch buffer (L2-resident), as in K2.  A
// conv is computed in output tiles of RT rows x COT channels, 4 x 4 per
// thread.  Operand rows are padded by one 32-bit word so the rows a warp
// reads fall in different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int KW = 8;    // 32-bit words of input channels staged per step
constexpr int N_STACKS = 3;
constexpr int N_ROUNDS = 3;

__host__ __device__ inline int stack_halo(int k, const int* dil) {
  int h = 0;
  for (int r = 0; r < N_ROUNDS; ++r) h += (k - 1) / 2 * (dil[r] + 1);
  return h;
}

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

__device__ inline uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ inline float bf16_value(uint16_t bits) {
  return __uint_as_float((uint32_t)bits << 16);
}

// Stores element (l, c) of an operand tile of wpr 32-bit words per row,
// quantized for the mode.
template <class M>
__device__ inline void put(uint32_t* tile, int wpr, int l, int c, float v) {
  if constexpr (M::EPW == 4)
    reinterpret_cast<int8_t*>(tile + (size_t)l * wpr)[c] = quant_i8(v);
  else
    reinterpret_cast<uint16_t*>(tile + (size_t)l * wpr)[c] = bf16_bits(v);
}

// One conv over local rows [lo, hi): reads the operand tile src (rows of
// wpr words), weights w packed (tap, C / EPW, C) words; calls epi(l, co, sum)
// for every output row l in [lo, hi) and channel co.
template <class M, int COT, class Epi>
__device__ void conv_pass(const uint32_t* src, int wpr, const uint32_t* __restrict__ w,
                          int C, int k, int d, int lo, int hi, uint32_t* s_w, Epi epi) {
  constexpr int RT = 4096 / COT;  // output rows per register tile
  constexpr int TXN = COT / 4;    // threads along channels
  constexpr int TYN = RT / 4;     // threads along rows
  using Acc = typename M::Acc;
  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int pad = d * (k - 1) / 2;
  const int cw_total = C / M::EPW;

  for (int r0 = lo; r0 < hi; r0 += RT) {
    int row[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) row[a] = min(r0 + ty + TYN * a, hi - 1) - pad;
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
        if (l < hi) {
#pragma unroll
          for (int q = 0; q < 4; ++q) epi(l, c0 + tx + TXN * q, M::to_float(acc[a][q]));
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

template <class M, int COT>
__global__ void __launch_bounds__(NT) stage_q_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ w,
    const float* __restrict__ qin, const float* __restrict__ deq,
    const float* __restrict__ bias, float* out, uint16_t* scratch, StageArgs args) {
  extern __shared__ uint32_t smem[];
  constexpr bool INT8 = M::EPW == 4;
  const int C = args.C, T = args.T, tile = args.tile, halo = args.halo;
  const float slope = args.slope;
  const int W = tile + 2 * halo;
  const int wpr = C / M::EPW + 1;  // words per operand row, padded by one
  uint32_t* q_in = smem;
  uint32_t* q_mid = q_in + (size_t)W * wpr;
  uint32_t* s_w = q_mid + (size_t)W * wpr;
  uint16_t* res = scratch + (size_t)blockIdx.x * W * C;
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
      __syncthreads();  // the previous stack's readers of res are done
      for (int idx = threadIdx.x; idx < (hi - lo) * C; idx += NT) {
        const int l = lo + idx / C, c = idx % C;
        const int g = g0 + l;
        res[(size_t)l * C + c] = bf16_bits((g >= 0 && g < T) ? xb[(size_t)g * C + c] : 0.f);
      }
      for (int r = 0; r < N_ROUNDS; ++r) {
        const int d = args.dil[r];
        const float qs = qin[conv];
        __syncthreads();  // res rows [lo, hi) are written; q_in's readers are done
        for (int idx = threadIdx.x; idx < (hi - lo) * C; idx += NT) {
          const int l = lo + idx / C, c = idx % C;
          const int g = g0 + l;
          float v = 0.f;
          if (g >= 0 && g < T) {
            v = lrelu(bf16_value(res[(size_t)l * C + c]), slope);
            if (INT8) v = __fmul_rn(v, qs);
          }
          put<M>(q_in, wpr, l, c, v);
        }
        // dilated conv -> lrelu -> requantized operand of the next conv
        const float* deq1 = deq + (size_t)conv * C;
        const float* b1 = bias + (size_t)conv * C;
        const int lo1 = lo + d * (k - 1) / 2, hi1 = hi - d * (k - 1) / 2;
        conv_pass<M, COT>(q_in, wpr, w + w_off, C, k, d, lo1, hi1, s_w,
                          [&](int l, int co, float sum) {
                            const int g = g0 + l;
                            float v = 0.f;
                            if (g >= 0 && g < T) {
                              v = INT8 ? __fadd_rn(__fmul_rn(sum, deq1[co]), b1[co])
                                       : __fadd_rn(sum, b1[co]);
                              v = lrelu(v, slope);
                            }
                            put<M>(q_mid, wpr, l, co, v);
                          });
        w_off += (size_t)k * C * C / M::EPW;
        ++conv;
        // plain conv -> dequant -> residual update in bf16
        const float* deq2 = deq + (size_t)conv * C;
        const float* b2 = bias + (size_t)conv * C;
        lo = lo1 + (k - 1) / 2;
        hi = hi1 - (k - 1) / 2;
        conv_pass<M, COT>(q_mid, wpr, w + w_off, C, k, 1, lo, hi, s_w,
                          [&](int l, int co, float sum) {
                            const int g = g0 + l;
                            uint16_t* rp = res + (size_t)l * C + co;
                            float upd = 0.f;
                            if (g >= 0 && g < T)
                              upd = INT8 ? __fadd_rn(__fmul_rn(sum, deq2[co]), b2[co])
                                         : __fadd_rn(sum, b2[co]);
                            *rp = bf16_bits(__fadd_rn(bf16_value(*rp), upd));
                          });
        w_off += (size_t)k * C * C / M::EPW;
        ++conv;
      }
      __syncthreads();  // res rows [halo, halo + n_out) are final for this stack
      for (int idx = threadIdx.x; idx < n_out * C; idx += NT) {
        const int r = idx / C, c = idx % C;
        const float v = bf16_value(res[(size_t)(halo + r) * C + c]);
        float* o = ob + (size_t)(t0 + r) * C + c;
        if (s == 0) *o = v;
        else if (s < N_STACKS - 1) *o = __fadd_rn(*o, v);
        else *o = __fdiv_rn(__fadd_rn(*o, v), (float)N_STACKS);
      }
    }
  }
}

template <class M, int COT>
cudaError_t launch(const float* x, const uint32_t* w, const float* qin, const float* deq,
                   const float* bias, float* out, uint16_t* scratch, const StageArgs& args,
                   int grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stage_q_kernel<M, COT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stage_q_kernel<M, COT><<<grid, NT, smem, stream>>>(x, w, qin, deq, bias, out, scratch, args);
  return cudaGetLastError();
}

template <class M>
cudaError_t launch_mode(const float* x, const uint32_t* w, const float* qin, const float* deq,
                        const float* bias, float* out, uint16_t* scratch,
                        const StageArgs& args, int grid, int smem, cudaStream_t stream) {
  if (args.C % 64 == 0)
    return launch<M, 64>(x, w, qin, deq, bias, out, scratch, args, grid, smem, stream);
  return launch<M, 32>(x, w, qin, deq, bias, out, scratch, args, grid, smem, stream);
}

}  // namespace

// mode 0 = int8, 1 = bf16.  x, out (B, T, C) f32; w the packed weights of
// the 18 convs (stack-major, the dilated conv of each round before its
// plain conv), (conv, tap, C/EPW, C, EPW) with EPW = 4 int8 or 2 bf16 input
// channels per 32-bit word; qin (18)
// the input scale of each dilated conv (int8); deq, bias (18, C) f32;
// scratch grid * (tile + 2 * halo) * C bf16; smem the dynamic shared memory
// (two operand tiles and one weight step, see kernels/stage.py).  Kernel
// sizes and dilations must be ascending (the last of each is the widest).
extern "C" int hifigan_stage_q(int mode, const void* x, const void* w, const void* qin,
                               const void* deq, const void* bias, void* out, void* scratch,
                               int B, int T, int C, int k0, int k1, int k2, int d0, int d1,
                               int d2, int tile, int halo, int grid, int smem, float slope,
                               void* stream) {
  StageArgs args{B, T, C, tile, halo, {k0, k1, k2}, {d0, d1, d2}, slope};
  const int epw = mode == 0 ? 4 : 2;
  const int cot = C % 64 == 0 ? 64 : 32;
  const long need = 4L * (2L * (tile + 2 * halo) * (C / epw + 1) + (long)k2 * KW * cot);
  if ((mode != 0 && mode != 1) || B <= 0 || T <= 0 || tile <= 0 || grid <= 0 ||
      C % 32 != 0 || !(k0 <= k1 && k1 <= k2) || !(d0 <= d1 && d1 <= d2) ||
      halo < stack_halo(k2, args.dil) || smem < need)
    return (int)cudaErrorInvalidValue;
  const auto* xx = static_cast<const float*>(x);
  const auto* ww = static_cast<const uint32_t*>(w);
  const auto* qq = static_cast<const float*>(qin);
  const auto* dd = static_cast<const float*>(deq);
  const auto* bb = static_cast<const float*>(bias);
  auto* oo = static_cast<float*>(out);
  auto* ss = static_cast<uint16_t*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return (int)launch_mode<Int8Mode>(xx, ww, qq, dd, bb, oo, ss, args, grid, smem, st);
  return (int)launch_mode<Bf16Mode>(xx, ww, qq, dd, bb, oo, ss, args, grid, smem, st);
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

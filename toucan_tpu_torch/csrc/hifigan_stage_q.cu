// One HiFiGAN residual stage in int8 or bf16, fused into one launch, on the
// tensor cores.
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
// with per-output-channel scales, sums are exact int32, and
// deq1 = cs1 * a1/127 * 127/a2 and b1' = b1 * 127/a2 fold the dequant of the
// dilated conv and the requant of the next conv's input into one chain;
// rounding is half to even and the clip symmetric (+-127, never -128).
// bf16: bf16 operands and mid values, f32 sums.  The chain uses __fmul_rn /
// __fadd_rn so no FMA contraction can move a value across a rounding
// boundary.  Every conv zero-pads its input at the sequence edges: rows
// outside [0, T) of each quantized operand and of each residual update are
// zero, as in _stage_kernel.
//
// The products: mma.sync.m16n8k32 s8 x s8 -> s32 (int8) and
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (bf16).  A 32-bit word holds 4 int8
// or 2 bf16 consecutive input channels, and in both modes one K-step of 8
// words is one mma's depth with the same word layout in the fragments, so
// the two modes share every load and differ only in the mma.
//
// int8 stays bit-exact: the s32 accumulation of the tensor cores is exact,
// and |sum| <= 127^2 * 11 * C = 9.1e7 at C = 512, under 2^31, so each sum
// is the integer the CUDA cores' __dp4a gave, in any order; with the same
// f32 epilogue the output is the same bit for bit.
//
// What bounds it on the H100: operations.  A stage does 252 * T * C^2
// integer (or bf16) operations against T * C * 8 bytes of f32 in and out;
// at the dense int8 rate of 1979 TOP/s (bf16 989 TFLOP/s) and 3.35 TB/s the
// operations are the larger bound for C >= 32.
//
// Design.
//  - Work unit: one time tile of one sample with a recomputed halo of 60
//    rows per side (the k = 11 stack's receptive field).  Both quantized
//    conv operands of the tile, (tile + 2 halo) x C int8 or bf16 each, live
//    in shared memory, rows time and input channels contiguous: the layout
//    of the A fragments.  The A operand of tap tau is the tile shifted by
//    tau * d rows, so one tile serves every tap.  The bf16 residual stream
//    stays in a per-tile slice of a global scratch buffer (L2-resident).
//  - A thread-block cluster of 1, 2 or 4 blocks (launched with
//    cudaLaunchKernelEx and a cluster dimension) takes one tile and splits
//    the output channels: block r computes channels [r nb, (r + 1) nb) of
//    every conv (nb = C / cluster).  After the dilated conv each block
//    writes its requantized nb-channel slice of the next operand into every
//    peer's shared memory (distributed shared memory), after the plain conv
//    its channels of the stream into global scratch, and each waits at a
//    cluster barrier (release / acquire, after a __threadfence); each block
//    then builds the whole next operand from the stream, reading the peers'
//    channels from L2 (__ldcg).  So the short, wide stages, whose tiles would
//    otherwise be few or mostly halo, fill the card.
//  - Each conv is an implicit GEMM: M = the conv's valid rows, N = C_out,
//    K = taps x C_in, in passes of 256 rows x 32 channels; each of the 8
//    warps takes 32 rows x 32 channels (2 x 4 mma tiles).  A and B
//    fragments come by ldmatrix.x4: operand rows are padded by 16 bytes and
//    staged weight rows by 16 (one output channel's 8 words in 48 bytes), so
//    the 8 rows of each 8x8 matrix fall in 8 different 16-byte bank groups.
//  - Weights are packed (conv, tap, C_out, C_in / e, e), so one output
//    channel's 8 words of a K-step are 32 contiguous bytes; cp.async (16 B a
//    thread) stages the k taps x 32 channels x 8 words of the next step into
//    a double buffer while the tensor cores run the current one.
//  - Tiles: the wrapper (kernels/stage.py::stage_tiling) picks the cluster
//    and cuts each sample into n_tiles tiles of equal length (+-1 row), as
//    many as fill the card's cluster slots (one block per SM), weighing the
//    recomputed halo and the channel split against waves; the grid is
//    persistent and each cluster walks tiles in turn.
// Shared memory: 2 x (tile + 120) x (C / e + 4) words of operands and
// 2 x k_max x 32 x 12 words of weights (33.8 KB at k = 11).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;              // threads per block: 8 warps
constexpr int KW = 8;                // 32-bit words of input channels per K-step
constexpr int MT = 2;                // m16 tiles per warp
constexpr int NTL = 4;               // n8 tiles per warp
constexpr int RT = NT / 32 * 16 * MT;  // output rows per pass: 256
constexpr int COT = NTL * 8;         // output channels per pass: 32
constexpr int ROW_PAD = 4;           // words of padding per operand row
constexpr int WROW = KW + 4;         // words per staged weight row (one output channel)
constexpr int NSTAGE = 2;            // weight staging buffers
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
  static __device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ inline float to_float(int acc) { return __int2float_rn(acc); }
};

struct Bf16Mode {
  using Acc = float;
  static constexpr int EPW = 2;
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ inline float to_float(float acc) { return acc; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit pairs (= 32-bit words): lanes 8j..8j+7 give
// the row addresses of matrix j, and r[j] holds word (lane % 4) of row
// (lane / 4) of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// All blocks of the cluster; this block's global and distributed shared
// memory writes are visible to the peers after it.
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

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

// Stores elements (l, c) and (l, c + 1) of an operand tile of wpr 32-bit
// words per row, quantized for the mode, into each of the N tiles (this
// block's and its peers' in the cluster); c is even.
template <class M, int N>
__device__ inline void put2(uint32_t* const* tiles, int wpr, int l, int c, float v0, float v1) {
  if constexpr (M::EPW == 4) {
    const uint16_t q = (uint8_t)quant_i8(v0) | (uint16_t)((uint8_t)quant_i8(v1) << 8);
#pragma unroll
    for (int r = 0; r < N; ++r)
      reinterpret_cast<uint16_t*>(tiles[r] + (size_t)l * wpr)[c / 2] = q;
  } else {
    const uint32_t q = bf16_bits(v0) | (uint32_t)bf16_bits(v1) << 16;
#pragma unroll
    for (int r = 0; r < N; ++r) (tiles[r] + (size_t)l * wpr)[c / 2] = q;
  }
}

// Stores elements (l, c .. c + 7) of an operand tile, quantized for the
// mode, with one 8-byte (int8) or 16-byte (bf16) store; c % 8 == 0.
template <class M>
__device__ inline void put8(uint32_t* tile, int wpr, int l, int c, const float (&v)[8]) {
  uint32_t* row = tile + (size_t)l * wpr;
  if constexpr (M::EPW == 4) {
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = (uint8_t)quant_i8(v[4 * h]) | (uint32_t)(uint8_t)quant_i8(v[4 * h + 1]) << 8 |
             (uint32_t)(uint8_t)quant_i8(v[4 * h + 2]) << 16 |
             (uint32_t)(uint8_t)quant_i8(v[4 * h + 3]) << 24;
    *reinterpret_cast<uint2*>(row + c / 4) = make_uint2(w[0], w[1]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      w[h] = bf16_bits(v[2 * h]) | (uint32_t)bf16_bits(v[2 * h + 1]) << 16;
    *reinterpret_cast<uint4*>(row + c / 2) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One conv over local rows [lo, hi) and output channels [n0, n0 + nb):
// reads the operand tile src (rows of wpr words), weights w packed (tap, C,
// C / EPW) words; calls epi(l, co, sum0, sum1) for every output row l in
// [lo, hi) and even channel co, with the sums of channels co and co + 1.
// Steps run over (row pass, channel pass, K-step); step s + 1's weights
// are staged while step s computes.
template <class M, class Epi>
__device__ void conv_pass(const uint32_t* src, int wpr, const uint32_t* __restrict__ w, int C,
                          int n0, int nb, int k, int d, int lo, int hi, uint32_t* s_w,
                          int w_stage, Epi epi) {
  using Acc = typename M::Acc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rb = (tid >> 5) * 16 * MT;  // the warp's first row in a pass
  const int pad = d * (k - 1) / 2;
  const int cw_total = C / M::EPW;
  const int n_k = cw_total / KW;
  const int n_c = nb / COT;
  const int n_steps = (hi - lo + RT - 1) / RT * n_c * n_k;
  // this lane's row and word in the ldmatrix.x4 of an A tile (matrices:
  // rows +0 / +8, words +0 / +4) and of a pair of B tiles (channels +0 / +8)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_word = (lane >> 4) * 4;
  const int b_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_word = ((lane >> 3) & 1) * 4;

  auto stage = [&](int step) {
    uint32_t* sw = s_w + (step % NSTAGE) * w_stage;
    const int c0 = n0 + step / n_k % n_c * COT;
    const int cw0 = step % n_k * KW;
    for (int idx = tid; idx < k * COT * 2; idx += NT) {
      const int half = idx & 1, row = idx >> 1;  // row = tap * COT + co
      const int tap = row / COT, co = row - tap * COT;
      cp_async16(sw + row * WROW + half * 4,
                 w + ((size_t)(tap * C + c0 + co) * cw_total + cw0 + half * 4));
    }
  };

  Acc acc[MT][NTL][4];
  __syncthreads();  // src is written; earlier readers of s_w are done
  stage(0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) stage(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kstep = step % n_k;
    const int c0 = n0 + step / n_k % n_c * COT;
    const int r0 = lo + step / (n_k * n_c) * RT + rb;
    if (kstep == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTL; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
    }
    if (r0 < hi) {
      const uint32_t* sw = s_w + (step % NSTAGE) * w_stage;
      const uint32_t* a_base[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int l = min(r0 + m * 16 + a_row, hi - 1) - pad;  // rows past hi are discarded
        a_base[m] = src + (size_t)l * wpr + kstep * KW + a_word;
      }
      const uint32_t* b_base = sw + b_row * WROW + b_word;
      for (int tap = 0; tap < k; ++tap) {
        uint32_t a[MT][4], b[NTL / 2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldsm_x4(a[m], a_base[m] + (size_t)tap * d * wpr);
#pragma unroll
        for (int p = 0; p < NTL / 2; ++p) ldsm_x4(b[p], b_base + (tap * COT + p * 16) * WROW);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NTL; ++n)
            M::mma(acc[m][n], a[m], b[n / 2][(n & 1) * 2], b[n / 2][(n & 1) * 2 + 1]);
      }
      if (kstep == n_k - 1) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int l = r0 + m * 16 + g + 8 * half;
            if (l < hi) {
#pragma unroll
              for (int n = 0; n < NTL; ++n)
                epi(l, c0 + n * 8 + 2 * t, M::to_float(acc[m][n][2 * half]),
                    M::to_float(acc[m][n][2 * half + 1]));
            }
          }
      }
    }
    __syncthreads();  // this buffer is restaged at step + 2
  }
}

struct StageArgs {
  int B, T, C, tile, halo, n_tiles, cluster;
  int ks[N_STACKS];
  int dil[N_ROUNDS];
  float slope;
};

__host__ __device__ inline long smem_need(int epw, int C, int tile, int halo, int k_max) {
  return 4L * (2L * (tile + 2 * halo) * (C / epw + ROW_PAD) + (long)NSTAGE * k_max * COT * WROW);
}

// Block barrier, or with CL > 1 cluster barrier.
template <int CL>
__device__ __forceinline__ void tile_sync() {
  if constexpr (CL > 1) cluster_sync();
  else __syncthreads();
}

template <class M, int CL>
__global__ void __launch_bounds__(NT, 1) stage_q_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ w,
    const float* __restrict__ qin, const float* __restrict__ deq,
    const float* __restrict__ bias, float* out, uint16_t* scratch, StageArgs args) {
  extern __shared__ uint4 smem4[];
  constexpr bool INT8 = M::EPW == 4;
  const int C = args.C, T = args.T, halo = args.halo, n_tiles = args.n_tiles;
  const float slope = args.slope;
  const int W = args.tile + 2 * halo;
  const int wpr = C / M::EPW + ROW_PAD;  // words per operand row
  uint32_t* q_in = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* q_mid = q_in + (size_t)W * wpr;
  uint32_t* s_w = q_mid + (size_t)W * wpr;
  const int w_stage = args.ks[N_STACKS - 1] * COT * WROW;
  const int rank = blockIdx.x % CL;  // block r computes channels [r nb, (r + 1) nb)
  const int cid = blockIdx.x / CL;
  const int n_clusters = gridDim.x / CL;
  const int nb = C / CL, n0 = rank * nb;
  uint16_t* res = scratch + (size_t)cid * W * C;  // the cluster's stream
  uint32_t* q_mids[CL];                           // every block's q_mid
  q_mids[0] = q_mid;
  if constexpr (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < CL; ++r)
      q_mids[r] = r != rank ? cluster.map_shared_rank(q_mid, r) : q_mid;
  }

  for (int job = cid; job < args.B * n_tiles; job += n_clusters) {
    const int b = job / n_tiles;
    const int j = job - b * n_tiles;
    const int t0 = (int)((long)j * T / n_tiles);  // tiles of equal length, +-1 row
    const int n_out = (int)((long)(j + 1) * T / n_tiles) - t0;
    const int g0 = t0 - halo;
    const float* xb = x + (size_t)b * T * C;
    float* ob = out + (size_t)b * T * C;
    size_t w_off = 0;
    int conv = 0;
    for (int s = 0; s < N_STACKS; ++s) {
      const int k = args.ks[s];
      const int hs = stack_halo(k, args.dil);
      int lo = halo - hs, hi = halo + n_out + hs;
      __syncthreads();  // the previous stack's readers of res are done
      for (int idx = threadIdx.x; idx < (hi - lo) * (nb / 4); idx += NT) {
        const int l = lo + idx / (nb / 4), c = n0 + idx % (nb / 4) * 4;
        const int g = g0 + l;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g >= 0 && g < T) v = *reinterpret_cast<const float4*>(xb + (size_t)g * C + c);
        *reinterpret_cast<uint2*>(res + (size_t)l * C + c) =
            make_uint2(bf16_bits(v.x) | (uint32_t)bf16_bits(v.y) << 16,
                       bf16_bits(v.z) | (uint32_t)bf16_bits(v.w) << 16);
      }
      tile_sync<CL>();  // every block's channels of the stream are in place
      for (int r = 0; r < N_ROUNDS; ++r) {
        const int d = args.dil[r];
        const float qs = qin[conv];
        // every channel of the stream, 8 at a time, the peers' from L2 (__ldcg)
        for (int idx = threadIdx.x; idx < (hi - lo) * (C / 8); idx += NT) {
          const int l = lo + idx / (C / 8), c = idx % (C / 8) * 8;
          const int g = g0 + l;
          float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (g >= 0 && g < T) {
            const uint4* rp = reinterpret_cast<const uint4*>(res + (size_t)l * C + c);
            const uint4 u = CL > 1 ? __ldcg(rp) : *rp;
            const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              v[e] = lrelu(bf16_value((uint16_t)(words[e / 2] >> (16 * (e % 2)))), slope);
              if (INT8) v[e] = __fmul_rn(v[e], qs);
            }
          }
          put8<M>(q_in, wpr, l, c, v);
        }
        // dilated conv -> lrelu -> requantized operand of the next conv
        const float* deq1 = deq + (size_t)conv * C;
        const float* b1 = bias + (size_t)conv * C;
        const int lo1 = lo + d * (k - 1) / 2, hi1 = hi - d * (k - 1) / 2;
        conv_pass<M>(q_in, wpr, w + w_off, C, n0, nb, k, d, lo1, hi1, s_w, w_stage,
                     [&](int l, int co, float sum0, float sum1) {
                       const int g = g0 + l;
                       float v[2] = {0.f, 0.f};
                       if (g >= 0 && g < T) {
                         const float2 dq = *reinterpret_cast<const float2*>(deq1 + co);
                         const float2 bs = *reinterpret_cast<const float2*>(b1 + co);
                         v[0] = INT8 ? __fadd_rn(__fmul_rn(sum0, dq.x), bs.x)
                                     : __fadd_rn(sum0, bs.x);
                         v[1] = INT8 ? __fadd_rn(__fmul_rn(sum1, dq.y), bs.y)
                                     : __fadd_rn(sum1, bs.y);
                         v[0] = lrelu(v[0], slope);
                         v[1] = lrelu(v[1], slope);
                       }
                       put2<M, CL>(q_mids, wpr, l, co, v[0], v[1]);
                     });
        w_off += (size_t)k * C * C / M::EPW;
        ++conv;
        tile_sync<CL>();  // every block's q_mid holds every channel
        // plain conv -> dequant -> residual update in bf16
        const float* deq2 = deq + (size_t)conv * C;
        const float* b2 = bias + (size_t)conv * C;
        lo = lo1 + (k - 1) / 2;
        hi = hi1 - (k - 1) / 2;
        conv_pass<M>(q_mid, wpr, w + w_off, C, n0, nb, k, 1, lo, hi, s_w, w_stage,
                     [&](int l, int co, float sum0, float sum1) {
                       const int g = g0 + l;
                       uint32_t* rp = reinterpret_cast<uint32_t*>(res + (size_t)l * C + co);
                       float upd[2] = {0.f, 0.f};
                       if (g >= 0 && g < T) {
                         const float2 dq = *reinterpret_cast<const float2*>(deq2 + co);
                         const float2 bs = *reinterpret_cast<const float2*>(b2 + co);
                         upd[0] = INT8 ? __fadd_rn(__fmul_rn(sum0, dq.x), bs.x)
                                       : __fadd_rn(sum0, bs.x);
                         upd[1] = INT8 ? __fadd_rn(__fmul_rn(sum1, dq.y), bs.y)
                                       : __fadd_rn(sum1, bs.y);
                       }
                       const uint32_t old = *rp;
                       *rp = bf16_bits(__fadd_rn(bf16_value((uint16_t)old), upd[0])) |
                             (uint32_t)bf16_bits(__fadd_rn(bf16_value((uint16_t)(old >> 16)),
                                                           upd[1])) << 16;
                     });
        w_off += (size_t)k * C * C / M::EPW;
        ++conv;
        tile_sync<CL>();  // the stream's update is visible to every block
      }
      // rows [halo, halo + n_out) of this block's channels are final for this stack
      for (int idx = threadIdx.x; idx < n_out * (nb / 4); idx += NT) {
        const int r = idx / (nb / 4), c = n0 + idx % (nb / 4) * 4;
        const uint2 u = *reinterpret_cast<const uint2*>(res + (size_t)(halo + r) * C + c);
        const float v[4] = {bf16_value((uint16_t)u.x), bf16_value((uint16_t)(u.x >> 16)),
                            bf16_value((uint16_t)u.y), bf16_value((uint16_t)(u.y >> 16))};
        float4* op = reinterpret_cast<float4*>(ob + (size_t)(t0 + r) * C + c);
        float o[4] = {v[0], v[1], v[2], v[3]};
        if (s > 0) {
          const float4 a = *op;
          const float prev[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[e] = __fadd_rn(prev[e], v[e]);
            if (s == N_STACKS - 1) o[e] = __fdiv_rn(o[e], (float)N_STACKS);
          }
        }
        *op = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

template <class M, int CL>
cudaError_t configure(int grid, int smem, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(stage_q_kernel<M, CL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <class M, int CL>
cudaError_t launch_cl(const float* x, const uint32_t* w, const float* qin, const float* deq,
                      const float* bias, float* out, uint16_t* scratch, const StageArgs& args,
                      int grid, int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<M, CL>(grid, smem, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  if (CL == 1) cfg.numAttrs = 0;  // a plain launch
  err = cudaLaunchKernelEx(&cfg, stage_q_kernel<M, CL>, x, w, qin, deq, bias, out, scratch,
                           args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class M>
cudaError_t launch(const float* x, const uint32_t* w, const float* qin, const float* deq,
                   const float* bias, float* out, uint16_t* scratch, const StageArgs& args,
                   int grid, int smem, cudaStream_t stream) {
  if (args.cluster == 4)
    return launch_cl<M, 4>(x, w, qin, deq, bias, out, scratch, args, grid, smem, stream);
  if (args.cluster == 2)
    return launch_cl<M, 2>(x, w, qin, deq, bias, out, scratch, args, grid, smem, stream);
  return launch_cl<M, 1>(x, w, qin, deq, bias, out, scratch, args, grid, smem, stream);
}

template <class M, int CL>
cudaError_t max_clusters_cl(int smem, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<M, CL>(CL, smem, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, stage_q_kernel<M, CL>, &cfg);
}

template <class M>
cudaError_t max_clusters(int cluster, int smem, int* n) {
  if (cluster == 4) return max_clusters_cl<M, 4>(smem, n);
  if (cluster == 2) return max_clusters_cl<M, 2>(smem, n);
  return max_clusters_cl<M, 1>(smem, n);
}

}  // namespace

// mode 0 = int8, 1 = bf16.  x, out (B, T, C) f32, 16-byte aligned; w the
// packed weights of the 18 convs (stack-major, the dilated conv of each
// round before its plain conv), (conv, tap, C_out, C_in/EPW, EPW) with
// EPW = 4 int8 or 2 bf16 input channels per 32-bit word, 16-byte aligned;
// qin (18) the input scale of each dilated conv (int8); deq, bias (18, C)
// f32; each sample cut into n_tiles tiles of at most `tile` rows, each
// computed by a cluster of `cluster` blocks (1, 2 or 4; C / cluster a
// multiple of 32); scratch (grid / cluster) * (tile + 2 * halo) * C bf16;
// smem the dynamic shared memory (at least two operand tiles and two
// weight steps, see kernels/stage.py).  Kernel sizes and dilations must be
// ascending (the last of each is the widest).
extern "C" int hifigan_stage_q(int mode, const void* x, const void* w, const void* qin,
                               const void* deq, const void* bias, void* out, void* scratch,
                               int B, int T, int C, int k0, int k1, int k2, int d0, int d1,
                               int d2, int tile, int halo, int n_tiles, int cluster, int grid,
                               int smem, float slope, void* stream) {
  StageArgs args{B, T, C, tile, halo, n_tiles, cluster, {k0, k1, k2}, {d0, d1, d2}, slope};
  const int epw = mode == 0 ? 4 : 2;
  if ((mode != 0 && mode != 1) || B <= 0 || T <= 0 || tile <= 0 || grid <= 0 ||
      !(cluster == 1 || cluster == 2 || cluster == 4) || (C / cluster) % COT != 0 ||
      C % cluster != 0 || grid % cluster != 0 ||
      n_tiles <= 0 || n_tiles > T || (long)tile * n_tiles < T || C % 32 != 0 ||
      !(k0 <= k1 && k1 <= k2) || !(d0 <= d1 && d1 <= d2) || halo < stack_halo(k2, args.dil) ||
      smem < smem_need(epw, C, tile, halo, k2) || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
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
    return (int)launch<Int8Mode>(xx, ww, qq, dd, bb, oo, ss, args, grid, smem, st);
  return (int)launch<Bf16Mode>(xx, ww, qq, dd, bb, oo, ss, args, grid, smem, st);
}

// How many clusters of `cluster` blocks the current device runs at once
// with `smem` bytes of dynamic shared memory a block.
extern "C" int hifigan_stage_q_max_clusters(int mode, int cluster, int smem, void* n) {
  if ((mode != 0 && mode != 1) || !(cluster == 1 || cluster == 2 || cluster == 4))
    return (int)cudaErrorInvalidValue;
  auto* nn = static_cast<int*>(n);
  if (mode == 0) return (int)max_clusters<Int8Mode>(cluster, smem, nn);
  return (int)max_clusters<Bf16Mode>(cluster, smem, nn);
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

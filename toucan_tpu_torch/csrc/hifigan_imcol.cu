// One HiFiGAN residual stage in the im2col kernel's int8 or bf16 mode, on the
// tensor cores.
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
// window), int8 weights with per-output-channel scales s, exact integer sums.
// bf16: quant is a bf16 rounding, s = 1 and a / 127 = 1, f32 sums.  The rows
// the wrap fills with garbage stay in the halo, but in int8 they enter the
// next conv's a, so every row of the window is computed and the window
// geometry is JAX's.  IEEE arithmetic in JAX's order: __fdiv_rn for 127 / a,
// a / 127 and / 3, __fmul_rn / __fadd_rn so that no FMA contraction moves a
// value across a rounding boundary.
//
// The products: mma.sync.m16n8k32 s8 x s8 -> s32 (int8) and
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (bf16), K3's fragments
// (csrc/hifigan_stage_q.cu): a 32-bit word holds 4 int8 or 2 bf16
// consecutive input channels, one K-step is 8 words in both modes.  int8
// stays bit-exact: the s32 sums are exact (|sum| <= 127^2 * 11 * C), so any
// order gives the integer the earlier __dp4a kernel and the plain version
// give, and the f32 epilogue is theirs.
//
// What bounds it on the H100: operations.  A stage does 252 * T * C^2
// integer (or bf16) operations of least work against T * C * 8 bytes of f32
// in and out; at the dense int8 rate of 1979 TOP/s (bf16 989 TFLOP/s) and
// 3.35 TB/s the operations are the larger bound.  In practice the window's
// f32 streams, which cross L2 once per conv, and the elementwise passes
// weigh as much as the products at C <= 128.
//
// Design.
//  - Work unit: one window, on a thread-block cluster of 1, 2 or 4 blocks
//    (launched with cudaLaunchKernelEx and a cluster dimension) that splits
//    its rows: block r owns rows [r n_s / CL, (r + 1) n_s / CL).  Each block
//    keeps the quantized conv operand of its rows in shared memory with
//    `margin` rows more on each side (the widest tap's reach), rows = time
//    and input channels contiguous: the layout of the A fragments.  Those
//    margins are its neighbours' edge rows, and circularly the window's
//    other end: the quantize pass writes each row it owns into its own
//    operand and, for the first and last `margin` rows, into the previous
//    and next block's margins (distributed shared memory; with one block,
//    its own margins), then waits at a cluster barrier.  So a tap is a row
//    offset and nothing wraps in the inner loop.
//  - The window's max |lrelu| (int8) is reduced per warp, over the block
//    in shared memory, and over the cluster by each block writing its max
//    into every peer's slot before the next cluster barrier.
//  - The two f32 streams xb and xt of a block's rows stay in a per-cluster
//    slice of a global scratch buffer (L2-resident for the blocks in
//    flight), read 4 channels a thread (float4) by the quantize pass and
//    written as channel pairs by the epilogue.
//  - Each conv is an implicit GEMM: M = the block's rows, N = C_out, in
//    passes of 256 rows x 32 channels; each of the 8 warps takes 32 rows x
//    32 channels (2 x 4 mma tiles).  Weights are packed (conv, tap, C_out,
//    C_in / e, e); cp.async stages k steps x 32 channels x 8 words into a
//    double buffer while the tensor cores run the current ones, or, where
//    the buffers hold all of a conv's weight steps (int8 up to C = 64, bf16
//    up to 32, where they fit), once per conv with no barrier between
//    steps; B comes by ldmatrix.x4 (staged rows padded by 16 bytes).  Two ways of
//    walking K = taps x input words:
//      TAPS (C / e a multiple of 8): a step is 8 words of channels at each
//      of the k taps, A by ldmatrix.x4 from operand rows padded by 16
//      bytes, as K3;
//      FLAT (any other width, or where the padded rows do not fit): K is
//      flattened over (tap, word), cut into steps of 8 words (the last
//      zero-padded in the weights), and A comes by 32-bit loads from dense
//      operand rows.  So every C % 4 == 0 runs, with no zero channels.
//    Output channels past C are zero weights and are not stored.
//  - A persistent grid: the wrapper (kernels/imcol.py::imcol_tiling)
//    picks the cluster size and launches as many clusters as the card runs
//    at once (at most one per window); each walks windows in turn.  Blocks
//    run one to an SM (up to 255 registers a thread), or two where the
//    windows are fewer than half the SMs: then clusters of 4 blocks of
//    under 113 KB each fill the card (128 registers a thread, a few
//    spilled), which on the H100 beat one block per SM at stage 1 of 512
//    frames and lost at the stages with a window per SM
//    (scripts/k4_variants.py, PERF.md).
// Shared memory: (ceil(n_s / CL) + 2 margin) x wpr words of operand and
// 2 or more x k_max x 32 x 12 words of weights (16.9 KB each at k = 11).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;                // threads per block: 8 warps
constexpr int N_WARPS = NT / 32;
constexpr int KW = 8;                  // 32-bit words of K per step
constexpr int MT = 2;                  // m16 tiles per warp
constexpr int NTL = 4;                 // n8 tiles per warp
constexpr int RT = N_WARPS * 16 * MT;  // output rows per pass: 256
constexpr int COT = NTL * 8;           // output channels per pass: 32
constexpr int WROW = KW + 4;           // words per staged weight row (one output channel)
constexpr int UNR = 4;                 // float4 loads a thread keeps in flight in a pass
constexpr int QUNR = 8;                // ... in the quantize pass
constexpr int N_STACKS = 3;
constexpr int N_ROUNDS = 3;

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

// cp.async of 16 (or 4) bytes; with valid false the destination is zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
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

// Every thread of the cluster; shared memory writes (local and distributed)
// before it are visible to every block of the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block barrier, or with CL > 1 cluster barrier.
template <int CL>
__device__ __forceinline__ void tile_sync() {
  if constexpr (CL > 1) cluster_sync();
  else __syncthreads();
}

__device__ inline float lrelu(float v, float slope) { return fmaxf(v, __fmul_rn(slope, v)); }

__device__ inline uint32_t quant_i8(float v) {
  return (uint8_t)(int8_t)__float2int_rn(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

__device__ inline uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Four channels of a conv input, quantized for the mode: int8 one word
// (v scaled by qs = 127 / a), bf16 two.
template <class M>
__device__ inline uint2 quant4(float4 v, float qs, float slope) {
  float e[4] = {lrelu(v.x, slope), lrelu(v.y, slope), lrelu(v.z, slope), lrelu(v.w, slope)};
  if constexpr (M::EPW == 4) {
    uint32_t q = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) q |= quant_i8(__fmul_rn(e[i], qs)) << (8 * i);
    return make_uint2(q, 0u);
  } else {
    return make_uint2(bf16_bits(e[0]) | bf16_bits(e[1]) << 16,
                      bf16_bits(e[2]) | bf16_bits(e[3]) << 16);
  }
}

// Stores four quantized channels c .. c + 3 (c % 4 == 0) into an operand row.
template <class M>
__device__ inline void store4(uint32_t* row, int c, uint2 q) {
  if constexpr (M::EPW == 4) row[c / 4] = q.x;
  else *reinterpret_cast<uint2*>(row + c / 2) = q;
}

__device__ inline float abs_lrelu_max(float4 v, float slope, float m) {
  m = fmaxf(m, fabsf(lrelu(v.x, slope)));
  m = fmaxf(m, fabsf(lrelu(v.y, slope)));
  m = fmaxf(m, fabsf(lrelu(v.z, slope)));
  return fmaxf(m, fabsf(lrelu(v.w, slope)));
}

// The max of m over the window: per warp, over the block (red), and with
// CL > 1 over the cluster (slots: each block's max, written by every block
// into every peer).  Ends with a block (CL == 1) or cluster barrier.
template <int CL>
__device__ float window_max(float m, float* red, float* slots, float* const* peer_slots,
                            int rank) {
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if constexpr (CL == 1) {
    m = red[0];
#pragma unroll
    for (int w = 1; w < N_WARPS; ++w) m = fmaxf(m, red[w]);
    return m;
  } else {
    if (threadIdx.x < CL) {
      float v = red[0];
#pragma unroll
      for (int w = 1; w < N_WARPS; ++w) v = fmaxf(v, red[w]);
      peer_slots[threadIdx.x][rank] = v;
    }
    cluster_sync();
    m = slots[0];
#pragma unroll
    for (int r = 1; r < CL; ++r) m = fmaxf(m, slots[r]);
    return m;
  }
}

// One conv over the block's rows [0, n) and every output channel: reads the
// operand src (row 0 at src, rows [-pad, n + pad) readable, wpr words a
// row), weights w packed (tap, C, C / EPW) words; for every row l and even
// channel co < C calls epi(l, co, sum0, sum1, prior) with the sums of
// channels co and co + 1 and prior = pre(l, co), which is called for all of
// a warp's outputs before the products of their last step, so that the
// stream's loads are in flight together and under the products.  Steps run
// over (row pass, channel pass, chunk of K); step s + 1's weights are
// staged while step s computes.  TAPS: a chunk is one word offset of 8
// words at each of the k taps; FLAT: k consecutive steps of the flattened
// (tap, word) axis.
template <class M, bool FLAT, class Pre, class Epi>
__device__ void conv_pass(const uint32_t* src, int wpr, const uint32_t* __restrict__ w, int C,
                          int k, int d, int n, uint32_t* s_w, int w_stage, int wslots, Pre pre,
                          Epi epi) {
  using Acc = typename M::Acc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rb = (tid >> 5) * 16 * MT;  // the warp's first row in a pass
  const int pad = d * (k - 1) / 2;
  const int cw_total = C / M::EPW;      // words of input channels per tap
  const int kw_total = k * cw_total;    // FLAT: words of K
  const int n_ks = FLAT ? (kw_total + KW - 1) / KW : cw_total / KW;  // steps of K per tap (TAPS)
  const int n_k = FLAT ? (n_ks + k - 1) / k : n_ks;                  // chunks
  const int n_c = (C + COT - 1) / COT;
  const int n_steps = (n + RT - 1) / RT * n_c * n_k;
  // this lane's row and word in the ldmatrix.x4 of an A tile (matrices:
  // rows +0 / +8, words +0 / +4) and of a pair of B tiles (channels +0 / +8)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_word = (lane >> 4) * 4;
  const int b_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_word = ((lane >> 3) & 1) * 4;

  // the weights of `step` into buffer `slot`
  auto stage = [&](int step, int slot) {
    uint32_t* sw = s_w + slot * w_stage;
    const int c0 = step / n_k % n_c * COT;
    const int chunk = step % n_k;
    if constexpr (!FLAT) {
      for (int idx = tid; idx < k * COT * 2; idx += NT) {
        const int half = idx & 1, row = idx >> 1;  // row = tap * COT + co
        const int tap = row / COT, co = row - tap * COT;
        const bool ok = c0 + co < C;
        cp_async16(sw + row * WROW + half * 4,
                   w + ((size_t)(tap * C + (ok ? c0 + co : 0)) * cw_total + chunk * KW + half * 4),
                   ok);
      }
    } else {
      for (int idx = tid; idx < k * COT * KW; idx += NT) {
        const int word = idx % KW, row = idx / KW;  // row = j * COT + co
        const int j = row / COT, co = row - j * COT;
        const int kw = (chunk * k + j) * KW + word;
        const bool ok = c0 + co < C && kw < kw_total;
        const int tap = ok ? kw / cw_total : 0;
        const int cw = ok ? kw - tap * cw_total : 0;
        cp_async4(sw + row * WROW + word,
                  w + ((size_t)(tap * C + (ok ? c0 + co : 0)) * cw_total + cw), ok);
      }
    }
  };

  // The conv's n_w distinct weight steps (channel pass, chunk) repeat for
  // every row pass.  Where wslots buffers hold them all they are staged
  // once, and the steps need no barrier between them; otherwise step s + 1
  // is staged while step s computes, in two buffers.
  const int n_w = n_c * n_k;
  const bool resident = n_w <= wslots;
  Acc acc[MT][NTL][4];
  __syncthreads();  // src is written; earlier readers of s_w are done
  if (resident) {
    for (int j = 0; j < n_w; ++j) stage(j, j);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else {
    stage(0, 0);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    if (!resident) {
      if (step + 1 < n_steps) stage(step + 1, (step + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    const int chunk = step % n_k;
    const int c0 = step / n_k % n_c * COT;
    const int r0 = step / (n_k * n_c) * RT + rb;
    if (chunk == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nn = 0; nn < NTL; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nn][e] = 0;
    }
    if (r0 < n) {
      const bool last = chunk == n_k - 1;
      float2 prior[MT][2][NTL];
      if (last) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int l = r0 + m * 16 + g + 8 * half;
#pragma unroll
            for (int nn = 0; nn < NTL; ++nn) {
              const int co = c0 + nn * 8 + 2 * t;
              prior[m][half][nn] = l < n && co < C ? pre(l, co) : make_float2(0.f, 0.f);
            }
          }
      }
      const uint32_t* sw = s_w + (resident ? step % n_w : step % 2) * w_stage;
      const uint32_t* b_base = sw + b_row * WROW + b_word;
      if constexpr (!FLAT) {
        const uint32_t* a_base[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int l = min(r0 + m * 16 + a_row, n - 1) - pad;  // rows past n are discarded
          a_base[m] = src + (ptrdiff_t)l * wpr + chunk * KW + a_word;
        }
        for (int tap = 0; tap < k; ++tap) {
          uint32_t a[MT][4], b[NTL / 2][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) ldsm_x4(a[m], a_base[m] + (ptrdiff_t)tap * d * wpr);
#pragma unroll
          for (int p = 0; p < NTL / 2; ++p) ldsm_x4(b[p], b_base + (tap * COT + p * 16) * WROW);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int nn = 0; nn < NTL; ++nn)
              M::mma(acc[m][nn], a[m], b[nn / 2][(nn & 1) * 2], b[nn / 2][(nn & 1) * 2 + 1]);
        }
      } else {
        // rows g and g + 8 of each m tile, clamped as above
        const uint32_t* a_row_ptr[MT][2];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a_row_ptr[m][h] = src + (ptrdiff_t)(min(r0 + m * 16 + g + 8 * h, n - 1) - pad) * wpr;
        const int nj = min(k, n_ks - chunk * k);
        for (int j = 0; j < nj; ++j) {
          // this lane's words t and t + 4 of the step, as (tap, word) offsets;
          // past the end of K, any word in range (its weights are zero)
          int off[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kw = min((chunk * k + j) * KW + t + 4 * h, kw_total - 1);
            const int tap = kw / cw_total;
            off[h] = tap * d * wpr + kw - tap * cw_total;
          }
          uint32_t a[MT][4], b[NTL / 2][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            a[m][0] = a_row_ptr[m][0][off[0]];
            a[m][1] = a_row_ptr[m][1][off[0]];
            a[m][2] = a_row_ptr[m][0][off[1]];
            a[m][3] = a_row_ptr[m][1][off[1]];
          }
#pragma unroll
          for (int p = 0; p < NTL / 2; ++p) ldsm_x4(b[p], b_base + (j * COT + p * 16) * WROW);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int nn = 0; nn < NTL; ++nn)
              M::mma(acc[m][nn], a[m], b[nn / 2][(nn & 1) * 2], b[nn / 2][(nn & 1) * 2 + 1]);
        }
      }
      if (last) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int l = r0 + m * 16 + g + 8 * half;
            if (l < n) {
#pragma unroll
              for (int nn = 0; nn < NTL; ++nn) {
                const int co = c0 + nn * 8 + 2 * t;
                if (co < C)
                  epi(l, co, M::to_float(acc[m][nn][2 * half]),
                      M::to_float(acc[m][nn][2 * half + 1]), prior[m][half][nn]);
              }
            }
          }
      }
    }
    if (!resident) __syncthreads();  // this buffer is restaged at step + 2
  }
}

struct ImcolArgs {
  int B, T, C, step, left, margin, wpr, wslots;
  int ks[N_STACKS];
  int dil[N_ROUNDS];
  float slope;
};

__host__ __device__ inline int block_lo(int rank, int n_s, int cl) {
  return (int)((long)rank * n_s / cl);
}

// Words of dynamic shared memory: the operand (rounded to 16 bytes), the
// wslots weight buffers, the warp maxima and the cluster's slots.
__host__ __device__ inline long smem_words(int n_s, int cl, int margin, int wpr, int k_max,
                                           int wslots) {
  const long rows = (n_s + cl - 1) / cl + 2L * margin;
  return (rows * wpr + 3) / 4 * 4 + (long)wslots * k_max * COT * WROW + N_WARPS + cl;
}

// MINB: blocks an SM runs at once (1: up to 255 registers a thread, and
// the epilogue's loads of the stream issued before the last step's
// products; 2: 128 registers, the loads in the epilogue).
template <class M, int CL, bool FLAT, int MINB>
__global__ void __launch_bounds__(NT, MINB) imcol_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ w,
    const float* __restrict__ wscale, const float* __restrict__ bias, float* out,
    float* scratch, ImcolArgs args) {
  extern __shared__ uint4 smem4[];
  constexpr bool INT8 = M::EPW == 4;
  const int C = args.C, T = args.T, step = args.step, left = args.left;
  const int n_s = step + 2 * left, margin = args.margin, wpr = args.wpr;
  const float slope = args.slope;
  const int rank = blockIdx.x % CL;  // the block's rank in its cluster
  const int cid = blockIdx.x / CL;
  const int n_clusters = gridDim.x / CL;
  const int lo = block_lo(rank, n_s, CL), n = block_lo(rank + 1, n_s, CL) - lo;
  const int prev = (rank + CL - 1) % CL, next = (rank + 1) % CL;
  const int n_prev = block_lo(prev + 1, n_s, CL) - block_lo(prev, n_s, CL);
  const long op_words = ((long)((n_s + CL - 1) / CL + 2 * margin) * wpr + 3) / 4 * 4;
  uint32_t* op = reinterpret_cast<uint32_t*>(smem4) + (size_t)margin * wpr;  // own row 0
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem4) + op_words;
  const int w_stage = args.ks[N_STACKS - 1] * COT * WROW;
  float* red = reinterpret_cast<float*>(s_w + args.wslots * w_stage);
  float* slots = red + N_WARPS;
  // row 0 of the previous and the next block's operand: they take this
  // block's first and last `margin` rows into their margins
  uint32_t* op_prev = op;
  uint32_t* op_next = op;
  float* peer_slots[CL];
  peer_slots[0] = slots;
  if constexpr (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    op_prev = cluster.map_shared_rank(op, prev);
    op_next = cluster.map_shared_rank(op, next);
#pragma unroll
    for (int r = 0; r < CL; ++r) peer_slots[r] = cluster.map_shared_rank(slots, r);
  }
  float* xb = scratch + (size_t)cid * 2 * n_s * C + (size_t)lo * C;  // the block's rows
  float* xt = xb + (size_t)n_s * C;
  const int n_win = (T + step - 1) / step;
  const int c4 = C / 4;

  for (int job = cid; job < args.B * n_win; job += n_clusters) {
    const int b = job / n_win;
    const int g0 = (job - b * n_win) * step - left + lo;  // sample of the block's row 0
    const float* xbat = x + (size_t)b * T * C;
    float* obat = out + (size_t)b * T * C;
    float a0 = 0.f;  // int8: max|lrelu(x)| over the window, the first conv's scale
    size_t w_off = 0;
    int conv = 0;
    for (int s = 0; s < N_STACKS; ++s) {
      const int k = args.ks[s];
      __syncthreads();  // the previous stack's readers of xb are done
      float m = 0.f;
      for (int base = threadIdx.x; base < n * c4; base += UNR * NT) {
        float4 v[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int idx = base + u * NT, g = g0 + idx / c4;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < n * c4 && g >= 0 && g < T)
            v[u] = *reinterpret_cast<const float4*>(xbat + (ptrdiff_t)g0 * C + (ptrdiff_t)idx * 4);
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int idx = base + u * NT;
          if (idx >= n * c4) break;
          *reinterpret_cast<float4*>(xb + (size_t)idx * 4) = v[u];
          if (INT8 && s == 0) m = abs_lrelu_max(v[u], slope, m);
        }
      }
      bool synced = false;  // whether a barrier follows the last writes of the stream
      if (INT8 && s == 0) {
        a0 = window_max<CL>(m, red, slots, peer_slots, rank);
        synced = true;
      }
      float a = a0;  // max|lrelu| of the next conv's input
      for (int r = 0; r < N_ROUNDS; ++r) {
        for (int half = 0; half < 2; ++half) {
          const int d = half == 0 ? args.dil[r] : 1;
          const float* src = half == 0 ? xb : xt;
          a = fmaxf(a, 1e-6f);
          const float qs = INT8 ? __fdiv_rn(127.f, a) : 1.f;
          const float aq = __fdiv_rn(a, 127.f);
          // src is written, and every block's readers of its operand are done
          if (!synced) tile_sync<CL>();
          // QUNR loads in flight a thread before their quantization
          for (int base = threadIdx.x; base < n * c4; base += QUNR * NT) {
            float4 v[QUNR];
#pragma unroll
            for (int u = 0; u < QUNR; ++u) {
              const int idx = base + u * NT;
              if (idx < n * c4) v[u] = *reinterpret_cast<const float4*>(src + (size_t)idx * 4);
            }
#pragma unroll
            for (int u = 0; u < QUNR; ++u) {
              const int idx = base + u * NT;
              if (idx >= n * c4) break;
              const int l = idx / c4, c = (idx - l * c4) * 4;
              const uint2 q = quant4<M>(v[u], qs, slope);
              store4<M>(op + (size_t)l * wpr, c, q);
              if (l < margin) store4<M>(op_prev + (ptrdiff_t)(n_prev + l) * wpr, c, q);
              if (l >= n - margin) store4<M>(op_next + (ptrdiff_t)(l - n) * wpr, c, q);
            }
          }
          tile_sync<CL>();  // every block's operand is whole
          const float* sc = wscale + (size_t)conv * C;
          const float* bi = bias + (size_t)conv * C;
          m = 0.f;
          if (half == 0) {
            conv_pass<M, FLAT>(op, wpr, w + w_off, C, k, d, n, s_w, w_stage,
                               args.wslots, [](int, int) { return make_float2(0.f, 0.f); },
                               [&](int l, int co, float s0, float s1, float2) {
                                 const int g = g0 + l;
                                 float2 v = make_float2(0.f, 0.f);
                                 if (g >= 0 && g < T) {
                                   const float2 f = *reinterpret_cast<const float2*>(sc + co);
                                   const float2 bb = *reinterpret_cast<const float2*>(bi + co);
                                   v.x = INT8 ? __fadd_rn(__fmul_rn(s0, __fmul_rn(f.x, aq)), bb.x)
                                              : __fadd_rn(s0, bb.x);
                                   v.y = INT8 ? __fadd_rn(__fmul_rn(s1, __fmul_rn(f.y, aq)), bb.y)
                                              : __fadd_rn(s1, bb.y);
                                 }
                                 *reinterpret_cast<float2*>(xt + (size_t)l * C + co) = v;
                                 m = fmaxf(m, fmaxf(fabsf(lrelu(v.x, slope)),
                                                    fabsf(lrelu(v.y, slope))));
                               });
          } else {
            conv_pass<M, FLAT>(op, wpr, w + w_off, C, k, 1, n, s_w, w_stage,
                               args.wslots, [&](int l, int co) {
                                 if constexpr (MINB == 1)
                                   return *reinterpret_cast<const float2*>(xb + (size_t)l * C + co);
                                 else
                                   return make_float2(0.f, 0.f);
                               },
                               [&](int l, int co, float s0, float s1, float2 o) {
                                 const int g = g0 + l;
                                 float2 v = make_float2(0.f, 0.f);
                                 if (g >= 0 && g < T) {
                                   const float2 f = *reinterpret_cast<const float2*>(sc + co);
                                   const float2 bb = *reinterpret_cast<const float2*>(bi + co);
                                   v.x = INT8 ? __fadd_rn(__fmul_rn(s0, __fmul_rn(f.x, aq)), bb.x)
                                              : __fadd_rn(s0, bb.x);
                                   v.y = INT8 ? __fadd_rn(__fmul_rn(s1, __fmul_rn(f.y, aq)), bb.y)
                                              : __fadd_rn(s1, bb.y);
                                 }
                                 if constexpr (MINB > 1)
                                   o = *reinterpret_cast<const float2*>(xb + (size_t)l * C + co);
                                 const float2 nv = make_float2(__fadd_rn(o.x, v.x),
                                                               __fadd_rn(o.y, v.y));
                                 *reinterpret_cast<float2*>(xb + (size_t)l * C + co) = nv;
                                 m = fmaxf(m, fmaxf(fabsf(lrelu(nv.x, slope)),
                                                    fabsf(lrelu(nv.y, slope))));
                               });
          }
          w_off += (size_t)k * C * C / M::EPW;
          ++conv;
          // int8: the next conv's scale (the stack's last conv has none)
          synced = INT8 && !(r == N_ROUNDS - 1 && half == 1);
          if (synced) a = window_max<CL>(m, red, slots, peer_slots, rank);
        }
      }
      __syncthreads();  // xb is final for this stack
      // the block's rows within the window's central step rows, and within [0, T)
      const int r_lo = max(lo, left) - lo;
      const int r_hi = min(min(lo + n, left + step), T - g0 + lo) - lo;
      const int n_out = max(r_hi - r_lo, 0) * c4;
      for (int base = threadIdx.x; base < n_out; base += UNR * NT) {
        float4 v[UNR], p[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int idx = base + u * NT;
          if (idx < n_out) {
            const size_t off = (size_t)r_lo * C + (size_t)idx * 4;
            v[u] = *reinterpret_cast<const float4*>(xb + off);
            if (s > 0) p[u] = *reinterpret_cast<const float4*>(obat + (ptrdiff_t)g0 * C + off);
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int idx = base + u * NT;
          if (idx >= n_out) break;
          float4 o = v[u];
          if (s > 0) {
            o = make_float4(__fadd_rn(p[u].x, o.x), __fadd_rn(p[u].y, o.y),
                            __fadd_rn(p[u].z, o.z), __fadd_rn(p[u].w, o.w));
            if (s == N_STACKS - 1) {
              const float three = (float)N_STACKS;
              o = make_float4(__fdiv_rn(o.x, three), __fdiv_rn(o.y, three),
                              __fdiv_rn(o.z, three), __fdiv_rn(o.w, three));
            }
          }
          *reinterpret_cast<float4*>(obat + (ptrdiff_t)g0 * C + (size_t)r_lo * C +
                                     (size_t)idx * 4) = o;
        }
      }
    }
    // the next window's first quantize pass syncs before it writes any operand
  }
}

using Kernel = void (*)(const float*, const uint32_t*, const float*, const float*, float*, float*,
                       ImcolArgs);

template <class M, bool FLAT, int MINB>
Kernel pick_cluster(int cluster) {
  if (cluster == 4) return imcol_kernel<M, 4, FLAT, MINB>;
  if (cluster == 2) return imcol_kernel<M, 2, FLAT, MINB>;
  return imcol_kernel<M, 1, FLAT, MINB>;
}

template <class M, bool FLAT>
Kernel pick_per_sm(int cluster, int per_sm) {
  return per_sm == 2 ? pick_cluster<M, FLAT, 2>(cluster) : pick_cluster<M, FLAT, 1>(cluster);
}

// The kernel of a mode (0 int8, 1 bf16), walk over K, cluster size and
// blocks per SM.
Kernel pick(int mode, int flat, int cluster, int per_sm) {
  if (mode == 0)
    return flat ? pick_per_sm<Int8Mode, true>(cluster, per_sm)
                : pick_per_sm<Int8Mode, false>(cluster, per_sm);
  return flat ? pick_per_sm<Bf16Mode, true>(cluster, per_sm)
              : pick_per_sm<Bf16Mode, false>(cluster, per_sm);
}

cudaError_t configure(Kernel kernel, int cluster, int grid, int smem, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// mode 0 = int8, 1 = bf16.  x, out (B, T, C) f32, 16-byte aligned, C % 4 ==
// 0; w the packed weights of the 18 convs (stack-major, the dilated conv of
// each round before its plain conv), (conv, tap, C_out, C_in / EPW, EPW)
// with EPW = 4 int8 or 2 bf16 input channels per 32-bit word, 16-byte
// aligned; wscale, bias (18, C) f32; step and left the window's output
// samples and left margin (tile * fold, halo * fold); margin the operand's
// rows beyond the block's own on each side, at least (k2 - 1) / 2 * d2;
// wpr the operand's words per row: flat 0 takes C / EPW + 4 rows read by
// ldmatrix (C / EPW % 8 == 0), flat 1 any wpr >= C / EPW; wslots the weight
// buffers (at least 2: a conv whose weight steps they all hold stages them
// once, another stages each step one step ahead in two);
// each window computed by a cluster of `cluster` blocks (1, 2 or 4) that
// split its rows; per_sm the blocks an SM runs at once (1 or 2, the
// kernel's register budget); grid a multiple of cluster; scratch (grid / cluster) * 2 *
// (step + 2 left) * C f32; smem the dynamic shared memory (see
// kernels/imcol.py).  Kernel sizes and dilations must be ascending.
extern "C" int hifigan_imcol(int mode, const void* x, const void* w, const void* wscale,
                             const void* bias, void* out, void* scratch, int B, int T, int C,
                             int k0, int k1, int k2, int d0, int d1, int d2, int step, int left,
                             int margin, int flat, int wpr, int wslots, int cluster, int per_sm,
                             int grid, int smem, float slope, void* stream) {
  ImcolArgs args{B, T, C, step, left, margin, wpr, wslots, {k0, k1, k2}, {d0, d1, d2}, slope};
  const int epw = mode == 0 ? 4 : 2;
  const int n_s = step + 2 * left;
  if ((mode != 0 && mode != 1) || B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || step <= 0 ||
      left < 0 || grid <= 0 || !(cluster == 1 || cluster == 2 || cluster == 4) ||
      !(per_sm == 1 || per_sm == 2) || grid % cluster != 0 || !(k0 <= k1 && k1 <= k2) ||
      !(d0 <= d1 && d1 <= d2) || margin < (k2 - 1) / 2 * d2 || n_s / cluster < margin ||
      wpr < C / epw || (!flat && ((C / epw) % KW != 0 || wpr % 4 != 0)) ||
      (mode == 1 && wpr % 2 != 0) || wslots < 2 ||
      smem < 4 * smem_words(n_s, cluster, margin, wpr, k2, wslots) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wscale) % 16 != 0 || reinterpret_cast<uintptr_t>(bias) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = pick(mode, flat, cluster, per_sm);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, cluster, grid, smem, static_cast<cudaStream_t>(stream),
                              &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  if (cluster == 1) cfg.numAttrs = 0;  // one block: a plain launch
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                           static_cast<const uint32_t*>(w), static_cast<const float*>(wscale),
                           static_cast<const float*>(bias), static_cast<float*>(out),
                           static_cast<float*>(scratch), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks the current device runs at once
// with `smem` bytes of dynamic shared memory a block, at `per_sm` blocks
// an SM at most.
extern "C" int hifigan_imcol_max_clusters(int mode, int flat, int cluster, int per_sm, int smem,
                                          void* n) {
  if ((mode != 0 && mode != 1) || !(cluster == 1 || cluster == 2 || cluster == 4) ||
      !(per_sm == 1 || per_sm == 2))
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = pick(mode, flat, cluster, per_sm);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, cluster, cluster, smem, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(static_cast<int*>(n), kernel, &cfg);
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash attention with Transformer-XL relative position bias, f32 accuracy
// on the tensor cores (split TF32).
//
// Replaces toucan_tpu/kernels/pallas_attention.py::flash_rel_attention
// (the Pallas kernel _flash_kernel).  For each (b, h):
//
//   out = softmax(((q_u . k^T) + rel_shift(q_v . p^T)) / sqrt(d)) . v
//   rel_shift: bias[i, j] = q_v[i] . p[T-1-i+j]
//
// with keys j >= lengths[b] masked out and fully masked rows set to 0;
// padded query rows still attend to the valid keys.
//
// What bounds it on the H100: operations.  At the decoder's T = 2048 and
// d = 48 it does 3 * 2 * T^2 * d flops per head (q_u.k, q_v.p, P.v) on a
// few MB of inputs.  The path is exact f32: the kernel is held to 2e-5
// against its plain version, and one TF32 product (10 mantissa bits) is
// off by ~7e-4 on unit-scale inputs.  So every product runs in split TF32
// ("3xTF32"): each operand x = big + small, big = tf32(x), small =
// tf32(x - big), and a.b = a_s.b_b + a_b.b_s + a_b.b_b summed in f32, which
// misses only a_s.b_s (~2^-22 relative).  Three tensor-core products per
// product give a roof of 495 / 3 = 165 TFLOP/s (against 67 on the f32 CUDA
// cores), all on mma.sync.m16n8k8 TF32.
//
// Layout: one block of 4 warps per (64-row query tile, h, b); each warp
// owns 16 query rows and walks key tiles of BK = 32 with an online softmax
// in f32, so nothing of size T^2 is stored.  Key tiles wholly past
// lengths[b] are skipped (exact).
//  - The rel-pos bias is a small GEMM plus a skewed read, as in the JAX
//    kernel (bd = q_v . p_window^T, then a rel-shift).  Query tile i0 and key
//    tile j0 need the BQ + BK - 1 contiguous rows of p from
//    T - BQ - i0 + j0; a warp's 16 rows need 47 of them, so each warp
//    computes BD = q_v(16 x d) . p_rows(48 x d)^T on the tensor cores.  The
//    skew BD[r, 15 - r + c] crosses the accumulator fragments' thread
//    ownership, so the warp writes BD to its own 16 x 56 slice of shared
//    memory and reads it back skewed (a __syncwarp, no block barrier) as
//    the initial value of the score accumulators, on which q_u . k^T is
//    then summed.
//  - P.v takes the probabilities straight from the score accumulators: a
//    thread holds keys 2t and 2t+1 of its rows, so the A fragment's columns
//    t and t+4 are read as keys 2t and 2t+1, and the B fragment (v) is
//    loaded with the same key permutation.  No shuffle, no shared memory.
//  - K, V and p rows of the next key tile are staged with cp.async (16 B a
//    thread, rows past T or past the table zero-filled) into the second of
//    two buffers while the current tile computes.  q_u and q_v are staged
//    once, and each warp splits its A fragments of them once into registers
//    (16 x d x 2 x 2 values: 96 registers a thread at d = 48), which took
//    19 % off the time at T = 2048.  K, V and p stay f32 in shared memory
//    and are split as each fragment is loaded.
//  - P . V of each key tile is summed in its own accumulators and added to
//    the running output in f32: the tensor cores' accumulation truncates,
//    and one chain over 2048 keys drifted by 2.3e-5, past the tolerance.
//  - Shared memory rows are padded to d + 4 floats (d + 4 = 4 mod 16), so
//    the fragment loads of q, k, p (row g, column t) and of v (row 2t,
//    column g) are free of bank conflicts.
// Shared memory: 2 x 64 (q) + 2 x (32 + 32 + 96) (k, v, p) rows of d + 4
// floats, plus 4 x 16 x 56 floats for BD: 105 KB at d = 48 (two blocks per
// SM, ~225 registers a thread), 133 KB at d = 64 (one).  The decoder at
// B = 1, T = 2048 runs 128 blocks of 4 warps on the 132 SMs.
// Widths: built for d in {16, 32, 48, 64, 96, 128}; the wrapper pads any
// other d <= 128 with zero columns (which change no score) and passes the
// softmax scale 1 / sqrt(d) of the true d.  Past d = 64 the split q
// fragments would not fit in registers, so each key tile splits them from
// shared memory again; at d = 128 the staging buffers would pass 227 KB,
// so there is one, and a tile's loads no longer overlap the one before.
//
// bf16 inputs (flash_rel_attention_bf16).  Under the JAX package's
// dtype=bfloat16 the Pallas kernel takes bf16 q_u, q_v, k, v and p, upcasts
// them to f32 and returns f32 (kernels/pallas_attention.py:67-74); so does
// this instantiation.  A product of two bf16 values is exact in f32, so
// q_u . k^T and q_v . p_window^T need no split: one bf16 mma.sync
// (m16n8k16, f32 sums) each, as the JAX kernel computes them up to the
// order of the sums.  P is f32 (the softmax runs in f32 as in the f32
// kernel), and rounding it to bf16 would part from JAX by 2^-9 of each
// probability.  P . V takes P as its bf16 high and low parts, P = hi + lo
// + r with |r| <= 2^-18 |P|, in two bf16 products on the bf16 V, which is
// exact; this rather than the split-TF32 P . V on an upcast V because the
// score accumulators of two 8-key tiles are the m16n8k16 A fragment as they
// lie (no permutation), and two bf16 products of k = 16 cost a quarter of
// the tensor-core time of two TF32 products of k = 8 over the same keys.
// Staged rows are d + 8 bf16 (d / 2 + 4 words: conflict-free fragment
// loads), half the f32 kernel's bytes, so two staging buffers fit at every
// d; the q fragments are read from shared memory at each tile (one 32-bit
// load per register, no split to keep).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per tile
constexpr int NW = 4;             // warps per block, 16 query rows each
constexpr int NT = 32 * NW;
constexpr int NPW = BQ + BK;      // p rows staged per key tile (BQ + BK - 1 used)
constexpr int BDC = BK + 16;      // BD columns per warp (BK + 15 used)
constexpr int BDP = BDC + 8;      // padded BD row

template <int D>
__host__ __device__ constexpr int dp() { return D + 4; }

// Up to d = 64 each warp keeps its split q fragments in registers; wider
// heads would spill them, so they are split from shared memory per tile.
template <int D>
__host__ __device__ constexpr bool q_in_registers() { return D <= 64; }

// K, V and p staging buffers: two (loads overlap compute) where they fit
// in the 227 KB of shared memory, else one (d = 128).
template <int D>
__host__ __device__ constexpr int n_buffers() {
  return (size_t)(2 * BQ + 2 * (2 * BK + NPW)) * dp<D>() + (size_t)NW * 16 * BDP <= 232448 / 4
             ? 2
             : 1;
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)2 * BQ * dp<D>() + n_buffers<D>() * (size_t)(2 * BK + NPW) * dp<D>() +
         (size_t)NW * 16 * BDP;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small, both TF32 (round to nearest)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in split TF32: small terms first, then big . big
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// A fragment (16 x 8, row major) of rows r0.., columns k0.. of a staged
// matrix with row stride ld
__device__ __forceinline__ void load_a(const float* s, int ld, int r0, int k0, int g, int t,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split_tf32(s[(r0 + g) * ld + k0 + t], ab[0], as[0]);
  split_tf32(s[(r0 + g + 8) * ld + k0 + t], ab[1], as[1]);
  split_tf32(s[(r0 + g) * ld + k0 + t + 4], ab[2], as[2]);
  split_tf32(s[(r0 + g + 8) * ld + k0 + t + 4], ab[3], as[3]);
}

// B fragment (8 x 8, column major) of b[k][n] = s[n0 + n][k0 + k]
__device__ __forceinline__ void load_bt(const float* s, int ld, int n0, int k0, int g, int t,
                                        uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  split_tf32(s[(n0 + g) * ld + k0 + t], bb[0], bs[0]);
  split_tf32(s[(n0 + g) * ld + k0 + t + 4], bb[1], bs[1]);
}

// Stage rows [r0, r0 + n) of a (rows x D) matrix of E into s (row stride
// LD elements); rows outside [0, rows) are zero-filled.
template <int D, int LD, typename E>
__device__ __forceinline__ void stage_rows(E* s, const E* g, int r0, int n, int rows) {
  constexpr int EPC = 16 / sizeof(E);  // elements per 16-byte chunk
  constexpr int CH = D / EPC;          // chunks per row
  for (int idx = threadIdx.x; idx < n * CH; idx += NT) {
    const int r = idx / CH, c = (idx - r * CH) * EPC;
    const int gr = r0 + r;
    const bool ok = gr >= 0 && gr < rows;
    cp_async16(s + r * LD + c, g + (size_t)(ok ? gr : 0) * D + c, ok);
  }
}

// The online softmax over one key tile's scores sc (rows g: e = 0, 1; g + 8:
// e = 2, 3; key j0 + n * 8 + 2t + (e & 1)): masks keys >= len, scales, and
// leaves exp(s - m) in sc, the running maxima in m_row, the running sums of
// the thread's keys in l_part, and the factor for the output so far in alpha.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&sc)[NS][4], int j0, int t, int len,
                                               float scale, float (&m_row)[2],
                                               float (&l_part)[2], float (&alpha)[2]) {
  float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + n * 8 + 2 * t + (e & 1);
      const float s = j < len ? sc[n][e] * scale : -INFINITY;
      sc[n][e] = s;
      rmax[e >> 1] = fmaxf(rmax[e >> 1], s);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
    rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
    // key j0 < len is valid, so the row maximum and m_new are finite
    const float m_new = fmaxf(m_row[r], rmax[r]);
    alpha[r] = expf(m_row[r] - m_new);
    m_row[r] = m_new;
    l_part[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = expf(sc[n][e] - m_row[e >> 1]);
      sc[n][e] = pe;
      l_part[e >> 1] += pe;
    }
}

// The warp's 16 output rows from row0 on, o / l; rows past T are left out.
template <int D>
__device__ __forceinline__ void write_rows(float* o_bh, const float (&o)[D / 8][4],
                                           float (&l_part)[2], int row0, int g, int t, int T) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gi = row0 + g + 8 * r;
    if (gi < T) {
      const float inv = l_part[r] > 0.f ? 1.f / l_part[r] : 0.f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(o_bh + (size_t)gi * D + n * 8 + 2 * t) =
            make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_rel_kernel(
    const float* __restrict__ qu, const float* __restrict__ qv,
    const float* __restrict__ kg, const float* __restrict__ vg,
    const float* __restrict__ pg, const int* __restrict__ lengths,
    float* __restrict__ out, int H, int T, float scale) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int DP = dp<D>();
  constexpr int KD = D / 8;   // k-steps over the head dim
  constexpr int NO = D / 8;   // n-tiles of the output
  constexpr int NS = BK / 8;  // n-tiles of the score tile
  constexpr int NB = BDC / 8; // n-tiles of BD
  constexpr int STAGE = (2 * BK + NPW) * DP;
  constexpr int NBUF = n_buffers<D>();
  constexpr bool QREG = q_in_registers<D>();
  constexpr int KQ = QREG ? KD : 1;

  extern __shared__ float4 smem4[];
  float* s_qu = reinterpret_cast<float*>(smem4);
  float* s_qv = s_qu + BQ * DP;
  float* s_stage = s_qv + BQ * DP;
  float* s_bd_all = s_stage + NBUF * STAGE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * D;
  const float* p_h = pg + (size_t)h * (2 * T - 1) * D;
  float* s_bd = s_bd_all + warp * 16 * BDP;
  const int rw = warp * 16;          // the warp's first query row in the tile
  const int pb = BQ - 16 - rw;       // the warp's first p row in the staged window
  const int len = min(max(lengths[b], 0), T);
  const int n_kt = (len + BK - 1) / BK;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};
  uint32_t qub[KQ][4], qus[KQ][4], qvb[KQ][4], qvs[KQ][4];  // split q fragments (QREG)

  auto stage_tile = [&](int kt) {
    float* s = s_stage + (kt % NBUF) * STAGE;
    const int j0 = kt * BK;
    stage_rows<D, DP>(s, kg + base, j0, BK, T);
    stage_rows<D, DP>(s + BK * DP, vg + base, j0, BK, T);
    stage_rows<D, DP>(s + 2 * BK * DP, p_h, T - BQ - i0 + j0, NPW, 2 * T - 1);
  };

  if (n_kt > 0) {
    stage_rows<D, DP>(s_qu, qu + base, i0, BQ, T);
    stage_rows<D, DP>(s_qv, qv + base, i0, BQ, T);
    stage_tile(0);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    if constexpr (NBUF == 1) {
      if (kt > 0) {  // the barrier closing tile kt - 1 freed the buffer
        stage_tile(kt);
        cp_async_commit();
      }
      cp_async_wait<0>();
    } else if (kt + 1 < n_kt) {
      stage_tile(kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_k = s_stage + (kt % NBUF) * STAGE;
    const float* s_v = s_k + BK * DP;
    const float* s_p = s_v + BK * DP;
    if (QREG && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        load_a(s_qu, DP, rw, kk * 8, g, t, qub[kk], qus[kk]);
        load_a(s_qv, DP, rw, kk * 8, g, t, qvb[kk], qvs[kk]);
      }
    }

    // BD = q_v . p_rows^T for the warp's 16 rows and p rows pb .. pb + 47
    float bd[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) bd[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ab[e] = qvb[kk][e], as[e] = qvs[kk][e];
      } else {
        load_a(s_qv, DP, rw, kk * 8, g, t, ab, as);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t bb[2], bs[2];
        load_bt(s_p, DP, pb + n * 8, kk * 8, g, t, bb, bs);
        mma3(bd[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      *reinterpret_cast<float2*>(s_bd + g * BDP + n * 8 + 2 * t) = make_float2(bd[n][0], bd[n][1]);
      *reinterpret_cast<float2*>(s_bd + (g + 8) * BDP + n * 8 + 2 * t) =
          make_float2(bd[n][2], bd[n][3]);
    }
    __syncwarp();

    // scores start from the skewed bias: S[r, c] = BD[r, 15 - r + c]
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c = n * 8 + 2 * t;
      sc[n][0] = s_bd[g * BDP + 15 - g + c];
      sc[n][1] = s_bd[g * BDP + 16 - g + c];
      sc[n][2] = s_bd[(g + 8) * BDP + 7 - g + c];
      sc[n][3] = s_bd[(g + 8) * BDP + 8 - g + c];
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ab[e] = qub[kk][e], as[e] = qus[kk][e];
      } else {
        load_a(s_qu, DP, rw, kk * 8, g, t, ab, as);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bb[2], bs[2];
        load_bt(s_k, DP, n * 8, kk * 8, g, t, bb, bs);
        mma3(sc[n], ab, as, bb, bs);
      }
    }

    // online softmax over this tile's keys
    float alpha[2];
    online_softmax<NS>(sc, kt * BK, t, len, scale, m_row, l_part, alpha);

    // O = alpha O + P . V; A column t is key 2t and column t + 4 is key
    // 2t + 1; the tile's P . V is summed apart, then added in f32
    float pv[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NS; ++kc) {
      uint32_t ab[4], as[4];
      split_tf32(sc[kc][0], ab[0], as[0]);
      split_tf32(sc[kc][2], ab[1], as[1]);
      split_tf32(sc[kc][1], ab[2], as[2]);
      split_tf32(sc[kc][3], ab[3], as[3]);
      const float* v0 = s_v + (kc * 8 + 2 * t) * DP + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bb[2], bs[2];
        split_tf32(v0[n * 8], bb[0], bs[0]);
        split_tf32(v0[DP + n * 8], bb[1], bs[1]);
        mma3(pv[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * alpha[e >> 1] + pv[n][e];
    __syncthreads();  // this buffer is restaged two tiles on
  }

  write_rows<D>(out + base, o, l_part, i0 + rw, g, t, T);
}

template <int D>
cudaError_t launch(const float* qu, const float* qv, const float* k, const float* v,
                   const float* p, const int* lengths, float* out, int B, int H, int T,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_rel_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_rel_kernel<D><<<grid, NT, smem, stream>>>(qu, qv, k, v, p, lengths, out, H, T, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 inputs

// x = hi + lo, both bf16 (round to nearest), for a pair of values (low half:
// the first); the pair's hi and lo parts packed as one A-fragment register each
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
  hi = (uint32_t)__bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  lo = (uint32_t)__bfloat16_as_ushort(l0) | ((uint32_t)__bfloat16_as_ushort(l1) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* s) {
  return *reinterpret_cast<const uint32_t*>(s);
}

// A fragment (16 x 16, row major) of rows r0.., columns k0.. of a staged
// bf16 matrix with row stride ld
__device__ __forceinline__ void load_a16(const uint16_t* s, int ld, int r0, int k0, int g, int t,
                                         uint32_t (&a)[4]) {
  a[0] = ld_pair(s + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld_pair(s + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld_pair(s + (r0 + g) * ld + k0 + 2 * t + 8);
  a[3] = ld_pair(s + (r0 + g + 8) * ld + k0 + 2 * t + 8);
}

// B fragment (16 x 8, column major) of b[k][n] = s[n0 + n][k0 + k]
__device__ __forceinline__ void load_bt16(const uint16_t* s, int ld, int n0, int k0, int g,
                                          int t, uint32_t (&b)[2]) {
  b[0] = ld_pair(s + (n0 + g) * ld + k0 + 2 * t);
  b[1] = ld_pair(s + (n0 + g) * ld + k0 + 2 * t + 8);
}

// bf16 elements per staged row: d + 8, so that a fragment's 32 lanes read
// 32 distinct banks (the row is (d + 8) / 2 = 4 mod 8 words)
template <int D>
__host__ __device__ constexpr int dpb() { return D + 8; }

template <int D>
constexpr size_t smem_bytes_bf16() {
  return (size_t)NW * 16 * BDP * sizeof(float) +
         ((size_t)2 * BQ + 2 * (size_t)(2 * BK + NPW)) * dpb<D>() * sizeof(uint16_t);
}

// The f32 kernel's tiling, softmax and rel-shift, on bf16 operands: q_u . k^T
// and q_v . p^T as bf16 products (m16n8k16, f32 sums), P . V as two bf16
// products of P's high and low parts (see the header).
template <int D>
__global__ void __launch_bounds__(NT) flash_rel_bf16_kernel(
    const uint16_t* __restrict__ qu, const uint16_t* __restrict__ qv,
    const uint16_t* __restrict__ kg, const uint16_t* __restrict__ vg,
    const uint16_t* __restrict__ pg, const int* __restrict__ lengths,
    float* __restrict__ out, int H, int T, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = dpb<D>();
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-tiles of the output
  constexpr int NS = BK / 8;  // n-tiles of the score tile
  constexpr int NB = BDC / 8; // n-tiles of BD
  constexpr int STAGE = (2 * BK + NPW) * LD;

  extern __shared__ float4 smem4[];
  float* s_bd_all = reinterpret_cast<float*>(smem4);
  uint16_t* s_qu = reinterpret_cast<uint16_t*>(s_bd_all + NW * 16 * BDP);
  uint16_t* s_qv = s_qu + BQ * LD;
  uint16_t* s_stage = s_qv + BQ * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * D;
  const uint16_t* p_h = pg + (size_t)h * (2 * T - 1) * D;
  float* s_bd = s_bd_all + warp * 16 * BDP;
  const int rw = warp * 16;
  const int pb = BQ - 16 - rw;
  const int len = min(max(lengths[b], 0), T);
  const int n_kt = (len + BK - 1) / BK;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};

  auto stage_tile = [&](int kt) {
    uint16_t* s = s_stage + (kt & 1) * STAGE;
    const int j0 = kt * BK;
    stage_rows<D, LD>(s, kg + base, j0, BK, T);
    stage_rows<D, LD>(s + BK * LD, vg + base, j0, BK, T);
    stage_rows<D, LD>(s + 2 * BK * LD, p_h, T - BQ - i0 + j0, NPW, 2 * T - 1);
  };

  if (n_kt > 0) {
    stage_rows<D, LD>(s_qu, qu + base, i0, BQ, T);
    stage_rows<D, LD>(s_qv, qv + base, i0, BQ, T);
    stage_tile(0);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      stage_tile(kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* s_k = s_stage + (kt & 1) * STAGE;
    const uint16_t* s_v = s_k + BK * LD;
    const uint16_t* s_p = s_v + BK * LD;

    // BD = q_v . p_rows^T for the warp's 16 rows and p rows pb .. pb + 47
    float bd[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) bd[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      load_a16(s_qv, LD, rw, kk * 16, g, t, a);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t bb[2];
        load_bt16(s_p, LD, pb + n * 8, kk * 16, g, t, bb);
        mma_bf16(bd[n], a, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      *reinterpret_cast<float2*>(s_bd + g * BDP + n * 8 + 2 * t) = make_float2(bd[n][0], bd[n][1]);
      *reinterpret_cast<float2*>(s_bd + (g + 8) * BDP + n * 8 + 2 * t) =
          make_float2(bd[n][2], bd[n][3]);
    }
    __syncwarp();

    // scores start from the skewed bias: S[r, c] = BD[r, 15 - r + c]
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c = n * 8 + 2 * t;
      sc[n][0] = s_bd[g * BDP + 15 - g + c];
      sc[n][1] = s_bd[g * BDP + 16 - g + c];
      sc[n][2] = s_bd[(g + 8) * BDP + 7 - g + c];
      sc[n][3] = s_bd[(g + 8) * BDP + 8 - g + c];
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      load_a16(s_qu, LD, rw, kk * 16, g, t, a);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bb[2];
        load_bt16(s_k, LD, n * 8, kk * 16, g, t, bb);
        mma_bf16(sc[n], a, bb);
      }
    }

    float alpha[2];
    online_softmax<NS>(sc, kt * BK, t, len, scale, m_row, l_part, alpha);

    // O = alpha O + P . V over k-steps of 16 keys: the score fragments of
    // key tiles 2kc and 2kc + 1 are the A fragment as they lie; P goes in
    // as its bf16 high and low parts, low first; the tile's P . V is summed
    // apart, then added in f32
    float pv[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      uint32_t ah[4], al[4];
      split_bf16(sc[2 * kc][0], sc[2 * kc][1], ah[0], al[0]);
      split_bf16(sc[2 * kc][2], sc[2 * kc][3], ah[1], al[1]);
      split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ah[2], al[2]);
      split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ah[3], al[3]);
      const uint16_t* v0 = s_v + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bb[2];
        bb[0] = (uint32_t)v0[n * 8] | ((uint32_t)v0[LD + n * 8] << 16);
        bb[1] = (uint32_t)v0[8 * LD + n * 8] | ((uint32_t)v0[9 * LD + n * 8] << 16);
        mma_bf16(pv[n], al, bb);
        mma_bf16(pv[n], ah, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * alpha[e >> 1] + pv[n][e];
    __syncthreads();  // this buffer is restaged two tiles on
  }

  write_rows<D>(out + base, o, l_part, i0 + rw, g, t, T);
}

template <int D>
cudaError_t launch_bf16(const uint16_t* qu, const uint16_t* qv, const uint16_t* k,
                        const uint16_t* v, const uint16_t* p, const int* lengths, float* out,
                        int B, int H, int T, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_rel_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_rel_bf16_kernel<D><<<grid, NT, smem, stream>>>(qu, qv, k, v, p, lengths, out, H, T,
                                                       scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_rel_attention_f32(const void* qu, const void* qv, const void* k,
                                       const void* v, const void* p, const void* lengths,
                                       void* out, int B, int H, int T, int D, float scale,
                                       void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(qu);
  const auto* b = static_cast<const float*>(qv);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* pp = static_cast<const float*>(p);
  const auto* ll = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 32: return (int)launch<32>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 48: return (int)launch<48>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 64: return (int)launch<64>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 96: return (int)launch<96>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 128: return (int)launch<128>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q_u, q_v, k, v (B, H, T, D) and p (H, 2T - 1, D) bf16; out (B, H, T, D) f32.
extern "C" int flash_rel_attention_bf16(const void* qu, const void* qv, const void* k,
                                        const void* v, const void* p, const void* lengths,
                                        void* out, int B, int H, int T, int D, float scale,
                                        void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const uint16_t*>(qu);
  const auto* b = static_cast<const uint16_t*>(qv);
  const auto* kk = static_cast<const uint16_t*>(k);
  const auto* vv = static_cast<const uint16_t*>(v);
  const auto* pp = static_cast<const uint16_t*>(p);
  const auto* ll = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_bf16<16>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 32: return (int)launch_bf16<32>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 48: return (int)launch_bf16<48>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 64: return (int)launch_bf16<64>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 96: return (int)launch_bf16<96>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    case 128: return (int)launch_bf16<128>(a, b, kk, vv, pp, ll, o, B, H, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

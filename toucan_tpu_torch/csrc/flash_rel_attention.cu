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
// this kernel, written for Hopper's warpgroup tensor-core path.  A product of
// two bf16 values is exact in f32, so q_u . k^T and q_v . p^T are single
// bf16 products with f32 sums.  What bounds it: operations.  The work is
// three products of 2 T len d flops a head (q_u.k, q_v.p, P.v); at T = 2048,
// d = 48 that is ~8 GFLOP for B = 2 against ~6 MB of inputs, 0.008 ms at
// 989 TFLOP/s.  The kernel issues 4.25 such products: the rel-pos window
// costs 1.25 of q_u.k (below) and P.V runs twice (P's two parts).
//
// Layout: a block is one warpgroup (4 warps, 64 query rows: wgmma's m64),
// two blocks an SM up to d = 64.  Key tiles are BK = 64.
//  - Thread 0 issues TMA loads (128-byte swizzle, rows and columns past the
//    tensor zero-filled by the hardware) into rings guarded by mbarriers:
//    q_u and q_v once, then per key tile K and V into a ring of three
//    stages and the rel-pos rows in chunks of 64 into a ring of three.  Query tile
//    i0 and key tile j0 need the 127 rows of p from T - 64 - i0 + j0: chunk
//    c holds the 64 rows from T - 64 - i0 + 64 c, so key tile kt reads
//    chunks kt and kt + 1 and each tile loads one new chunk.  A slot is
//    refilled as soon as every warp has released it.  A fifth, producer
//    warp was tried first and measured slower: it leaves one SM partition
//    three warps, so two blocks an SM get 168 registers a thread, and ptxas
//    then serialised the wgmma pipeline below or spilled; without it the
//    kernel keeps 228 registers at d = 48 and spills nothing.
//  - S = q_u . k^T is wgmma m64n64k16 with both operands read from shared
//    memory through descriptors (K-major, 128-byte swizzle).
//  - The rel-pos bias: wgmma's accumulator gives each warp 16 rows in the
//    m16n8 fragment layout, and those 16 rows need only BK + 15 rows of p.
//    So each warp computes its strip BD = q_v(16 x d) . p_rows(80 x d)^T on
//    mma.sync m16n8k16, its q_v fragments kept in registers (d <= 64) and
//    the p fragments read by ldmatrix from the swizzled chunks; it writes BD
//    to its own slice of shared memory and reads it back skewed,
//    S[r, c] = BD[r, 15 - r + c] (a warp barrier, no block barrier), as the
//    initial accumulator onto which the wgmma sums q_u . k^T.  The bias as
//    wgmma over the block's 64-row window (2 BK - 1 rows of p: 2.0 of q_u.k
//    instead of 1.25) was tried and measured slower: the tensor cores, not
//    the warps' instruction issue, set the pace.
//  - The online softmax runs in f32 in the log2 domain (scores times
//    log2(e) / sqrt(d), ex2).  P . V takes P from registers (wgmma's
//    register-A form) as its bf16 high and low parts, P = hi + lo + r with
//    |r| <= 2^-18 |P|: one bf16 P would round each probability by 2^-9,
//    ~1e-3 on unit-scale V, fifty times the kernel's 2e-5 tolerance.  V is
//    the B operand read from the same swizzled tile through the
//    descriptor's transpose bit (MN-major).  Each tile's P . V is summed in
//    its own accumulators and added to the running output in f32: the
//    tensor cores' accumulation truncates, and one chain over 2048 keys
//    drifted past the tolerance.
//  - The steps of a tile are pipelined: the bias and q_u . k^T of tile i
//    are computed while tile i - 1's P . V is in flight.
//  - Split key ranges.  Where the grid of query tiles, B H ceil(T / 64), is
//    under twice the SM count, the wrapper may give each query tile several
//    splits of consecutive key tiles, chosen from the shapes alone
//    (kernels/flash_attention.py::bf16_geometry; lengths is never read on
//    the host, so a CUDA graph can hold the call).  Each split writes its
//    rows' maximum, sum and unnormalised output in f32 to scratch, and a
//    second small kernel rescales and adds them; a split wholly past
//    lengths[b] writes (-inf, 0, 0), which adds nothing.  Splits cost a
//    combine and a second wave of blocks, so the rule takes the count whose
//    waves of resident blocks finish first: the decoder at B = 1, T = 2048
//    runs 2 splits, 256 blocks; the encoder at T = 128 and B = 2, T = 2048
//    one (scripts/k1_bf16_variants.py times every count).
//  - Key tiles wholly past lengths[b] are skipped (exact).
// Shared memory holds 64-column swizzle rows (d < 64 zero-filled, d > 64 in
// two): 111 KB at d <= 64 (two blocks an SM), 199 KB at d = 96 and 128.

#include <cuda.h>
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

// x0 and x1 rounded to bf16 and packed (x0 in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// x = hi + lo, both bf16 (round to nearest), for a pair of values (low half:
// the first); the pair's hi and lo parts packed as one A-fragment register each
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

namespace bf16 {

constexpr int BQ = 64;                  // query rows per block: wgmma's m64
constexpr int BK = 64;                  // keys per tile
constexpr int NKV = 3;                  // K/V ring stages
constexpr int NP = 3;                   // p chunk ring slots
constexpr int THREADS = 128;            // one warpgroup
constexpr int BDC = BK + 16;            // BD columns per warp strip (BK + 15 used)
constexpr int BDP = BDC + 8;            // padded BD row, floats
constexpr int SW_COLS = 64;             // bf16 columns of one 128-byte swizzle row
constexpr int TILE_BYTES = 64 * 128;    // 64 rows of one swizzle column block
constexpr int N_BAR = 1 + 2 * NKV + 2 * NP;
// a wait longer than this (~4 s) means a broken pipeline: trap, do not hang
constexpr long long WAIT_LIMIT = 1ll << 33;

// Shared memory, from a 1024-byte aligned base: q_u, q_v, the K and V ring,
// the p ring (each a region of 64 rows x d, as 128-byte swizzle rows in
// column blocks of 64), the warps' BD slices and the mbarriers.
template <int D>
struct Smem {
  static constexpr int BLOCKS = (D + SW_COLS - 1) / SW_COLS;
  static constexpr int R = BLOCKS * TILE_BYTES;
  static constexpr int QU = 0, QV = R, K = 2 * R, V = K + NKV * R, P = V + NKV * R;
  static constexpr int BD = P + NP * R;
  static constexpr int BAR = BD + 4 * 16 * BDP * 4;
  static constexpr int BYTES = BAR + 8 * N_BAR + 1024;  // + the alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > WAIT_LIMIT) __trap();
  }
}

// rows [row, row + 64) of plane z, every column block, into a region
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int z) {
#pragma unroll
  for (int c = 0; c < Smem<D>::BLOCKS; ++c)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst + c * TILE_BYTES),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c * SW_COLS), "r"(row), "r"(z)
        : "memory");
}

// byte address of (row, col) in a region of 128-byte swizzle rows; col a
// multiple of 8 (one 16-byte chunk)
__device__ __forceinline__ uint32_t swz(uint32_t region, int row, int col) {
  return region + (col >> 6) * TILE_BYTES + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers across
// the fence, commit and wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma wrappers, one per instruction shape: d are the accumulators in
// order; ss: A and B from shared memory, both K-major; rs: A from registers
// (K-major), B from shared memory MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 48) wgmma_rs_n48(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 96) wgmma_rs_n96(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// One block: query tile blockIdx.x / splits, key split blockIdx.x % splits,
// head blockIdx.y, batch blockIdx.z.  With one split it writes the
// normalised output; with several, the split's unnormalised rows to
// out[split] and their (maximum, sum) in the log2 domain to part_ml.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1) flash_rel_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_qu, const __grid_constant__ CUtensorMap tm_qv,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_p, const int* __restrict__ lengths,
    float* __restrict__ out, float2* __restrict__ part_ml, int H, int T, int splits,
    int tiles_per_split, float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16, at most 128");
  using L = Smem<D>;
  constexpr int KD = D / 16;        // k-steps over the head dim
  constexpr int NB = BDC / 8;       // n-tiles of a warp's BD strip
  constexpr bool QREG = D <= 64;    // q_v fragments kept in registers
  constexpr uint32_t TILE_TX = L::BLOCKS * TILE_BYTES;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + L::BAR;
  auto q_full = [&]() { return bars; };
  auto kv_full = [&](int s) { return bars + 8 * (1 + s); };
  auto kv_empty = [&](int s) { return bars + 8 * (1 + NKV + s); };
  auto p_full = [&](int s) { return bars + 8 * (1 + 2 * NKV + s); };
  auto p_empty = [&](int s) { return bars + 8 * (1 + 2 * NKV + NP + s); };

  const int qt = blockIdx.x / splits;
  const int split = blockIdx.x - qt * splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int i0 = qt * BQ;
  const int len = min(max(lengths[b], 0), T);
  const int kt0 = split * tiles_per_split;
  const int n = max(min(kt0 + tiles_per_split, (len + BK - 1) / BK) - kt0, 0);
  const int p0 = T - BQ - i0;  // first p row of chunk 0

  if (threadIdx.x == 0) {
    mbar_init(q_full(), 1);
    for (int s = 0; s < NKV; ++s) mbar_init(kv_full(s), 1), mbar_init(kv_empty(s), THREADS);
    for (int s = 0; s < NP; ++s) mbar_init(p_full(s), 1), mbar_init(p_empty(s), THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues every load: here the first ones, then each refill as a
  // slot is freed (in steps A and B below)
  auto load_chunk = [&](int c) {  // chunk kt0 + c into its ring slot
    mbar_expect_tx(p_full(c % NP), TILE_TX);
    tma_rows<D>(base + L::P + (c % NP) * L::R, &tm_p, p_full(c % NP), p0 + BK * (kt0 + c), h);
  };
  auto load_kv = [&](int i) {  // tile kt0 + i's K and V into their ring slot
    const int s = i % NKV;
    mbar_expect_tx(kv_full(s), 2 * TILE_TX);
    tma_rows<D>(base + L::K + s * L::R, &tm_k, kv_full(s), BK * (kt0 + i), bh);
    tma_rows<D>(base + L::V + s * L::R, &tm_v, kv_full(s), BK * (kt0 + i), bh);
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(q_full(), 2 * TILE_TX);
    tma_rows<D>(base + L::QU, &tm_qu, q_full(), i0, bh);
    tma_rows<D>(base + L::QV, &tm_qv, q_full(), i0, bh);
    for (int c = 0; c <= min(n, NP - 1); ++c) load_chunk(c);
    for (int i = 0; i < min(n, NKV); ++i) load_kv(i);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  float* s_bd = reinterpret_cast<float*>(smem_raw + (base - raw) + L::BD) + warp * 16 * BDP;

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};

  // Each tile in three steps, A, B and C below, pipelined so that the tensor
  // cores run tile i - 1's P . V while the warps compute tile i's bias:
  // A(i), B(i - 1), C(i).
  if (n > 0) {
    mbar_wait(q_full(), 0);
    uint32_t qv[QREG ? KD : 1][4];
    if constexpr (QREG) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(swz(base + L::QV, 16 * warp + (lane & 15), kk * 16 + (lane >> 4) * 8), qv[kk]);
    }
    mbar_wait(p_full(0), 0);
    float s[32], pv[D / 2], alpha[2];
    uint32_t ph[4][4], pl[4][4];

    // A: tile i's scores: the skewed bias, then q_u . k^T issued
    auto step_a = [&](int i) {
      mbar_wait(p_full((i + 1) % NP), ((i + 1) / NP) & 1);
      const uint32_t chunk_a = base + L::P + (i % NP) * L::R;
      const uint32_t chunk_b = base + L::P + ((i + 1) % NP) * L::R;

      // BD = q_v . p_rows^T for the warp's 16 rows and the 80 rows of the
      // two chunks from 48 - 16 warp on (each 16 in one chunk)
      float bd[NB][4];
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) bd[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qv[kk][e];
        } else {
          ldsm_x4(swz(base + L::QV, 16 * warp + (lane & 15), kk * 16 + (lane >> 4) * 8), a);
        }
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          const int r = 48 - 16 * warp + 16 * np;
          uint32_t f[4];
          ldsm_x4(swz(r < BK ? chunk_a : chunk_b,
                      (r & (BK - 1)) + (lane & 7) + ((lane >> 4) << 3),
                      kk * 16 + ((lane >> 3) & 1) * 8),
                  f);
          const uint32_t b0[2] = {f[0], f[1]}, b1[2] = {f[2], f[3]};
          mma_bf16(bd[2 * np], a, b0);
          mma_bf16(bd[2 * np + 1], a, b1);
        }
      }
      mbar_arrive(p_empty(i % NP));  // chunk kt0 + i's last reader was this tile

      __syncwarp();  // the previous tile's skewed reads are done
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        *reinterpret_cast<float2*>(s_bd + g * BDP + nt * 8 + 2 * t) =
            make_float2(bd[nt][0], bd[nt][1]);
        *reinterpret_cast<float2*>(s_bd + (g + 8) * BDP + nt * 8 + 2 * t) =
            make_float2(bd[nt][2], bd[nt][3]);
      }
      __syncwarp();

      // scores start from the skewed bias: S[r, c] = BD[r, 15 - r + c],
      // in the accumulator layout (rows g and g + 8, columns 8 n + 2 t + e)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = c * 8 + 2 * t;
        s[4 * c + 0] = s_bd[g * BDP + 15 - g + col];
        s[4 * c + 1] = s_bd[g * BDP + 16 - g + col];
        s[4 * c + 2] = s_bd[(g + 8) * BDP + 7 - g + col];
        s[4 * c + 3] = s_bd[(g + 8) * BDP + 8 - g + col];
      }

      // S += q_u . k^T on wgmma, left in flight
      mbar_wait(kv_full(i % NKV), (i / NKV) & 1);
      const uint32_t s_k = base + L::K + (i % NKV) * L::R;
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
        wgmma_ss_n64(s, desc_sw128(base + L::QU + off, 16, 1024),
                     desc_sw128(s_k + off, 16, 1024));
      }
      wg_commit();
      // every warp's bias has read chunk kt0 + i: its slot takes chunk i + NP
      if (threadIdx.x == 0 && i + NP <= n) {
        mbar_wait(p_empty(i % NP), (i / NP) & 1);
        load_chunk(i + NP);
      }
      __syncwarp();
    };
    // B: tile i's P . V done: added to the output, its K and V freed
    auto step_b = [&](int i, bool last) {
      if (last) wg_wait<0>();
      else wg_wait<1>();  // the older group, tile i's P . V
      reg_fence(pv);
      mbar_arrive(kv_empty(i % NKV));
      if (threadIdx.x == 0 && i + NKV < n) {  // every warp's P . V is done: refill
        mbar_wait(kv_empty(i % NKV), (i / NKV) & 1);
        load_kv(i + NKV);
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = o[e] * alpha[(e >> 1) & 1] + pv[e];
    };
    // C: the softmax of tile i, then its P . V issued
    auto step_c = [&](int i) {
      wg_wait<0>();
      reg_fence(s);
      // online softmax in the log2 domain: p = 2^(s c - m) with c =
      // log2(e) / sqrt(d) and m the running maximum of s c; key (kt0 + i)
      // * BK < len is valid, so each row's maximum is finite
      const int j0 = (kt0 + i) * BK;
      if (j0 + BK > len) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (j0 + (e >> 2) * 8 + 2 * t + (e & 1) >= len) s[e] = -INFINITY;
      }
      // the row maxima and sums as trees of four partial values (short
      // dependency chains)
      float mq[2][4], lq[2][4];
#pragma unroll
      for (int e = 0; e < 8; ++e) mq[(e >> 1) & 1][((e >> 2) << 1) | (e & 1)] = s[e];
#pragma unroll
      for (int e = 8; e < 32; ++e)
        mq[(e >> 1) & 1][(e & 1) | ((e >> 2) & 1) << 1] =
            fmaxf(mq[(e >> 1) & 1][(e & 1) | ((e >> 2) & 1) << 1], s[e]);
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(fmaxf(mq[r][0], mq[r][1]), fmaxf(mq[r][2], mq[r][3]));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_row[r], mx[r] * scale_log2);
        alpha[r] = ex2(m_row[r] - m_new);
        m_row[r] = m_new;
        l_part[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = ex2(fmaf(s[e], scale_log2, -m_row[(e >> 1) & 1]));
        const int q = (e & 1) | ((e >> 2) & 1) << 1;
        lq[(e >> 1) & 1][q] = e < 8 ? s[e] : lq[(e >> 1) & 1][q] + s[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_part[r] += (lq[r][0] + lq[r][1]) + (lq[r][2] + lq[r][3]);

      // P as its bf16 high and low parts, in wgmma's A fragments: keys
      // 16 kk .. 16 kk + 15 are accumulator columns 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e], pl[kk][e]);

      // the tile's P . V, low parts first, summed apart; V MN-major
      const uint32_t s_v = base + L::V + (i % NKV) * L::R;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) pv[e] = 0.f;
      reg_fence(pv);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc_sw128(s_v + kk * 16 * 128, TILE_BYTES, 1024);
        wgmma_pv<D>(pv, pl[kk], dv);
        wgmma_pv<D>(pv, ph[kk], dv);
      }
      wg_commit();
    };

    step_a(0);
    step_c(0);
    for (int i = 1; i < n; ++i) {
      step_a(i);
      step_b(i - 1, false);
      step_c(i);
    }
    step_b(n - 1, true);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
  }
  const size_t planes = (size_t)gridDim.z * H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gi = i0 + 16 * warp + g + 8 * r;
    if (gi >= T) continue;
    const float inv = splits > 1 ? 1.f : (l_part[r] > 0.f ? 1.f / l_part[r] : 0.f);
    float* row = out + (((size_t)split * planes + bh) * T + gi) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(row + c * 8 + 2 * t) =
          make_float2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
    if (splits > 1 && t == 0)
      part_ml[((size_t)split * planes + bh) * T + gi] = make_float2(m_row[r], l_part[r]);
  }
}

// out = sum_s 2^(m_s - M) o_s / sum_s 2^(m_s - M) l_s over the splits of
// each row, M their maximum; 0 where no split saw a valid key (M = -inf).
// One thread per row and 4 columns.
__global__ void combine_splits(const float* __restrict__ part_o,
                               const float2* __restrict__ part_ml, float* __restrict__ out,
                               int rows, int D, int splits) {
  const int quads = D / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * quads) return;
  const int row = (int)(idx / quads);
  const int c = (int)(idx - (long long)row * quads) * 4;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[(size_t)s * rows + row].x);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m != -INFINITY) {
    float l = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 ml = part_ml[(size_t)s * rows + row];
      const float w = exp2f(ml.x - m);  // 0 for a split with no valid key
      const float4 x = *reinterpret_cast<const float4*>(part_o + ((size_t)s * rows + row) * D + c);
      l += w * ml.y;
      acc.x += w * x.x, acc.y += w * x.y, acc.z += w * x.z, acc.w += w * x.w;
    }
    const float inv = 1.f / l;
    acc.x *= inv, acc.y *= inv, acc.z *= inv, acc.w *= inv;
  }
  *reinterpret_cast<float4*>(out + (size_t)row * D + c) = acc;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (this
// library does not link libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (planes, rows, d) bf16 tensor, boxes of 64 rows x 64 columns with the
// 128-byte swizzle; rows and columns past the tensor read as 0
bool tensor_map(CUtensorMap* map, const void* ptr, int d, long long rows, long long planes) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {SW_COLS, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const uint16_t* qu, const uint16_t* qv, const uint16_t* k, const uint16_t* v,
                   const uint16_t* p, const int* lengths, float* out, float* part_o,
                   float2* part_ml, int B, int H, int T, int splits, int tiles_per_split,
                   float scale, cudaStream_t stream) {
  CUtensorMap maps[5];
  const uint16_t* srcs[4] = {qu, qv, k, v};
  for (int i = 0; i < 4; ++i)
    if (!tensor_map(&maps[i], srcs[i], D, T, (long long)B * H)) return cudaErrorInvalidValue;
  if (!tensor_map(&maps[4], p, D, 2 * (long long)T - 1, H)) return cudaErrorInvalidValue;
  const int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_rel_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((T + BQ - 1) / BQ) * splits, H, B);
  flash_rel_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lengths, splits > 1 ? part_o : out, part_ml, H,
      T, splits, tiles_per_split, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long quads = (long long)B * H * T * (D / 4);
  combine_splits<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(part_o, part_ml, out,
                                                                      B * H * T, D, splits);
  return cudaGetLastError();
}

}  // namespace bf16

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

// q_u, q_v, k, v (B, H, T, D) and p (H, 2T - 1, D) bf16; out (B, H, T, D)
// f32.  The key tiles of 64 go to splits of tiles_per_split each, none
// empty (kernels/flash_attention.py::bf16_geometry); with splits > 1,
// part_o (splits, B, H, T, D) and part_ml (splits, B, H, T, 2) f32 hold the
// splits' partial rows, combined by a second kernel.
extern "C" int flash_rel_attention_bf16(const void* qu, const void* qv, const void* k,
                                        const void* v, const void* p, const void* lengths,
                                        void* out, void* part_o, void* part_ml, int B, int H,
                                        int T, int D, int splits, int tiles_per_split,
                                        float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_kt = (T + bf16::BK - 1) / bf16::BK;
  if (splits < 1 || tiles_per_split < 1 || (long long)splits * tiles_per_split < n_kt ||
      (long long)(splits - 1) * tiles_per_split >= n_kt || (splits > 1 && !(part_o && part_ml)))
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const uint16_t*>(qu);
  const auto* b = static_cast<const uint16_t*>(qv);
  const auto* kk = static_cast<const uint16_t*>(k);
  const auto* vv = static_cast<const uint16_t*>(v);
  const auto* pp = static_cast<const uint16_t*>(p);
  const auto* ll = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto* po = static_cast<float*>(part_o);
  auto* ml = static_cast<float2*>(part_ml);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define K1_BF16_CASE(W)                                                                      \
  case W:                                                                                    \
    return (int)bf16::launch<W>(a, b, kk, vv, pp, ll, o, po, ml, B, H, T, splits,            \
                                tiles_per_split, scale, s);
    K1_BF16_CASE(16)
    K1_BF16_CASE(32)
    K1_BF16_CASE(48)
    K1_BF16_CASE(64)
    K1_BF16_CASE(96)
    K1_BF16_CASE(128)
#undef K1_BF16_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16 kernel's dynamic shared memory at head dim D, -1 if not built
extern "C" int flash_rel_attention_bf16_smem(int D) {
  switch (D) {
    case 16: return bf16::Smem<16>::BYTES;
    case 32: return bf16::Smem<32>::BYTES;
    case 48: return bf16::Smem<48>::BYTES;
    case 64: return bf16::Smem<64>::BYTES;
    case 96: return bf16::Smem<96>::BYTES;
    case 128: return bf16::Smem<128>::BYTES;
    default: return -1;
  }
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash attention with Transformer-XL relative position bias, f32.
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
// d = 48 it does 3 * 2 * T^2 * d flops per head (q_u.k, q_v.p, P.v) on
// 2 MB of inputs, far above the f32 machine balance.  This first version
// runs on the CUDA cores in f32, so its roof is the 67 TFLOP/s f32 rate.
//
// Design: one block of 256 threads per (64-row query tile, h, b) walks the
// key tiles of 64 with an online softmax, so nothing of size T^2 or T*(2T-1)
// is ever stored.  The rel-pos bias of query tile [i0, i0+64) and key tile
// [j0, j0+64) needs only rows T-1-(i0+63)+j0 ... T-1-i0+j0+63 of p, 127
// contiguous rows, which are staged in shared memory next to the k and v
// tiles; the bias is computed directly as q_v[i] . p[T-1-i+j], no pad or
// reshape trick.  Key tiles wholly past lengths[b] are skipped (exact).
// Each thread owns a 4x4 block of the 64x64 score tile (rows ty+16a, keys
// tx+16b); row maxima and sums are reduced over the 16 lanes of a row with
// warp shuffles.  Rows are padded by one float in shared memory to keep the
// strided reads free of bank conflicts.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 x 16

template <int D>
constexpr size_t smem_floats() {
  return 3 * BQ * (D + 1)             // q_u, q_v, k
         + BK * D                     // v
         + (BQ + BK - 1) * (D + 1)    // rel-pos rows
         + BQ * (BK + 1);             // probabilities of the tile
}

template <int D>
__global__ void __launch_bounds__(NT) flash_rel_kernel(
    const float* __restrict__ qu, const float* __restrict__ qv,
    const float* __restrict__ kg, const float* __restrict__ vg,
    const float* __restrict__ pg, const int* __restrict__ lengths,
    float* __restrict__ out, int H, int T, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int NP = BQ + BK - 1;
  constexpr int SP = BK + 1;
  constexpr int E = D / 16;

  extern __shared__ float smem[];
  float* s_qu = smem;
  float* s_qv = s_qu + BQ * DP;
  float* s_k = s_qv + BQ * DP;
  float* s_v = s_k + BK * DP;
  float* s_p = s_v + BK * D;
  float* s_s = s_p + NP * DP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * (size_t)T * D;
  const float* qu_bh = qu + base;
  const float* qv_bh = qv + base;
  const float* k_bh = kg + base;
  const float* v_bh = vg + base;
  float* o_bh = out + base;
  const float* p_h = pg + (size_t)h * (2 * T - 1) * D;
  const int len = min(max(lengths[b], 0), T);

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int gi = i0 + r;
    float a = 0.f, bb = 0.f;
    if (gi < T) {
      a = qu_bh[(size_t)gi * D + c];
      bb = qv_bh[(size_t)gi * D + c];
    }
    s_qu[r * DP + c] = a;
    s_qv[r * DP + c] = bb;
  }

  float acc[4][E];
  float m_i[4], l_i[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = -INFINITY;
    l_i[a] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[a][e] = 0.f;
  }

  const int n_kt = (len + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's k, v, p and probabilities are consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx - r * D;
      const int gj = j0 + r;
      float kk = 0.f, vv = 0.f;
      if (gj < T) {
        kk = k_bh[(size_t)gj * D + c];
        vv = v_bh[(size_t)gj * D + c];
      }
      s_k[r * DP + c] = kk;
      s_v[r * D + c] = vv;
    }
    // rel row of (query i0+r, key j0+c) is lo + (BQ-1-r+c)
    const int lo = T - 1 - (i0 + BQ - 1) + j0;
    for (int idx = tid; idx < NP * D; idx += NT) {
      const int r = idx / D, c = idx - r * D;
      const int g = lo + r;
      s_p[r * DP + c] = (g >= 0 && g < 2 * T - 1) ? p_h[(size_t)g * D + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[a][q] = 0.f;

#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], qb[4], kk[4], pp[7];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = s_qu[(ty + 16 * a) * DP + c];
        qb[a] = s_qv[(ty + 16 * a) * DP + c];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) kk[q] = s_k[(tx + 16 * q) * DP + c];
      // rows BQ-1-(ty+16a)+(tx+16q) take 7 distinct values, q-a = -3..3
#pragma unroll
      for (int e = 0; e < 7; ++e) pp[e] = s_p[(BQ - 1 - ty + tx + 16 * (e - 3)) * DP + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sc[a][q] = fmaf(qa[a], kk[q], fmaf(qb[a], pp[q - a + 3], sc[a][q]));
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float rmax = -INFINITY;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gj = j0 + tx + 16 * q;
        const float s = gj < len ? sc[a][q] * scale : -INFINITY;
        sc[a][q] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      // key j0 < len is valid, so rmax and m_new are finite
      const float m_new = fmaxf(m_i[a], rmax);
      const float alpha = expf(m_i[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float pe = expf(sc[a][q] - m_new);
        sc[a][q] = pe;
        rsum += pe;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[a] = l_i[a] * alpha + rsum;
      m_i[a] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[a][e] *= alpha;
#pragma unroll
      for (int q = 0; q < 4; ++q) s_s[(ty + 16 * a) * SP + tx + 16 * q] = sc[a][q];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[4], vv[E];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = s_s[(ty + 16 * a) * SP + j];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = s_v[j * D + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[a][e] = fmaf(pa[a], vv[e], acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = i0 + ty + 16 * a;
    if (gi < T) {
      const float inv = l_i[a] > 0.f ? 1.f / l_i[a] : 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) o_bh[(size_t)gi * D + tx + 16 * e] = acc[a][e] * inv;
    }
  }
}

template <int D>
cudaError_t launch(const float* qu, const float* qv, const float* k, const float* v,
                   const float* p, const int* lengths, float* out, int B, int H, int T,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_rel_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_rel_kernel<D><<<grid, NT, smem, stream>>>(qu, qv, k, v, p, lengths, out, H, T,
                                                  1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_rel_attention_f32(const void* qu, const void* qv, const void* k,
                                       const void* v, const void* p, const void* lengths,
                                       void* out, int B, int H, int T, int D, void* stream) {
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
    case 16: return (int)launch<16>(a, b, kk, vv, pp, ll, o, B, H, T, s);
    case 32: return (int)launch<32>(a, b, kk, vv, pp, ll, o, B, H, T, s);
    case 48: return (int)launch<48>(a, b, kk, vv, pp, ll, o, B, H, T, s);
    case 64: return (int)launch<64>(a, b, kk, vv, pp, ll, o, B, H, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

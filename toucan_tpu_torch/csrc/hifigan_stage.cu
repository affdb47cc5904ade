// One HiFiGAN residual stage, fused into one launch, f32 accuracy on the
// tensor cores (split TF32).
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
// activations.  This is the exact path, held to (2e-4 atol, 2e-3 rtol)
// against its plain version; one TF32 product per multiply misses that by
// ~1e-3 at unit-gain weights.  So each conv runs in split TF32 ("3xTF32"):
// x = big + small with big = tf32(x), small = tf32(x - big), and
// a.b = a_s.b_b + a_b.b_s + a_b.b_b in f32, which drops only a_s.b_s
// (~2^-22 relative).  Roof: 495 / 3 = 165 TFLOP/s on mma.sync.m16n8k8
// TF32, against 67 TFLOP/s for f32 on the CUDA cores.
//
// Design.
//  - Work unit: a time tile of `tile` output rows of one sample, with a
//    recomputed halo of `halo` rows per side (60: the receptive field of the
//    k = 11 stack), so tiles never wait on each other.  The valid region
//    shrinks by each conv's padding, so every conv computes only the rows
//    that later convs read.
//  - A thread-block cluster of `cluster` blocks (1, 2, 4 or 8; launched with
//    cudaLaunchKernelEx and a cluster dimension) takes one tile at a time
//    and splits the output channels: block r computes channels
//    [r * NB, (r + 1) * NB) of every conv (NB = 64, or 32), reads the full
//    input rows its peers wrote, and waits at a cluster barrier
//    (release / acquire, after a __threadfence) between convs.  The grid is
//    persistent: as many clusters as fit on the card at once, each walking
//    tiles in turn.  `kernels/resstack.py::stage_tiling` picks tile and
//    cluster per call from (B, T, C, the card's clusters in flight) so that
//    every stage fills the card, weighing the recomputed halo.
//  - Each conv is an implicit GEMM: M = the tile's rows, N = the block's NB
//    channels, K = k taps x C_in.  8 warps per block; a warp computes 16
//    rows x 64 channels (NB = 64, 128 rows per M tile) or 32 x 32 (NB = 32,
//    256 rows).  Per step of 8 input channels, cp.async (16 B a thread)
//    stages the window of RT + (k - 1) d input rows and the k taps' weights
//    into a double buffer, one step ahead of the one that computes (a third
//    buffer was no faster on the H100).  The A
//    operand of tap tau is that window shifted by tau * d rows, so one staged
//    window serves all k taps; leaky ReLU and the TF32 split are applied as
//    each A fragment is loaded.  The weights come split once per weight
//    load (the wrapper caches a (conv, tap, C_in, C_out, {big, small}) copy
//    beside StageWeights), so a B fragment is two 8-byte loads.  Bias, the
//    zeroing of rows outside [0, T), the residual add and the 3-stack mean
//    (in the order (x0 + x1 + x2) / 3) are the epilogue.
//  - Streams: a tile's f32 residual stream and conv output, 2 x (tile +
//    2 halo) x C floats, do not fit in shared memory beside the staging
//    buffers at the tiles that fill the card (254 KB at C = 256 and a tile
//    of 128), so each cluster keeps them in its own slice of a global
//    scratch.  Peers' slices are read with cp.async.cg, which reads L2.
//    The chooser keeps the scratch of all clusters in flight under 24 MB,
//    half the 50 MB L2, so it stays L2-resident.
// Shared memory: two stages of (RT + (k_max - 1) d_max) x 12 floats (A)
// and k_max x 8 x (NB + 4) float2 (B): 110 KB at NB = 64, 78 KB at NB = 32,
// for k = 11 and d = 5; one block of 256 threads (~234 registers each) per
// SM.  Each k-tap x 8-channel step is summed in its own accumulators and
// added to the conv's in f32: the tensor cores' accumulation truncates, and
// one chain over all k x C products drifts by ~1e-5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;        // threads per block
constexpr int NWARP = NTH / 32;
constexpr int CK = 8;           // input channels per staging step
constexpr int SP = CK + 4;      // padded A row (conflict-free fragment loads)
constexpr int N_STACKS = 3;
constexpr int N_ROUNDS = 3;
constexpr int NSTAGE = 2;       // staging buffers in the cp.async ring

template <int NB>
struct Tiling {
  static constexpr int MT = NB == 64 ? 1 : 2;  // m16 tiles per warp
  static constexpr int NTL = NB / 8;           // n8 tiles per warp: all NB channels
  static constexpr int RT = NWARP * 16 * MT;   // rows per M tile
  static constexpr int BP2 = NB + 4;           // padded B row, in float2
};

__host__ __device__ inline int stack_halo(int k, const int* dil) {
  int h = 0;
  for (int r = 0; r < N_ROUNDS; ++r) h += (k - 1) / 2 * (dil[r] + 1);
  return h;
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

// All blocks of the cluster; this block's global writes are visible to the
// peers after it.
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct StageArgs {
  int B, T, C, tile, halo, cluster;
  int ks[N_STACKS];
  int dil[N_ROUNDS];
  float slope;
};

// One conv over local rows [lo, hi) of a tile, output channels
// [n0, n0 + NB): dst = conv(lrelu(src)) + bias, or dst += ... when
// accumulate.  Row l of the tile is global row g0 + l; src, dst are
// (W, C) row-major slices of the cluster's scratch.
template <int NB>
__device__ void conv_pass(const float* src, float* dst, bool accumulate,
                          const float2* __restrict__ w2, const float* __restrict__ bias,
                          int C, int n0, int k, int d, int lo, int hi, int W, int g0, int T,
                          float slope, float* s_a, float2* s_b, int a_stage, int b_stage) {
  using TL = Tiling<NB>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rb = (tid >> 5) * 16 * TL::MT;  // the warp's first row in the M tile
  const int pad = d * (k - 1) / 2;
  const int span = TL::RT + (k - 1) * d;
  const int n_steps = C / CK;

  for (int r0 = lo; r0 < hi; r0 += TL::RT) {
    const bool active = r0 + rb < hi;
    float acc[TL::MT][TL::NTL][4];
#pragma unroll
    for (int m = 0; m < TL::MT; ++m)
#pragma unroll
      for (int n = 0; n < TL::NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    auto stage = [&](int step) {
      float* sa = s_a + (step % NSTAGE) * a_stage;
      float2* sb = s_b + (step % NSTAGE) * b_stage;
      const int ci0 = step * CK;
      for (int idx = tid; idx < span * (CK / 4); idx += NTH) {
        const int r = idx / (CK / 4), c = (idx % (CK / 4)) * 4;
        const int l = r0 - pad + r;
        const bool ok = l >= 0 && l < W;
        cp_async16(sa + r * SP + c, src + (size_t)(ok ? l : 0) * C + ci0 + c, ok);
      }
      constexpr int CH = NB / 2;  // 16-byte pieces per weight row
      for (int idx = tid; idx < k * CK * CH; idx += NTH) {
        const int row = idx / CH, c = (idx % CH) * 2;
        const int tap = row / CK, ci = row - tap * CK;
        cp_async16(sb + row * TL::BP2 + c, w2 + ((size_t)tap * C + ci0 + ci) * C + n0 + c, true);
      }
    };

    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < n_steps) stage(s);
      cp_async_commit();
    }
    for (int step = 0; step < n_steps; ++step) {
      if (step + NSTAGE - 1 < n_steps) stage(step + NSTAGE - 1);
      cp_async_commit();
      cp_async_wait<NSTAGE - 1>();
      __syncthreads();
      if (active) {
        const float* sa = s_a + (step % NSTAGE) * a_stage;
        const float2* sb = s_b + (step % NSTAGE) * b_stage;
        // the step's k taps x 8 channels are summed apart, then added in f32
        float part[TL::MT][TL::NTL][4];
#pragma unroll
        for (int m = 0; m < TL::MT; ++m)
#pragma unroll
          for (int n = 0; n < TL::NTL; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
        for (int tap = 0; tap < k; ++tap) {
          uint32_t ab[TL::MT][4], as[TL::MT][4];
#pragma unroll
          for (int m = 0; m < TL::MT; ++m) {
            const float* a0 = sa + (rb + m * 16 + tap * d + g) * SP + t;
            const float av[4] = {a0[0], a0[8 * SP], a0[4], a0[8 * SP + 4]};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(av[e] >= 0.f ? av[e] : slope * av[e], ab[m][e], as[m][e]);
          }
          const float2* b0 = sb + (tap * CK + t) * TL::BP2 + g;
#pragma unroll
          for (int n = 0; n < TL::NTL; ++n) {
            const float2 lo_k = b0[n * 8];
            const float2 hi_k = b0[4 * TL::BP2 + n * 8];
            const uint32_t bb[2] = {__float_as_uint(lo_k.x), __float_as_uint(hi_k.x)};
            const uint32_t bs[2] = {__float_as_uint(lo_k.y), __float_as_uint(hi_k.y)};
#pragma unroll
            for (int m = 0; m < TL::MT; ++m) {
              mma_tf32(part[m][n], as[m], bb);
              mma_tf32(part[m][n], ab[m], bs);
              mma_tf32(part[m][n], ab[m], bb);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < TL::MT; ++m)
#pragma unroll
          for (int n = 0; n < TL::NTL; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
      }
      __syncthreads();  // this buffer is restaged NSTAGE - 1 steps on
    }

    if (active) {
#pragma unroll
      for (int m = 0; m < TL::MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int l = r0 + rb + m * 16 + g + 8 * half;
          if (l >= hi) continue;
          const int gr = g0 + l;
          const bool in_seq = gr >= 0 && gr < T;
#pragma unroll
          for (int n = 0; n < TL::NTL; ++n) {
            const int col = n0 + n * 8 + 2 * t;
            float2 val = make_float2(0.f, 0.f);
            if (in_seq)
              val = make_float2(acc[m][n][2 * half] + bias[col],
                                acc[m][n][2 * half + 1] + bias[col + 1]);
            float2* o = reinterpret_cast<float2*>(dst + (size_t)l * C + col);
            if (accumulate) {
              const float2 old = *o;
              val = make_float2(old.x + val.x, old.y + val.y);
            }
            *o = val;
          }
        }
    }
  }
}

template <int NB>
__host__ __device__ size_t stage_smem_bytes(int k_max, int d_max, int* a_stage, int* b_stage) {
  *a_stage = (Tiling<NB>::RT + (k_max - 1) * d_max) * SP;  // floats
  *b_stage = k_max * CK * Tiling<NB>::BP2;                  // float2
  return NSTAGE * ((size_t)*a_stage * sizeof(float) + (size_t)*b_stage * sizeof(float2));
}

template <int NB>
__global__ void __launch_bounds__(NTH, 1) stage_kernel(
    const float* __restrict__ x, const float2* __restrict__ w2,
    const float* __restrict__ bias, float* out, float* scratch, StageArgs args) {
  extern __shared__ float4 smem4[];
  const int C = args.C, T = args.T, tile = args.tile, halo = args.halo;
  const int W = tile + 2 * halo;
  int a_stage, b_stage;
  stage_smem_bytes<NB>(args.ks[N_STACKS - 1], args.dil[N_ROUNDS - 1], &a_stage, &b_stage);
  float* s_a = reinterpret_cast<float*>(smem4);
  float2* s_b = reinterpret_cast<float2*>(s_a + NSTAGE * a_stage);
  const int rank = blockIdx.x % args.cluster;
  const int cid = blockIdx.x / args.cluster;
  const int n_clusters = gridDim.x / args.cluster;
  const int n0 = rank * NB;
  float* xres = scratch + (size_t)cid * 2 * W * C;
  float* tmp = xres + (size_t)W * C;
  const int tiles_t = (T + tile - 1) / tile;
  constexpr int Q = NB / 4;  // float4 per row of the block's channels

  for (int job = cid; job < args.B * tiles_t; job += n_clusters) {
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
      for (int idx = threadIdx.x; idx < (hi - lo) * Q; idx += NTH) {
        const int l = lo + idx / Q, c = n0 + (idx % Q) * 4;
        const int gr = g0 + l;
        *reinterpret_cast<float4*>(xres + (size_t)l * C + c) =
            (gr >= 0 && gr < T) ? *reinterpret_cast<const float4*>(xb + (size_t)gr * C + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      cluster_sync();  // every block's slice of x_s is in place
      for (int r = 0; r < N_ROUNDS; ++r) {
        const int d = args.dil[r];
        lo += d * (k - 1) / 2;
        hi -= d * (k - 1) / 2;
        conv_pass<NB>(xres, tmp, false, w2 + w_off, bias + (size_t)conv * C, C, n0, k, d, lo,
                      hi, W, g0, T, args.slope, s_a, s_b, a_stage, b_stage);
        w_off += (size_t)k * C * C;
        ++conv;
        cluster_sync();
        lo += (k - 1) / 2;
        hi -= (k - 1) / 2;
        conv_pass<NB>(tmp, xres, true, w2 + w_off, bias + (size_t)conv * C, C, n0, k, 1, lo,
                      hi, W, g0, T, args.slope, s_a, s_b, a_stage, b_stage);
        w_off += (size_t)k * C * C;
        ++conv;
        cluster_sync();
      }
      // rows [halo, halo + n_out) of this block's channels are final for this stack
      for (int idx = threadIdx.x; idx < n_out * Q; idx += NTH) {
        const int r = idx / Q, c = n0 + (idx % Q) * 4;
        const float4 v = *reinterpret_cast<const float4*>(xres + (size_t)(halo + r) * C + c);
        float4* o = reinterpret_cast<float4*>(ob + (size_t)(t0 + r) * C + c);
        if (s == 0) {
          *o = v;
        } else {
          float4 a = *o;
          a = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
          if (s == N_STACKS - 1)
            a = make_float4(a.x / (float)N_STACKS, a.y / (float)N_STACKS,
                            a.z / (float)N_STACKS, a.w / (float)N_STACKS);
          *o = a;
        }
      }
      __syncthreads();  // the readers of xres are done before it is reloaded
    }
  }
}

template <int NB>
cudaError_t configure(const StageArgs& args, int grid, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  int a_stage, b_stage;
  const size_t smem = stage_smem_bytes<NB>(args.ks[N_STACKS - 1], args.dil[N_ROUNDS - 1],
                                           &a_stage, &b_stage);
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(NTH);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = args.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int NB>
cudaError_t launch(const float* x, const float2* w2, const float* bias, float* out,
                   float* scratch, const StageArgs& args, int grid, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<NB>(args, grid, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, stage_kernel<NB>, x, w2, bias, out, scratch, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NB>
cudaError_t max_clusters(const StageArgs& args, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<NB>(args, args.cluster, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, stage_kernel<NB>, &cfg);
}

bool valid(const StageArgs& a) {
  const int nb = a.cluster > 0 ? a.C / a.cluster : 0;
  return a.B > 0 && a.T > 0 && a.tile > 0 && a.cluster >= 1 &&
         a.cluster <= (nb == 64 ? 8 : 4) &&
         (nb == 32 || nb == 64) && nb * a.cluster == a.C && a.ks[0] <= a.ks[1] &&
         a.ks[1] <= a.ks[2] && a.dil[0] <= a.dil[1] && a.dil[1] <= a.dil[2] &&
         a.halo >= stack_halo(a.ks[2], a.dil);
}

}  // namespace

// x, out (B, T, C); w2 the 18 convs packed as in StageWeights.w, each
// weight split into its TF32 (big, small) pair: (conv, k, C_in, C_out, 2);
// bias (18, C); scratch (grid / cluster) * 2 * (tile + 2 * halo) * C floats.
// C / cluster is 64 with at most 8 blocks a cluster (Hopper's portable
// size) or 32 with at most 4; kernel sizes and dilations ascending; x
// 16-byte aligned.
extern "C" int hifigan_stage_f32(const void* x, const void* w2, const void* bias, void* out,
                                 void* scratch, int B, int T, int C, int k0, int k1, int k2,
                                 int d0, int d1, int d2, int tile, int halo, int cluster,
                                 int grid, float slope, void* stream) {
  const StageArgs args{B, T, C, tile, halo, cluster, {k0, k1, k2}, {d0, d1, d2}, slope};
  if (!valid(args) || grid <= 0 || grid % cluster != 0) return (int)cudaErrorInvalidValue;
  const auto* xx = static_cast<const float*>(x);
  const auto* ww = static_cast<const float2*>(w2);
  const auto* bb = static_cast<const float*>(bias);
  auto* oo = static_cast<float*>(out);
  auto* ss = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (C / cluster == 64) return (int)launch<64>(xx, ww, bb, oo, ss, args, grid, st);
  return (int)launch<32>(xx, ww, bb, oo, ss, args, grid, st);
}

// How many clusters of `cluster` blocks (C / cluster channels each) the
// current device runs at once, for kernel sizes up to k2 and dilations up
// to d2.
extern "C" int hifigan_stage_max_clusters(int C, int cluster, int k2, int d2, void* n) {
  const StageArgs args{1, 1, C, 1, 1 << 20, cluster, {k2, k2, k2}, {d2, d2, d2}, 0.f};
  if (!valid(args)) return (int)cudaErrorInvalidValue;
  auto* nn = static_cast<int*>(n);
  if (C / cluster == 64) return (int)max_clusters<64>(args, nn);
  return (int)max_clusters<32>(args, nn);
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

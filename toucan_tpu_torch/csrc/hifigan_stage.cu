// One HiFiGAN residual stage, fused into one launch, f32 accuracy on
// Hopper's warpgroup tensor cores (split TF32 on wgmma).
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
// (~2^-22 relative).  Roof: 495 / 3 = 165 TFLOP/s of f32 products.
//
// What this design replaces.  The kernel before it ran each conv on
// mma.sync.m16n8k8, which cannot reach Hopper's tensor-core rate; it
// lrelu'd and split every A fragment again for every tap (up to 11 times
// an element a conv) and fed each split fragment to only 4 n-tiles x 3
// products, one cp.async step ahead: 16 % of the split-TF32 roof in the
// served cells.  Here:
//  - Work unit, as before: a time tile of `tile` output rows of one sample,
//    with a recomputed halo of `halo` rows per side (60: the receptive field
//    of the k = 11 stack), so tiles never wait on each other; each conv
//    computes only the rows later convs read.  A thread-block cluster of
//    `cluster` blocks (1 to 8) takes one tile at a time and splits the
//    output channels: block r computes channels [r NB, (r + 1) NB) of every
//    conv (NB = 128, 64 or 32), reads the full input rows its peers wrote,
//    and waits at a cluster barrier between convs.  The grid is persistent.
//    `kernels/resstack.py::stage_tiling` picks NB, tile and cluster per
//    call from a time model fitted to this kernel on the H100.
//  - Each conv is an implicit GEMM, M = the tile's rows, N = NB, K = k taps
//    x C_in, as warpgroup wgmma.mma_async.m64nNBk8.tf32 with both operands
//    in shared memory: the tensor cores run at ~95 % of their rate at N =
//    64 and 128 with two warpgroups (~60 % at N = 32), against well under
//    half on mma.sync.  Two warpgroups a block, each over its own 64 rows
//    (2 x 64 at NB = 32) of an M tile, running apart and taking turns to
//    issue a step's wgmmas: the tensor cores run them in order, so one
//    warpgroup's step runs while the other waits for its last and adds it
//    up (15 % off HiFiGAN's stages 0 and 1, against both issuing at once).
//  - Split once, read k times.  Per step of 8 input channels a warpgroup
//    reads its window of 64 + (k - 1) d input rows from the stream (L2)
//    into registers two steps ahead, then lrelu's and splits it once into
//    big and small TF32 planes: each group of 4 channels is a plane of
//    16-byte rows, wgmma's no-swizzle K-major layout, in which 8 consecutive
//    rows from any row form a core matrix.  So tap tau's A operand is the
//    same planes read from row tau d on, a descriptor offset, and one split
//    window serves all k taps, three products each.
//  - The weights come split and packed per (NB, step): the big and small
//    planes of k taps x 8 input channels x NB outputs are one contiguous
//    run, which one thread loads by a TMA bulk copy into a ring of 2 (NB =
//    128) or 3 slots with full and empty mbarriers, 1 or 2 steps ahead,
//    across M tiles and into the next conv (its weights do not wait for
//    the cluster barrier).
//  - Each step's partial products are summed by the tensor cores in their
//    own registers and added to the conv's sum in f32, as before: the
//    tensor cores' accumulation truncates, and one chain over all k x C
//    products drifts by ~1e-5.
//  - The sum starts at the bias (plus the residual for the second conv of
//    a round); rows outside [0, T) are written as zero; the 3-stack mean is
//    taken in the order (x0 + x1 + x2) / 3.
//  - Streams: a tile's f32 residual stream and conv output, 2 x (tile + 2
//    halo) x C floats, live in the cluster's slice of a global scratch,
//    read with .cg loads (L2) two steps ahead; the chooser keeps all
//    clusters' slices in flight under 64 MB.
// What bounds it now (H100, HiFiGAN's stages): a step's fixed cost (the
// wait for its wgmmas, the sum, the barriers; the chooser's STEP_COST);
// the weights' traffic from L2 at NB = 128 (~15 %); the tensor cores' rate
// at N = 32 (stage 3); the recomputed halo of stage 0's short tiles.
// Shared memory: NBS weight slots of k_max x 4 x NB x 16 bytes, 4 window
// slots of 4 x (WR + (k_max - 1) d_max) x 16 bytes: 209, 164 and 113 KB at
// NB = 128, 64 and 32 for k = 11 and d = 5; one block of 256 threads per
// SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;        // threads per block: two warpgroups
constexpr int CK = 8;           // input channels per staging step: wgmma's k8 of tf32
constexpr int N_STACKS = 3;
constexpr int N_ROUNDS = 3;
// window rows past its M tile ((k - 1) d) that are read a step ahead into
// registers; any further rows are read when the window is split
constexpr int MAX_REACH = 128;
constexpr int SMEM_LIMIT = 232448;

template <int NB>
struct Tiling {
  static constexpr int MT = NB == 32 ? 2 : 1;    // m64 tiles per warpgroup
  static constexpr int WR = 64 * MT;             // a warpgroup's rows of an M tile
  static constexpr int RT = 2 * WR;              // rows per M tile: two warpgroups
  static constexpr int NACC = NB / 2;            // accumulator floats per m64 tile and thread
  static constexpr int NBS = NB == 128 ? 2 : 3;  // weight ring slots: NBS - 1 steps ahead
  static constexpr int PRE = (2 * (WR + MAX_REACH) + 127) / 128;  // float4 read ahead a thread
};

// Byte offsets of the shared memory: the weight ring, each warpgroup's two
// window slots, the ring's full and empty mbarriers.
struct Smem {
  int span;        // rows of a window slot: WR + (k_max - 1) d_max
  int a_slot;      // bytes of a window slot: {big, small} x 2 channel groups x span x 16
  int b_slot;      // bytes of a weight slot: k_max taps x {big, small} x 2 x NB x 16
  int a0, full, empty, bytes;
};

template <int NB>
__host__ __device__ inline Smem stage_smem(int k_max, int d_max) {
  Smem s;
  s.span = Tiling<NB>::WR + (k_max - 1) * d_max;
  s.a_slot = 4 * s.span * 16;
  s.b_slot = k_max * 4 * NB * 16;
  s.a0 = Tiling<NB>::NBS * s.b_slot;
  s.full = s.a0 + 4 * s.a_slot;
  s.empty = s.full + 8 * Tiling<NB>::NBS;
  s.bytes = s.empty + 8 * Tiling<NB>::NBS;
  return s;
}

__host__ __device__ inline int stack_halo(int k, const int* dil) {
  int h = 0;
  for (int r = 0; r < N_ROUNDS; ++r) h += (k - 1) / 2 * (dil[r] + 1);
  return h;
}

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
// the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
// The warpgroups take turns to issue a step's wgmmas (named barriers 3 and
// 4), so that the tensor cores, which run them in order, run one
// warpgroup's while the other waits for its last step and adds it up.
// turn_wait: warpgroup 0 waits for 1 to have issued its previous step, 1
// for 0 to have issued this one; turn_pass after the issue.  Predicated,
// not branched: a branch the compiler takes for divergent serializes wgmmas.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, %0, 0;\n@p bar.sync 3, 256;\n@!p bar.sync 4, 256;\n}\n"
               ::"r"(wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, %0, 0;\n@p bar.arrive 4, 256;\n@!p bar.arrive 3, 256;\n}\n"
               ::"r"(wg) : "memory");
}
// before a conv's first turn (warpgroup 1 lets 0 go first) and after its
// last (warpgroup 0 takes 1's last pass)
__device__ __forceinline__ void turn_open(int wg) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %0, 0;\n@p bar.arrive 3, 256;\n}\n" ::"r"(wg)
               : "memory");
}
__device__ __forceinline__ void turn_close(int wg) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, %0, 0;\n@p bar.sync 3, 256;\n}\n" ::"r"(wg)
               : "memory");
}

// The wait loop is PTX: a C++ loop whose exit differs by thread, or a trap
// in it, is a divergent path to ptxas, which then serializes the wgmmas
// after it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// `bytes` contiguous bytes from global memory into this block's shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 ld_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(x));
  const float rest = x - __uint_as_float(b);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(rest));
  big = __uint_as_float(b);
  small = __uint_as_float(s);
}

// wgmma descriptor of a no-swizzle K-major operand: 8-row core matrices of
// 16 bytes a row, rows contiguous (128 bytes to the next 8 rows), the second
// 4-channel group `kg_stride` bytes on
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t kg_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kg_stride >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
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
template <int M, int N>
__device__ __forceinline__ void reg_fence(float (&d)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
}

// d (+)= A . B, m64nNk8 tf32 (N = 128, 64, 32), A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da, uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale));
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

// Where a block's shared memory is, and the weight ring's state (the same
// in every thread): `u` weight steps consumed so far, step u in slot u % NBS.
struct Pipe {
  float* smem;
  uint32_t base;
  Smem L;
  int u;
};

// One conv over local rows [lo, hi) of a tile, output channels
// [n0, n0 + NB): dst = conv(lrelu(src)) + bias, or dst += ... when
// accumulate.  Row l of the tile is global row g0 + l; src, dst are
// (W, C) row-major slices of the cluster's scratch.  wb: this conv's packed
// weights of the block's channels (step s at wb + s * 16 k NB floats);
// next_wb, next_k: the next conv's, whose first steps are loaded during this
// conv's last (null: none).
//
// The two warpgroups run apart, each over its own WR rows of every M tile,
// so that one's wgmmas keep the tensor cores busy while the other waits for
// its last step's and adds it up.  Step i of a warpgroup (M tile i /
// n_steps, input channels 8 (i % n_steps) on): a warpgroup barrier (its
// window planes of step i are in place, its step i - 1 is done); its turn;
// the wgmmas of step i; thread 0 reloads the weight slot of step i - 1 once
// both warpgroups have released it, with the step NBS - 1 ahead; while the
// wgmmas run, the warpgroup splits its window of step i + 1 (read a step
// earlier) into its other slot and reads that of step i + 2; then it adds
// step i's products to its sum and releases the weight slot.
template <int NB>
__device__ void conv_pass(const float* src, float* dst, bool accumulate,
                          const float* __restrict__ wb, const float* __restrict__ bias,
                          const float* next_wb, int next_k, int C, int n0, int k, int d,
                          int lo, int hi, int W, int g0, int T, float slope, Pipe& P) {
  using TL = Tiling<NB>;
  constexpr int NBS = TL::NBS;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;  // thread of the warpgroup
  const int warp = wt >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int pad = d * (k - 1) / 2;
  const int span = TL::WR + (k - 1) * d;  // window rows of this conv
  const int n_steps = C / CK;             // at least 4
  const int total = (hi - lo + TL::RT - 1) / TL::RT * n_steps;
  const int plane = P.L.span * 16;        // bytes between the window's channel-group planes
  const uint32_t b_ring = P.base, full = P.base + P.L.full, empty = P.base + P.L.empty;
  const int a_own = P.L.a0 + 2 * wg * P.L.a_slot;  // this warpgroup's two window slots

  float acc[TL::MT][TL::NACC], part[TL::MT][TL::NACC];
  float4 v[TL::PRE];

  // first row of this warpgroup's rows of step i's M tile
  auto row0 = [&](int i) { return lo + (i / n_steps) * TL::RT + wg * TL::WR; };
  // window element idx (row idx / 2, channel group idx % 2) of step i
  auto window = [&](int i, int idx) -> float4 {
    const int l = row0(i) - pad + (idx >> 1);
    if (l < 0 || l >= W) return make_float4(0.f, 0.f, 0.f, 0.f);
    return ld_cg4(src + (size_t)l * C + (i % n_steps) * CK + 4 * (idx & 1));
  };
  auto read_ahead = [&](int i) {
#pragma unroll
    for (int j = 0; j < TL::PRE; ++j) {
      const int idx = wt + j * 128;
      v[j] = idx < 2 * span ? window(i, idx) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // lrelu and split a window element into slot i % 2's planes: {big, small}
  // x channel group h x span rows of 16 bytes
  auto put = [&](float4 a, int idx, int i) {
    float* slot = P.smem + (a_own + (i & 1) * P.L.a_slot) / 4;
    const int r = idx >> 1, h = idx & 1;
    float4 big, small;
    split_tf32(a.x >= 0.f ? a.x : slope * a.x, big.x, small.x);
    split_tf32(a.y >= 0.f ? a.y : slope * a.y, big.y, small.y);
    split_tf32(a.z >= 0.f ? a.z : slope * a.z, big.z, small.z);
    split_tf32(a.w >= 0.f ? a.w : slope * a.w, big.w, small.w);
    *reinterpret_cast<float4*>(slot + (h * P.L.span + r) * 4) = big;
    *reinterpret_cast<float4*>(slot + ((2 + h) * P.L.span + r) * 4) = small;
  };
  auto split = [&](int i) {
#pragma unroll
    for (int j = 0; j < TL::PRE; ++j) {
      const int idx = wt + j * 128;
      if (idx < 2 * span) put(v[j], idx, i);
    }
    for (int idx = TL::PRE * 128 + wt; idx < 2 * span; idx += 128) put(window(i, idx), idx, i);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // the weight step `ahead` steps after step i (this conv's, or the next
  // conv's first), into the slot of step i - 1 once both warpgroups are done
  // with it
  auto load_weights = [&](int i, int ahead) {
    const int j = i + ahead;
    const float* src_w = j < total ? wb + (size_t)(j % n_steps) * 16 * k * NB
                         : next_wb == nullptr ? nullptr
                                              : next_wb + (size_t)(j - total) * 16 * next_k * NB;
    if (src_w == nullptr) return;
    const int kk = j < total ? k : next_k;
    const int slot = (P.u + ahead) % NBS;
    if (P.u + ahead >= NBS) mbar_wait(empty + 8 * slot, ((P.u + ahead) / NBS - 1) & 1);
    mbar_expect_tx(full + 8 * slot, 64u * kk * NB);
    bulk_load(b_ring + slot * P.L.b_slot, src_w, 64u * kk * NB, full + 8 * slot);
  };
  // row of accumulator half (0: g, 1: g + 8) of m64 tile m at rows r0 on
  auto row_of = [&](int r0, int m, int half) { return r0 + m * 64 + warp * 16 + g + 8 * half; };
  // the sum starts at the bias, plus dst's rows where the conv adds to them
  auto start = [&](int r0) {
#pragma unroll
    for (int m = 0; m < TL::MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = row_of(r0, m, half);
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int col = n0 + j * 8 + 2 * t;
          float2 a = make_float2(bias[col], bias[col + 1]);
          if (accumulate && l < hi) {
            const float2 o = *reinterpret_cast<const float2*>(dst + (size_t)l * C + col);
            a = make_float2(o.x + a.x, o.y + a.y);
          }
          acc[m][4 * j + 2 * half] = a.x;
          acc[m][4 * j + 2 * half + 1] = a.y;
        }
      }
  };
  // rows outside [0, T) are zero after every conv (and dst's rows there are
  // zero, so the residual keeps them so)
  auto finish = [&](int r0) {
#pragma unroll
    for (int m = 0; m < TL::MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = row_of(r0, m, half);
        if (l >= hi) continue;
        const int gr = g0 + l;
        const bool in_seq = gr >= 0 && gr < T;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
          *reinterpret_cast<float2*>(dst + (size_t)l * C + n0 + j * 8 + 2 * t) =
              in_seq ? make_float2(acc[m][4 * j + 2 * half], acc[m][4 * j + 2 * half + 1])
                     : make_float2(0.f, 0.f);
      }
  };

  read_ahead(0);
  split(0);
  read_ahead(1);
  turn_open(wg);
  for (int i = 0; i < total; ++i) {
    const int s = i % n_steps;
    const int r0 = row0(i);
    const int slot = P.u % NBS;
    wg_sync(wg);
    mbar_wait(full + 8 * slot, (P.u / NBS) & 1);
    const uint32_t a_base = P.base + a_own + (i & 1) * P.L.a_slot;
    const uint32_t b_base = b_ring + slot * P.L.b_slot;
    turn_wait(wg);
    reg_fence(part);
    wg_fence();
    for (int tap = 0; tap < k; ++tap) {
      const uint64_t bb = desc(b_base + tap * 4 * NB * 16, NB * 16);
      const uint64_t bs = desc(b_base + (tap * 4 + 2) * NB * 16, NB * 16);
      // (every m64 tile, those past the conv's rows too: a wgmma under a
      // branch the compiler cannot prove uniform is serialized)
#pragma unroll
      for (int m = 0; m < TL::MT; ++m) {
        const uint32_t a = a_base + (m * 64 + tap * d) * 16;
        const uint64_t ab = desc(a, plane), as = desc(a + 2 * plane, plane);
        wgmma_tf32(part[m], as, bb, tap);
        wgmma_tf32(part[m], ab, bs, 1);
        wgmma_tf32(part[m], ab, bb, 1);
      }
    }
    wg_commit();
    turn_pass(wg);
    if (tid == 0) load_weights(i, NBS - 1);  // after the wgmmas: see mbar_wait
    if (i + 1 < total) split(i + 1);
    if (i + 2 < total) read_ahead(i + 2);
    if (s == 0) start(r0);
    wg_wait<0>();
    reg_fence(part);
    if (wt == 0) mbar_arrive(empty + 8 * slot);
#pragma unroll
    for (int m = 0; m < TL::MT; ++m)
#pragma unroll
      for (int e = 0; e < TL::NACC; ++e) acc[m][e] += part[m][e];
    if (s == n_steps - 1) finish(r0);
    ++P.u;
  }
  turn_close(wg);
}

template <int NB>
__global__ void __launch_bounds__(NTH, 1) stage_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* out, float* scratch, StageArgs args) {
  extern __shared__ __align__(128) float smem[];
  const int C = args.C, T = args.T, tile = args.tile, halo = args.halo;
  const int W = tile + 2 * halo;
  Pipe P{smem, smem_u32(smem), stage_smem<NB>(args.ks[N_STACKS - 1], args.dil[N_ROUNDS - 1]), 0};
  const int rank = blockIdx.x % args.cluster;
  const int cid = blockIdx.x / args.cluster;
  const int n_clusters = gridDim.x / args.cluster;
  const int n0 = rank * NB;
  float* xres = scratch + (size_t)cid * 2 * W * C;
  float* tmp = xres + (size_t)W * C;
  const int tiles_t = (T + tile - 1) / tile;
  const int n_jobs = args.B * tiles_t;
  constexpr int Q = NB / 4;  // float4 per row of the block's channels
  // conv (packed offset off, kernel size k)'s weights of this block's channels
  auto conv_w = [&](size_t off, int k) { return w + off + (size_t)rank * 2 * k * C * NB; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tiling<NB>::NBS; ++s) {
      mbar_init(P.base + P.L.full + 8 * s, 1);
      mbar_init(P.base + P.L.empty + 8 * s, 2);  // a thread of each warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first conv's first weight steps (a conv has at least 4)
    for (int s = 0; cid < n_jobs && s < Tiling<NB>::NBS - 1; ++s) {
      const uint32_t bytes = 64u * args.ks[0] * NB, bar = P.base + P.L.full + 8 * s;
      mbar_expect_tx(bar, bytes);
      bulk_load(P.base + s * P.L.b_slot, conv_w(0, args.ks[0]) + (size_t)s * bytes / 4, bytes,
                bar);
    }
  }
  __syncthreads();

  for (int job = cid; job < n_jobs; job += n_clusters) {
    const int b = job / tiles_t;
    const int t0 = (job - b * tiles_t) * tile;
    const int g0 = t0 - halo;
    const int n_out = min(tile, T - t0);
    const float* xb = x + (size_t)b * T * C;
    float* ob = out + (size_t)b * T * C;
    const bool more = job + n_clusters < n_jobs;
    size_t w_off = 0;
    int conv = 0;
    for (int s = 0; s < N_STACKS; ++s) {
      const int k = args.ks[s];
      const size_t conv_size = (size_t)k * C * C * 2;
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
        conv_pass<NB>(xres, tmp, false, conv_w(w_off, k), bias + (size_t)conv * C,
                      conv_w(w_off + conv_size, k), k, C, n0, k, d, lo, hi, W, g0, T,
                      args.slope, P);
        w_off += conv_size;
        ++conv;
        cluster_sync();
        lo += (k - 1) / 2;
        hi -= (k - 1) / 2;
        // the next conv: this stack's next round, the next stack's first, or
        // the next tile's first
        const float* next_wb = nullptr;
        int next_k = k;
        if (r + 1 < N_ROUNDS) {
          next_wb = conv_w(w_off + conv_size, k);
        } else if (s + 1 < N_STACKS) {
          next_k = args.ks[s + 1];
          next_wb = conv_w(w_off + conv_size, next_k);
        } else if (more) {
          next_k = args.ks[0];
          next_wb = conv_w(0, next_k);
        }
        conv_pass<NB>(tmp, xres, true, conv_w(w_off, k), bias + (size_t)conv * C, next_wb,
                      next_k, C, n0, k, 1, lo, hi, W, g0, T, args.slope, P);
        w_off += conv_size;
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
  const int smem = stage_smem<NB>(args.ks[N_STACKS - 1], args.dil[N_ROUNDS - 1]).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(stage_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
cudaError_t launch(const float* x, const float* w, const float* bias, float* out,
                   float* scratch, const StageArgs& args, int grid, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<NB>(args, grid, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, stage_kernel<NB>, x, w, bias, out, scratch, args);
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
  if (!(a.B > 0 && a.T > 0 && a.tile > 0 && a.cluster >= 1 && a.cluster <= 8 &&
        (nb == 32 || nb == 64 || nb == 128) && nb * a.cluster == a.C && a.ks[0] >= 1 &&
        a.ks[0] <= a.ks[1] && a.ks[1] <= a.ks[2] && a.dil[0] >= 1 && a.dil[0] <= a.dil[1] &&
        a.dil[1] <= a.dil[2] && a.halo >= stack_halo(a.ks[2], a.dil)))
    return false;
  const int bytes = nb == 128 ? stage_smem<128>(a.ks[2], a.dil[2]).bytes
                    : nb == 64 ? stage_smem<64>(a.ks[2], a.dil[2]).bytes
                               : stage_smem<32>(a.ks[2], a.dil[2]).bytes;
  return bytes <= SMEM_LIMIT;
}

}  // namespace

// x, out (B, T, C); w the 18 convs' TF32 (big, small) pairs packed for
// blocks of NB = C / cluster channels, conv by conv (k C C 2 floats each,
// in StageWeights order): (C / NB, C / 8, k, {big, small}, 2, NB, 4), the
// weight of tap, input channel 8 s + 4 h + e, output channel r NB + n at
// [r, s, tap, ., h, n, e]; bias (18, C); scratch (grid / cluster) * 2 *
// (tile + 2 * halo) * C floats.  NB is 64 or 32, clusters of at most 8
// blocks (Hopper's portable size); kernel sizes and dilations ascending;
// x 16-byte aligned.
extern "C" int hifigan_stage_f32(const void* x, const void* w, const void* bias, void* out,
                                 void* scratch, int B, int T, int C, int k0, int k1, int k2,
                                 int d0, int d1, int d2, int tile, int halo, int cluster,
                                 int grid, float slope, void* stream) {
  const StageArgs args{B, T, C, tile, halo, cluster, {k0, k1, k2}, {d0, d1, d2}, slope};
  if (!valid(args) || grid <= 0 || grid % cluster != 0) return (int)cudaErrorInvalidValue;
  const auto* xx = static_cast<const float*>(x);
  const auto* ww = static_cast<const float*>(w);
  const auto* bb = static_cast<const float*>(bias);
  auto* oo = static_cast<float*>(out);
  auto* ss = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (C / cluster == 128) return (int)launch<128>(xx, ww, bb, oo, ss, args, grid, st);
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
  if (C / cluster == 128) return (int)max_clusters<128>(args, nn);
  if (C / cluster == 64) return (int)max_clusters<64>(args, nn);
  return (int)max_clusters<32>(args, nn);
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// BigVGAN's alias-free SnakeBeta activation in one launch, f32.
//
// Replaces toucan_tpu/kernels/pallas_aliasfree.py::fused_alias_free_snake_interior
// (the Pallas kernel _kernel).  Per channel, with the four 7-tap phase
// filters of the 12-tap kaiser_sinc_filter(0.25, 0.3, 12) (up0, up1,
// dn_even, dn_odd, tap p at time offset p - 3, as
// toucan_tpu/nn/alias_free.py::_phase_filters splits them):
//
//   y_e[v] = sum_p up0[p] x[v + p - 3]     y_o[v] = sum_p up1[p] x[v + p - 3]
//   s_e = snake(y_e), s_o = snake(y_o),    snake(y) = y + sin^2(e^alpha y) / (e^beta + 1e-9)
//   z[u]   = sum_p dn_even[p] s_e[u + p - 3] + dn_odd[p] s_o[u + p - 3]
//
// which is upsample2 -> snake_beta -> downsample2 with the 2x signal kept
// as its even and odd branches.  Edges are replicate-padded as the
// reference resamplers pad them: x is clamped to [0, T); the 2x signal is
// clamped at its own level, so s_e and s_o left of 0 are s_e[0] and right
// of T - 1 are s_o[T - 1].  One launch computes every sample.
//
// What bounds it on the H100.  Bytes: each output reads one f32 and writes
// one (8 bytes), 2.94 ms over the 73 activations of a 2048-frame BigVGAN
// call at 3.35 TB/s.  Instruction issue nearly as much: each output needs
// two snakes (a sine each) and 24 FIR multiply-adds, ~45 instructions, which
// at 132 SMs x 4 issues a clock is ~2 ms for the same call.  So the design
// saves instructions as well as bytes:
//  - Taps fixed at compile time.  Every FIR loop is unrolled, so each tap
//    index is a constant and each tap an operand of FFMA read from the
//    kernel's parameter bank (the struct Taps passed by value); no tap sits
//    in a register array indexed at run time, none in local memory.
//  - A warp owns a run of one channel (one row of time, `seg_chunks`
//    chunks of 256 samples) and walks it chunk by chunk.  A lane holds 8
//    consecutive samples in registers: two float4 loads, two float4
//    stores, where the row is 16-byte aligned; other rows, and the ragged
//    end of a row, take scalar accesses in the same kernel.
//  - Halos by shuffle, each sample read once.  A lane's 16 snakes need 3 x
//    values on each side, its 8 outputs 3 snake values of each branch on
//    each side; they come from the neighbouring lanes by __shfl_sync, and
//    lane 0 / lane 31 take theirs from the chunk before / after, carried
//    in registers.  So each warp evaluates 2 snakes per output plus 10 at
//    each end of its run (computed one per lane), and there is no block
//    barrier: the outputs of chunk i - 1 are formed while chunk i's snakes
//    supply their right halo, and chunk i + 2 is already loading.
//  - Fill the card: `kernels/aliasfree.py::snake_geometry` picks the run
//    length so that the runs fill every warp slot the card has (persistent
//    warps walk runs in turn where there are more), weighing the ends'
//    extra work against idle slots.  Four blocks of 4 warps an SM at 128
//    registers a thread: at 96 (five blocks) values spill to local memory,
//    and the kernel ran slower (scripts/k5_variants.py).
//  - The sine: sin(v) = __sinf(v - k 2 pi), k = rint(v / 2 pi), with 2 pi
//    split into two constants (6.28125, exact in 8 bits, and the rest), so
//    the reduced argument is within ~3e-7 of exact for |v| <= 8192, where
//    __sinf (the SFU) is accurate to ~4e-7.  Larger arguments take sinf.
//    ~9 instructions a snake instead of sinf's ~25.
//
// Layout: x and z are (B, C, T) contiguous, time innermost, as the BigVGAN
// convs leave them.
//
// bf16 (alias_free_snake_bf16).  Under the JAX package's dtype=bfloat16 the
// Pallas kernel streams bf16 in and out, computes in f32, and takes e^alpha
// and 1 / (e^beta + 1e-9) rounded to x's dtype (kernels/pallas_aliasfree.py:
// 55-58, 115, 136-137).  The same kernel, templated on the element type,
// does that: x is widened to f32 as it is loaded, e^alpha and the inverse
// are rounded to bf16 and back, every sum and snake runs in f32, and each
// output is rounded to bf16 once as it is stored.  The work is bytes-bound
// at either width, and bf16 halves them (4 bytes an output): a lane's 8
// samples are one 16-byte load and one 16-byte store, where the row is
// 16-byte aligned (T % 8 == 0).  The polyphase, warp-run and halo design is
// the f32 kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PER_LANE = 8;              // samples a lane holds per chunk
constexpr int CHUNK = 32 * PER_LANE;     // samples per chunk of a warp
constexpr int WARPS = 4;                 // warps per block
constexpr int NT = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;            // blocks per SM: 128 registers, none spilled
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-9f;
constexpr bool FAST_SINE = true;         // reduced __sinf; else sinf
constexpr bool SHUFFLE_HALOS = true;     // halos by __shfl_sync; else through shared memory
constexpr float FAST_SINE_LIMIT = 8192.f;

struct Taps {
  float up0[7], up1[7], dn_even[7], dn_odd[7];
};

struct Geometry {
  int T, C, items, segs_per_row, seg_chunks, vector;
};

// sin(v) for |v| <= FAST_SINE_LIMIT: v reduced to [-pi, pi] by two
// constants, then the SFU's __sinf
__device__ __forceinline__ float reduced_sine(float v) {
  const float k = rintf(v * 0.159154943091895336f);
  float r = fmaf(-k, 6.28125f, v);
  r = fmaf(-k, 1.93530717958647692e-3f, r);
  return __sinf(r);
}

// sinf out of line: its slow path (a stack frame) is one copy, called only
// where an argument passes FAST_SINE_LIMIT
__device__ __noinline__ float accurate_sine(float v) { return sinf(v); }

__device__ __forceinline__ float sine(float v) {
  if constexpr (FAST_SINE)
    return fabsf(v) <= FAST_SINE_LIMIT ? reduced_sine(v) : accurate_sine(v);
  else
    return sinf(v);
}

// x as f32, from f32 or from bf16 (its 16 bits are the high half of an f32)
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}
__device__ __forceinline__ float widen(uint32_t pair, int hi) {
  return __uint_as_float(hi ? pair & 0xffff0000u : pair << 16);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ uint16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(uint16_t* p, float v) { *p = to_bf16(v); }
// v as the element type holds it: unchanged for f32, rounded to bf16
template <typename Elem>
__device__ __forceinline__ float as_stored(float v) {
  if constexpr (sizeof(Elem) == 2)
    return __uint_as_float((uint32_t)to_bf16(v) << 16);
  else
    return v;
}

__device__ __forceinline__ float snake(float y, float a, float ib) {
  const float sn = sine(a * y);
  return fmaf(ib, sn * sn, y);
}

// The chunk path's snake: the reduced sine whatever the argument, and
// `big` set where that was wrong (the caller redoes those with `snake`).
__device__ __forceinline__ float snake_chunk(float y, float a, float ib, bool& big) {
  if constexpr (FAST_SINE) {
    const float v = a * y;
    big |= fabsf(v) > FAST_SINE_LIMIT;
    const float sn = reduced_sine(v);
    return fmaf(ib, sn * sn, y);
  } else {
    return snake(y, a, ib);
  }
}

// One snake sample of the 2x signal at v (odd: branch s_o), edges as the
// reference pads them; x read by scalar loads.  The sum runs over the same
// taps in the same order as the chunk path's, so the two agree bit for bit.
template <typename Elem>
__device__ float snake_at(const Elem* __restrict__ xr, int T, int v, bool odd, float a,
                          float ib, const Taps& k) {
  if (v < 0) {
    v = 0;
    odd = false;
  }
  if (v >= T) {
    v = T - 1;
    odd = true;
  }
  float y = 0.f;
#pragma unroll
  for (int p = 0; p < 7; ++p)
    y = fmaf(odd ? k.up1[p] : k.up0[p], ld(xr + min(max(v + p - 3, 0), T - 1)), y);
  return snake(y, a, ib);
}

// The left neighbour's `cur`; lane 0 gets lane 31's `prev` (the chunk before).
__device__ __forceinline__ float from_left(float cur, float prev, int lane) {
  const float mine = lane == 31 ? prev : cur;
  if constexpr (SHUFFLE_HALOS) {
    return __shfl_sync(FULL, mine, (lane + 31) & 31);
  } else {
    __shared__ float buf[WARPS][32];
    float* b = buf[threadIdx.x >> 5];
    b[lane] = mine;
    __syncwarp();
    const float v = b[(lane + 31) & 31];
    __syncwarp();
    return v;
  }
}

// The right neighbour's `cur`; lane 31 gets lane 0's `next` (the chunk after).
__device__ __forceinline__ float from_right(float cur, float next, int lane) {
  const float mine = lane == 0 ? next : cur;
  if constexpr (SHUFFLE_HALOS) {
    return __shfl_sync(FULL, mine, (lane + 1) & 31);
  } else {
    __shared__ float buf[WARPS][32];
    float* b = buf[threadIdx.x >> 5];
    b[lane] = mine;
    __syncwarp();
    const float v = b[(lane + 1) & 31];
    __syncwarp();
    return v;
  }
}

// x at p .. p + 7, clamped to T - 1; 16-byte loads where `vec` (the row
// 16-byte aligned and T a multiple of a load's elements) and they lie
// inside the row: two float4 of f32, one of 8 bf16.
__device__ __forceinline__ void load8(float (&v)[PER_LANE], const uint16_t* __restrict__ xr,
                                      int p, int T, bool vec) {
  if (vec && p + 7 < T) {
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(xr + p));
    const uint32_t w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) v[j] = widen(w[j / 2], j & 1);
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) v[j] = ld(xr + min(p + j, T - 1));
  }
}

__device__ __forceinline__ void load8(float (&v)[PER_LANE], const float* __restrict__ xr, int p,
                                      int T, bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = p + 4 * h;
    if (vec && q + 3 < T) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xr + q));
      v[4 * h] = f.x;
      v[4 * h + 1] = f.y;
      v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * h + j] = __ldg(xr + min(q + j, T - 1));
    }
  }
}

// x at e .. e + 2, clamped, in v[0..2]: the right halo of a run's last chunk.
template <typename Elem>
__device__ __forceinline__ void load_tail(float (&v)[PER_LANE], const Elem* __restrict__ xr, int e,
                                          int T) {
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) v[j] = j < 3 ? ld(xr + min(e + j, T - 1)) : 0.f;
}

__device__ __forceinline__ void store8(const float (&v)[PER_LANE], uint16_t* __restrict__ zr,
                                       int p, int T, bool vec) {
  if (vec && p + 7 < T) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (uint32_t)to_bf16(v[2 * j]) | ((uint32_t)to_bf16(v[2 * j + 1]) << 16);
    *reinterpret_cast<uint4*>(zr + p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (p + j < T) st(zr + p + j, v[j]);
  }
}

__device__ __forceinline__ void store8(const float (&v)[PER_LANE], float* __restrict__ zr, int p,
                                       int T, bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = p + 4 * h;
    if (vec && q + 3 < T) {
      *reinterpret_cast<float4*>(zr + q) =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q + j < T) zr[q + j] = v[4 * h + j];
    }
  }
}

template <typename Elem>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) alias_free_snake_kernel(
    const Elem* __restrict__ x, const Elem* __restrict__ alpha, const Elem* __restrict__ beta,
    Elem* __restrict__ z, const Taps k, const Geometry g) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * WARPS;
  const int T = g.T;
  const bool vec = g.vector != 0;
  for (int item = blockIdx.x * WARPS + (threadIdx.x >> 5); item < g.items; item += n_warps) {
    const int row = item / g.segs_per_row;
    const int seg = item - row * g.segs_per_row;
    const int ch = row % g.C;
    const float a = as_stored<Elem>(expf(ld(alpha + ch)));
    const float ib = as_stored<Elem>(1.f / (expf(ld(beta + ch)) + EPS));
    const Elem* xr = x + (size_t)row * T;
    Elem* zr = z + (size_t)row * T;
    const int S = seg * g.seg_chunks * CHUNK;                 // the run's first sample
    const int nch = min(g.seg_chunks, (T - S + CHUNK - 1) / CHUNK);
    const int E = S + nch * CHUNK;                            // past its last chunk

    // left of the run: x at S-3 .. S-1, and s_e at S-2, S-1, s_o at S-3 .. S-1
    // (one snake a lane), held by every lane and read from lane 31
    float xl[3], sp[5];
#pragma unroll
    for (int j = 0; j < 3; ++j) xl[j] = ld(xr + max(S - 3 + j, 0));
    {
      const float h =
          lane < 5 ? snake_at(xr, T, lane < 2 ? S - 2 + lane : S - 5 + lane, lane >= 2, a, ib, k)
                   : 0.f;
#pragma unroll
      for (int j = 0; j < 5; ++j) sp[j] = __shfl_sync(FULL, h, j);
    }

    float xc[PER_LANE], xn[PER_LANE], sc_e[PER_LANE], sc_o[PER_LANE];
    load8(xc, xr, S + PER_LANE * lane, T, vec);
    if (nch > 1)
      load8(xn, xr, S + CHUNK + PER_LANE * lane, T, vec);
    else
      load_tail(xn, xr, E, T);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) sc_e[j] = sc_o[j] = 0.f;

    // iteration i: the snakes of chunk i (i < nch; at i == nch the run's
    // right halo), then the outputs of chunk i - 1
    for (int i = 0; i <= nch; ++i) {
      float sn_e[PER_LANE], sn_o[PER_LANE];
      if (i < nch) {
        float xnn[PER_LANE];
        if (i + 2 < nch)
          load8(xnn, xr, S + (i + 2) * CHUNK + PER_LANE * lane, T, vec);
        else
          load_tail(xnn, xr, E, T);
        float X[PER_LANE + 6];  // x at offsets -3 .. 10 of the lane's first sample
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) X[3 + j] = xc[j];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          X[j] = from_left(xc[PER_LANE - 3 + j], xl[j], lane);
          X[PER_LANE + 3 + j] = from_right(xc[j], xn[j], lane);
        }
        bool big = false;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          float ye = 0.f, yo = 0.f;
#pragma unroll
          for (int p = 0; p < 6; ++p) ye = fmaf(k.up0[p], X[j + p], ye);
#pragma unroll
          for (int p = 1; p < 7; ++p) yo = fmaf(k.up1[p], X[j + p], yo);
          sn_e[j] = snake_chunk(ye, a, ib, big);
          sn_o[j] = snake_chunk(yo, a, ib, big);
        }
        if (__any_sync(FULL, big)) {  // an argument past the reduction's range
#pragma unroll
          for (int j = 0; j < PER_LANE; ++j) {
            float ye = 0.f, yo = 0.f;
#pragma unroll
            for (int p = 0; p < 6; ++p) ye = fmaf(k.up0[p], X[j + p], ye);
#pragma unroll
            for (int p = 1; p < 7; ++p) yo = fmaf(k.up1[p], X[j + p], yo);
            if (fabsf(a * ye) > FAST_SINE_LIMIT) sn_e[j] = snake(ye, a, ib);
            if (fabsf(a * yo) > FAST_SINE_LIMIT) sn_o[j] = snake(yo, a, ib);
          }
        }
        const int c0 = S + i * CHUNK;
        if (c0 + CHUNK > T) {  // past the row's end both branches are s_o[T - 1]
          const float f = snake_at(xr, T, T - 1, true, a, ib, k);
#pragma unroll
          for (int j = 0; j < PER_LANE; ++j)
            if (c0 + PER_LANE * lane + j >= T) sn_e[j] = sn_o[j] = f;
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) xl[j] = xc[PER_LANE - 3 + j];
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          xc[j] = xn[j];
          xn[j] = xnn[j];
        }
      } else {
        // s_e at E .. E+2 and s_o at E, E+1, one snake a lane, for lane 0
        const float h =
            lane < 5 ? snake_at(xr, T, lane < 3 ? E + lane : E + lane - 3, lane >= 3, a, ib, k)
                     : 0.f;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) sn_e[j] = sn_o[j] = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) sn_e[j] = __shfl_sync(FULL, h, j);
#pragma unroll
        for (int j = 0; j < 2; ++j) sn_o[j] = __shfl_sync(FULL, h, 3 + j);
      }

      if (i > 0) {
        // snake samples at offsets -3 .. 10 of the lane's first output
        float se[PER_LANE + 6], so[PER_LANE + 6];
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          se[3 + j] = sc_e[j];
          so[3 + j] = sc_o[j];
        }
        se[0] = so[PER_LANE + 5] = 0.f;  // dn_even[0] = dn_odd[6] = 0
        se[1] = from_left(sc_e[PER_LANE - 2], sp[0], lane);
        se[2] = from_left(sc_e[PER_LANE - 1], sp[1], lane);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          so[j] = from_left(sc_o[PER_LANE - 3 + j], sp[2 + j], lane);
          se[PER_LANE + 3 + j] = from_right(sc_e[j], sn_e[j], lane);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) so[PER_LANE + 3 + j] = from_right(sc_o[j], sn_o[j], lane);
        float out[PER_LANE];
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int p = 1; p < 7; ++p) acc = fmaf(k.dn_even[p], se[j + p], acc);
#pragma unroll
          for (int p = 0; p < 6; ++p) acc = fmaf(k.dn_odd[p], so[j + p], acc);
          out[j] = acc;
        }
        store8(out, zr, S + (i - 1) * CHUNK + PER_LANE * lane, T, vec);
        sp[0] = sc_e[PER_LANE - 2];
        sp[1] = sc_e[PER_LANE - 1];
#pragma unroll
        for (int j = 0; j < 3; ++j) sp[2 + j] = sc_o[PER_LANE - 3 + j];
      }
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        sc_e[j] = sn_e[j];
        sc_o[j] = sn_o[j];
      }
    }
  }
}

}  // namespace

namespace {

template <typename Elem>
int launch(const void* x, const void* alpha, const void* beta, void* z, const float* taps, int B,
           int T, int C, int seg_chunks, int blocks, int vector, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || seg_chunks <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long cpr = (T + (long long)CHUNK - 1) / CHUNK;
  const long long segs = (cpr + seg_chunks - 1) / seg_chunks;
  const long long items = (long long)B * C * segs;
  if (items > 0x7fffffffLL || (long long)seg_chunks * CHUNK > 0x7fffffffLL - T)
    return (int)cudaErrorInvalidValue;
  if (vector && (T % (16 / (int)sizeof(Elem)) != 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
                 reinterpret_cast<uintptr_t>(z) % 16))
    return (int)cudaErrorInvalidValue;
  Taps k;
  for (int p = 0; p < 7; ++p) {
    k.up0[p] = taps[p];
    k.up1[p] = taps[7 + p];
    k.dn_even[p] = taps[14 + p];
    k.dn_odd[p] = taps[21 + p];
  }
  const Geometry g{T, C, (int)items, (int)segs, seg_chunks, vector};
  alias_free_snake_kernel<Elem><<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Elem*>(x), static_cast<const Elem*>(alpha),
      static_cast<const Elem*>(beta), static_cast<Elem*>(z), k, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x, z (B, C, T) contiguous; alpha, beta (C,) log-scale SnakeBeta
// parameters, of x's type (f32, or bf16 for the _bf16 entry); taps the
// four 7-tap phase filters (up0, up1, dn_even, dn_odd) in host memory.
// Runs of seg_chunks chunks of 256 samples, walked by blocks x 4 warps in
// turn; vector: x and z 16-byte aligned and T a multiple of 4 (f32) or 8
// (bf16).
extern "C" int alias_free_snake_f32(const void* x, const void* alpha, const void* beta, void* z,
                                    const float* taps, int B, int T, int C, int seg_chunks,
                                    int blocks, int vector, void* stream) {
  return launch<float>(x, alpha, beta, z, taps, B, T, C, seg_chunks, blocks, vector, stream);
}

extern "C" int alias_free_snake_bf16(const void* x, const void* alpha, const void* beta, void* z,
                                     const float* taps, int B, int T, int C, int seg_chunks,
                                     int blocks, int vector, void* stream) {
  return launch<uint16_t>(x, alpha, beta, z, taps, B, T, C, seg_chunks, blocks, vector, stream);
}

// Blocks of the kernel (bf16: of its bf16 instantiation) the current
// device runs at once on one SM.
extern "C" int alias_free_snake_blocks_per_sm(void* n, int bf16) {
  return (int)(bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          static_cast<int*>(n), alias_free_snake_kernel<uint16_t>, NT, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          static_cast<int*>(n), alias_free_snake_kernel<float>, NT, 0));
}

extern "C" const char* toucan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

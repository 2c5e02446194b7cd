// Microbenchmark of the megakernel's small linear-algebra formulations
// (ROADMAP kernel K9).
//
// Replaces tools/dot_microbench.py::main.timed (its pallas_call at :64)
// over the bodies k_lane16 (:107), k_sub16 (:123), k_extract (:143),
// k_extract_bf16 (:156), k_elemq (:172) and k_minmask (:201): each runs N
// dependency-chained steps acc = f(acc) on an (S, T) float32 accumulator
// and writes acc[0:8] to the (8, T) output. Plain version beside it:
// raytracingweekend_tpu_torch/tools/dot_microbench.py::microbench_reference.
//
// Bodies (one step):
//   lane16   acc = mx (S, 16) @ (acc[0:16] * 1e-30 + 1)
//   sub16    the same product with the matrix stored (16, S)
//   extract  acc = acc * 0.5 + pad(at (24, S) @ (acc == 0)), rows past 24
//            padded with zeros
//   elemq    the moving-sphere quadratic of the table's row s against a
//            ray made from acc[0] (sqrtf, near-else-far root, 3e37 miss)
//   minmask  acc = acc + (acc == column min)
// Units: the TPU's "f32 default" (one reduced-precision MXU pass) runs on
// the TF32 tensor cores (mma.sync m16n8k8; inputs rounded by cvt.rna.tf32,
// round to nearest, ties away from zero); "f32 HIGHEST" runs on the FP32
// pipes with every multiply-add an fmaf (built with -fmad=false); "bf16" on
// the BF16 tensor cores (mma.sync m16n8k16) with float32 accumulation.
//
// Every body is independent per column of the accumulator, and a step of
// a column reads only rows 0-15 (lane16, sub16), row 0 (elemq), its column
// minimum (minmask) or the 24 sums over all its rows (extract). So a block
// owns kCols = 8 columns and keeps their S rows in shared memory through
// all N steps, with the body's table beside it; T / 8 blocks of 16 warps.
// Each step writes every element of the accumulator to shared memory, as
// the tool's acc[...] = f(...) does, so rows that only later steps would
// read stay live. What fits a block's shared memory bounds S (Smem). What
// a step passes between threads (the right-hand side, row 0) alternates
// between two buffers with the step's parity, so one block barrier a step
// orders it (two for extract, whose sums are written and read within the
// step). minmask, whose every element the next step reads, gives each
// column to two warps: a thread reads its first kRegOwn elements back from
// copies in its registers, and the two warps' minima meet through a named
// barrier of their 64 threads, no block barrier.
//
// FP32 extract sums in a fixed order: each warp sums its S / 16 rows in
// row order (fmaf from 0), then the owner of a sum adds the 16 warps' in
// warp order; the plain version takes the same order. The tensor-core
// rows' products are exact (0/1 masks, or 1.0 right-hand sides), their
// float32 sums in the tensor cores' order, within the stated tolerance of
// the plain version's exactly rounded sum.
//
// What bounds it: nothing leaves the chip between steps, so operations:
// 2 S 16 T flops a lane16 / sub16 step, 2 24 S T an extract step (on the
// tensor cores in TF32 / BF16, else the FP32 pipes), ~28 S T an elemq step
// and 3 S T a minmask step on the FP32 pipes: microseconds of work a step
// at the tool's S = 512, T = 2048. The first version ran 16 columns on
// one 8-warp block (128 blocks: 128 of the card's 132 SMs, 8 of an SM's 64
// warps) with two to four block barriers a step, at 1-14% of these
// bounds: a step was its own latency. This design runs 8 columns a block
// of 16 warps (256 blocks, two an SM: every SM, 32 warps an SM), a
// quarter of the work a thread a step, fewer barriers, the matrix rows as
// 16-byte loads, mma.sync tensor-core tiles whose constant A fragments
// stay in registers and whose B fragments are loaded once a step, the
// FP32 extract's 512-term sums split over the 16 warps. Its time a step
// is shared-memory traffic and barrier latency, so what stays in
// registers and which threads wait for which count most (PERF.md).
// (Splitting a column
// block's rows over a thread-block cluster instead, with the cross-row
// dependency through distributed shared memory and one cluster barrier a
// step, ran 1.2-3x slower than the first version on six of nine rows:
// PERF.md.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sweep.cuh"

namespace {

constexpr int kCols = 8;       // accumulator columns a block owns
constexpr int kThreads = 512;  // 16 warps; thread t: column t % 8, rows
                               // t / 8 + 64 i
constexpr int kWarps = kThreads / 32;
constexpr int kRowStep = kThreads / kCols;
constexpr int kAttr = 24;      // extract's matrix rows (padded to 32)
constexpr int kAttrPad = 32;
constexpr int kSphStride = 128;  // the tool's sph row width
constexpr int kSph = 12;       // elemq's staged lanes a row: three float4
constexpr int kRegS = 1024;    // rows whose values a thread keeps in
                               // registers: minmask's a thread's first 16
constexpr int kRegOwn = kRegS / kRowStep;
// the tensor-core rows' constant A fragments a warp keeps in registers:
// lane16 / sub16 its first 4 16-row tiles (all of them up to S = 1024);
// extract its first 4 k steps (all of them up to S = 512 in TF32, 1024 in
// BF16); the rest read from shared memory each step
constexpr int kRegTiles = kRegS / 16 / kWarps;
constexpr int kRegKs = 4;

enum Body { kLane16 = 0, kSub16 = 1, kExtract = 2, kElemq = 3, kMinmask = 4 };
enum Unit { kFp32 = 0, kTf32 = 1, kBf16 = 2 };

__device__ __forceinline__ float tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// D += A B on the tensor cores, one warp: m16n8k8 TF32 (a: 4, b: 2
// registers of TF32 bits) or m16n8k16 BF16 (a: 4, b: 2 registers of two
// bf16 each, the lower k in the low half).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned mask_tf32(float v) {
  return v == 0.f ? 0x3f800000u : 0u;
}
__device__ __forceinline__ unsigned mask_bf16x2(float lo, float hi) {
  return (lo == 0.f ? 0x3f80u : 0u) | (hi == 0.f ? 0x3f800000u : 0u);
}

// The A fragment of extract's row tile mt (attribute rows 16 mt ..
// 16 mt + 15) at k step k0 from the (32, S) matrix in shared memory: TF32
// (m16n8k8) or BF16 (m16n8k16) by the matrix's element type.
template <class E>
__device__ __forceinline__ void a_fragment(unsigned (&a)[4], const E* at,
                                           int S, int mt, int k0) {
  const int lane = threadIdx.x & 31, qg = lane >> 2, qt = lane & 3;
  const int r = 16 * mt + qg;
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    const unsigned* a32 = reinterpret_cast<const unsigned*>(at);
    a[0] = a32[(r * S + k0 + 2 * qt) >> 1];
    a[1] = a32[((r + 8) * S + k0 + 2 * qt) >> 1];
    a[2] = a32[(r * S + k0 + 2 * qt + 8) >> 1];
    a[3] = a32[((r + 8) * S + k0 + 2 * qt + 8) >> 1];
  } else {
    a[0] = __float_as_uint(at[r * S + k0 + qt]);
    a[1] = __float_as_uint(at[(r + 8) * S + k0 + qt]);
    a[2] = __float_as_uint(at[r * S + k0 + qt + 4]);
    a[3] = __float_as_uint(at[(r + 8) * S + k0 + qt + 4]);
  }
}

// f(std::integral_constant<int, own>) where own < kRegOwn, else
// f(std::integral_constant<int, kRegOwn>): a runtime count as a
// compile-time one (k, the first count tried)
template <int k, class F>
__device__ __forceinline__ void with_count(int own, F& f) {
  if constexpr (k < kRegOwn) {
    if (own == k) {
      f(std::integral_constant<int, k>{});
      return;
    }
    with_count<k + 1>(own, f);
  } else {
    f(std::integral_constant<int, k>{});
  }
}

// Shared memory of one block, in floats, laid out as the kernel reads it:
// the accumulator (S, 8), then the body's: lane16 / sub16 the matrix
// (S, 16) and two right-hand sides (16 x 8); extract the matrix (32, S)
// (bfloat16 for BF16: half the words) and the warps' sums (16, 24, 8);
// elemq the table (S, 12) and two row-0 copies (8); minmask (its
// accumulator (8, S)) the column halves' minima (2 parities, 8, 2). Every
// region starts on a 16-byte boundary (S % 64 == 0).
struct Smem {
  int acc, mat, rhs, at, part, sph, row0, wmin, total;
  __host__ __device__ Smem(int body, int unit, int S) {
    acc = 0;
    mat = rhs = at = part = sph = row0 = wmin = 0;
    int n = kCols * S;
    switch (body) {
      case kLane16:
      case kSub16:
        mat = n;
        rhs = n += 16 * S;
        n += 2 * 16 * kCols;
        break;
      case kExtract:
        at = n;
        part = n += kAttrPad * S / (unit == kBf16 ? 2 : 1);
        n += kWarps * kAttr * kCols;
        break;
      case kElemq:
        sph = n;
        row0 = n += kSph * S;
        n += 2 * kCols;
        break;
      default:
        wmin = n;
        n += 2 * kCols * 2;
    }
    total = n;
  }
};

template <int kBody, int kUnit>
__global__ void __launch_bounds__(kThreads, 2)
microbench_kernel(const void* __restrict__ tab, float* __restrict__ out,
                  int S, int T, int n) {
  extern __shared__ __align__(16) float sm[];
  const Smem L(kBody, kUnit, S);
  float* acc = sm + L.acc;
  const int t = threadIdx.x;
  const int c = t & (kCols - 1);
  const int g = t >> 3;
  const int w = t >> 5;
  const int lane = t & 31;
  const int qg = lane >> 2, qt = lane & 3;   // mma fragment coordinates

  // each thread starts its own elements (rows g + 64 i of column c)
  for (int i = t; i < S * kCols; i += kThreads) {
    acc[i] = kBody == kMinmask ? 1.f : 0.f;
  }

  if constexpr (kBody == kLane16 || kBody == kSub16) {
    // mat (S, 16) row-major whatever the tool's layout; rhs[p] (16 x 8):
    // FP32 column-major (a column's 16 entries together), TF32 row-major
    float* mat = sm + L.mat;
    float* rhs = sm + L.rhs;
    const float* src = static_cast<const float*>(tab);
    for (int i = t; i < S * 16; i += kThreads) {
      const int r = i >> 4, k = i & 15;
      const float v = kBody == kLane16 ? __ldg(src + i)
                                       : __ldg(src + (size_t)k * S + r);
      mat[i] = kUnit == kTf32 ? tf32(v) : v;
    }
    // TF32: the A fragments (two k steps) of the 16-row tile mt
    auto fragments = [&](unsigned (&a)[2][4], int mt) {
      const float* m = mat + mt * 16 * 16;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        a[ks][0] = __float_as_uint(m[qg * 16 + 8 * ks + qt]);
        a[ks][1] = __float_as_uint(m[(qg + 8) * 16 + 8 * ks + qt]);
        a[ks][2] = __float_as_uint(m[qg * 16 + 8 * ks + qt + 4]);
        a[ks][3] = __float_as_uint(m[(qg + 8) * 16 + 8 * ks + qt + 4]);
      }
    };
    // the first step's right-hand side, from the zero accumulator
    if (t < 16 * kCols) {
      rhs[t] = kUnit == kTf32 ? tf32(fmaf(0.f, 1e-30f, 1.0f))
                              : fmaf(0.f, 1e-30f, 1.0f);
    }
    // the steps. TF32: the warp's (at most kRegTiles) tiles' constant A
    // fragments kept in registers, or, past S = kRegS (kWide), every
    // tile's read from shared memory each step
    auto steps = [&](auto wide) {
      constexpr bool kWide = decltype(wide)::value;
      unsigned areg[kRegTiles][2][4];
      if constexpr (kUnit == kTf32 && !kWide) {
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kRegTiles; ++q) {
          fragments(areg[q], min(w + kWarps * q, S / 16 - 1));
        }
      }
      for (int step = 0; step < n; ++step) {
        __syncthreads();
        const float* rb = rhs + (step & 1) * 16 * kCols;
        float* next = rhs + ((step + 1) & 1) * 16 * kCols;
        if constexpr (kUnit == kFp32) {
          float r16[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = reinterpret_cast<const float4*>(rb + c * 16)[q];
            r16[4 * q] = v.x;
            r16[4 * q + 1] = v.y;
            r16[4 * q + 2] = v.z;
            r16[4 * q + 3] = v.w;
          }
          for (int r = g; r < S; r += kRowStep) {
            const float4* m = reinterpret_cast<const float4*>(mat + r * 16);
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 v = m[q];
              sum = fmaf(v.x, r16[4 * q], sum);
              sum = fmaf(v.y, r16[4 * q + 1], sum);
              sum = fmaf(v.z, r16[4 * q + 2], sum);
              sum = fmaf(v.w, r16[4 * q + 3], sum);
            }
            acc[r * kCols + c] = sum;
            if (r < 16) next[c * 16 + r] = fmaf(sum, 1e-30f, 1.0f);
          }
        } else {
          unsigned b[2][2];   // [k step][register]
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            b[ks][0] = __float_as_uint(rb[(8 * ks + qt) * kCols + qg]);
            b[ks][1] = __float_as_uint(rb[(8 * ks + qt + 4) * kCols + qg]);
          }
          // tile mt's product, to the accumulator (and tile 0 to the
          // next right-hand side)
          auto tile = [&](const unsigned (&a)[2][4], int mt) {
            float d[4] = {};
            mma_tf32(d, a[0], b[0][0], b[0][1]);
            mma_tf32(d, a[1], b[1][0], b[1][1]);
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int r = mt * 16 + qg + 8 * (h >> 1);
              const int col = 2 * qt + (h & 1);
              acc[r * kCols + col] = d[h];
              if (mt == 0) {
                next[r * kCols + col] = tf32(fmaf(d[h], 1e-30f, 1.0f));
              }
            }
          };
          if constexpr (kWide) {
            for (int mt = w; mt < S / 16; mt += kWarps) {
              unsigned a[2][4];
              fragments(a, mt);
              tile(a, mt);
            }
          } else {
#pragma unroll
            for (int q = 0; q < kRegTiles; ++q) {
              const int mt = w + kWarps * q;
              if (mt >= S / 16) break;
              tile(areg[q], mt);
            }
          }
        }
      }
    };
    if (kUnit == kTf32 && S > kRegS) {
      steps(std::true_type{});
    } else {
      steps(std::false_type{});
    }
  } else if constexpr (kBody == kExtract) {
    using E = typename std::conditional<kUnit == kBf16, __nv_bfloat16,
                                        float>::type;
    E* at = reinterpret_cast<E*>(sm + L.at);   // (32, S)
    float* part = sm + L.part;                 // (16, 24, 8)
    const E* src = static_cast<const E*>(tab);
    for (int i = t; i < kAttrPad * S; i += kThreads) {
      if constexpr (kUnit == kBf16) {
        at[i] = i < kAttr * S ? src[i] : __float2bfloat16(0.f);
      } else {
        const float v = i < kAttr * S ? __ldg(src + i) : 0.f;
        at[i] = kUnit == kTf32 ? tf32(v) : v;
      }
    }
    // TF32 / BF16: the warp's first kRegKs k steps' A fragments
    // (constant), kept in registers
    constexpr int kK = kUnit == kBf16 ? 16 : 8;
    unsigned areg[kRegKs][2][4];
    if constexpr (kUnit != kFp32) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kRegKs; ++q) {
        const int k0 = min(w + kWarps * q, S / kK - 1) * kK;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) a_fragment(areg[q][mt], at, S, mt, k0);
      }
    }
    for (int step = 0; step < n; ++step) {
      __syncthreads();
      // each warp's sums over its rows: part[w] = at[:, rows] @ mask
      if constexpr (kUnit == kFp32) {
        // lane: column c, sums 6 h .. 6 h + 5, the warp's S / 16 rows in
        // row order
        const int h = lane >> 3, span = S / kWarps, lo = w * span;
        float s6[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) s6[i] = 0.f;
        for (int s = lo; s < lo + span; s += 4) {
          float m4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            m4[u] = acc[(s + u) * kCols + c] == 0.f ? 1.f : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const float4 a4 =
                *reinterpret_cast<const float4*>(at + (6 * h + i) * S + s);
            s6[i] = fmaf(a4.x, m4[0], s6[i]);
            s6[i] = fmaf(a4.y, m4[1], s6[i]);
            s6[i] = fmaf(a4.z, m4[2], s6[i]);
            s6[i] = fmaf(a4.w, m4[3], s6[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          part[(w * kAttr + 6 * h + i) * kCols + c] = s6[i];
        }
      } else {
        // warp w: the k steps w, w + 16, ... of the rows, both row tiles
        // (attribute rows 0-15, 16-31) of the 8 columns
        float d[2][4] = {};
        for (int q = 0; w + kWarps * q < S / kK; ++q) {
          const int k0 = (w + kWarps * q) * kK;
          unsigned b0, b1;
          if constexpr (kUnit == kBf16) {
            b0 = mask_bf16x2(acc[(k0 + 2 * qt) * kCols + qg],
                             acc[(k0 + 2 * qt + 1) * kCols + qg]);
            b1 = mask_bf16x2(acc[(k0 + 2 * qt + 8) * kCols + qg],
                             acc[(k0 + 2 * qt + 9) * kCols + qg]);
          } else {
            b0 = mask_tf32(acc[(k0 + qt) * kCols + qg]);
            b1 = mask_tf32(acc[(k0 + qt + 4) * kCols + qg]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            unsigned a[4];
            if (q < kRegKs) {
#pragma unroll
              for (int u = 0; u < kRegKs; ++u) {   // a register array
                if (u == q) {                      // indexed by constants
#pragma unroll
                  for (int e = 0; e < 4; ++e) a[e] = areg[u][mt][e];
                }
              }
            } else {
              a_fragment(a, at, S, mt, k0);
            }
            if constexpr (kUnit == kBf16) {
              mma_bf16(d[mt], a, b0, b1);
            } else {
              mma_tf32(d[mt], a, b0, b1);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int i = 16 * mt + qg + 8 * (h >> 1);
            if (i < kAttr) {
              part[(w * kAttr + i) * kCols + 2 * qt + (h & 1)] = d[mt][h];
            }
          }
        }
      }
      __syncthreads();
      // each element's owner: rows 0-23 add the warps' sums in warp
      // order, every row halves
      for (int r = g; r < S; r += kRowStep) {
        const float v = acc[r * kCols + c];
        if (r < kAttr) {
          float sum = part[r * kCols + c];
#pragma unroll
          for (int k = 1; k < kWarps; ++k) {
            sum = sum + part[(k * kAttr + r) * kCols + c];
          }
          acc[r * kCols + c] = fmaf(v, 0.5f, sum);
        } else {
          acc[r * kCols + c] = v * 0.5f;
        }
      }
    }
  } else if constexpr (kBody == kElemq) {
    // sph (S, 12): (cx, cy, cz, dcx), (dcy, dcz, t0, 1/dt), (r^2, 0, 0, 0)
    float* sph = sm + L.sph;
    float* row0buf = sm + L.row0;   // two acc[0] copies (8)
    const float* src = static_cast<const float*>(tab);
    for (int i = t; i < kSph * S; i += kThreads) {
      const int r = i / kSph, k = i % kSph;
      sph[i] = k < 9 ? __ldg(src + (size_t)r * kSphStride + k) : 0.f;
    }
    if (t < kCols) row0buf[t] = 0.f;   // acc[0] of the first step
    for (int step = 0; step < n; ++step) {
      __syncthreads();
      const float a0 = row0buf[(step & 1) * kCols + c];
      float* next = row0buf + ((step + 1) & 1) * kCols;
      const float ox = fmaf(a0, 1e-30f, 1.0f);
      const float oy = ox, oz = ox;
      const float dx = ox * 0.5f;
      const float dy = dx, dz = dx;
      const float tmv = ox * 0.1f;
      for (int r = g; r < S; r += kRowStep) {
        const float4* q = reinterpret_cast<const float4*>(sph + r * kSph);
        const float4 q0 = q[0], q1 = q[1], q2 = q[2];
        const float frac = (tmv - q1.z) * q1.w;
        const float cx = fmaf(frac, q0.w, q0.x);
        const float cy = fmaf(frac, q1.x, q0.y);
        const float cz = fmaf(frac, q1.y, q0.z);
        const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
        const float b = fmaf(ocz, dz, fmaf(ocx, dx, ocy * dy));
        const float cc = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - q2.x;
        const float disc = fmaf(b, b, -cc);
        // sqrtf(disc) with the root taken of a positive value only (K7's
        // root_rn): +-0 stays, a negative or NaN disc gives NaN
        const bool pos = disc > 0.f;
        const float root = rtw_sweep::root_rn(pos ? disc : 1.f);
        const float nan = __int_as_float(0x7fc00000);
        const float sq = pos ? root : (disc == 0.f ? disc : nan);
        const float tn = -b - sq;
        const float tc = tn > 1e-3f ? tn : -b + sq;
        const float v = tc > 1e-3f ? tc : 3e37f;
        acc[r * kCols + c] = v;
        if (r == 0) next[c] = v;
      }
    }
  } else {  // kMinmask
    // warp w: column mc = w / 2, its rows h S / 2 .. (h + 1) S / 2 - 1
    // (h = w % 2), lane: rows h S / 2 + lane + 32 i; the accumulator
    // column-major here ((8, S): a warp's stores are consecutive words).
    // A thread's own = S / 64 elements: every one written to the
    // accumulator each step, read back from copies in its registers (past
    // kRegOwn from shared memory). A column's minimum: a warp's by
    // shuffles, then the two warps' through shared memory and a named
    // barrier of those 64 threads.
    const int mc = w >> 1, h = w & 1;
    float* col = acc + mc * S + h * (S / 2) + lane;   // element i: col[32 i]
    float* part = sm + L.wmin;   // (2 parities, 8 columns, 2 halves)
    const int own = S / 64;
    __syncthreads();   // the accumulator's 1s, written above
    // the steps with kOwn register copies: own itself (a compile-time
    // count, no test an element), or kRegOwn and the rest in shared memory
    auto steps = [&](auto count) {
      constexpr int kOwn = decltype(count)::value;
      float v[kOwn];
#pragma unroll
      for (int i = 0; i < kOwn; ++i) v[i] = 1.f;
      for (int step = 0; step < n; ++step) {
        float m = v[0];
#pragma unroll
        for (int i = 1; i < kOwn; ++i) m = fminf(m, v[i]);
        if constexpr (kOwn == kRegOwn) {
          for (int i = kOwn; i < own; ++i) m = fminf(m, col[32 * i]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
        }
        float* pp = part + ((step & 1) * kCols + mc) * 2;
        if (lane == 0) pp[h] = m;
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + mc) : "memory");
        const float col_min = fminf(m, pp[h ^ 1]);
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          v[i] = v[i] + (v[i] == col_min ? 1.f : 0.f);
          col[32 * i] = v[i];
        }
        if constexpr (kOwn == kRegOwn) {
          for (int i = kOwn; i < own; ++i) {
            const float e = col[32 * i];
            col[32 * i] = e + (e == col_min ? 1.f : 0.f);
          }
        }
      }
    };
    with_count<1>(own, steps);
  }

  __syncthreads();
  if (t < 8 * kCols) {
    out[(size_t)g * T + blockIdx.x * kCols + c] =
        acc[kBody == kMinmask ? c * S + g : g * kCols + c];
  }
}

template <int kBody, int kUnit>
cudaError_t launch(const void* tab, float* out, int S, int T, int n,
                   cudaStream_t stream) {
  auto kern = microbench_kernel<kBody, kUnit>;
  const size_t smem = sizeof(float) * Smem(kBody, kUnit, S).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return e;
    }
  }
  kern<<<T / kCols, kThreads, smem, stream>>>(tab, out, S, T, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K9 on `stream`: body 0 lane16, 1 sub16, 2 extract, 3 elemq,
// 4 minmask; unit 0 FP32, 1 TF32, 2 BF16 (lane16 / sub16: FP32 or TF32;
// extract: any; elemq / minmask: FP32). tab: mx (S, 16), mxt (16, S),
// at (24, S) (bfloat16 for BF16), sph (S, 128) or, for minmask, unused;
// out (8, T) float32; n steps. S % 64 == 0, T % 8 == 0; a block's shared
// memory (Smem) bounds S, past it the launch is refused. Returns
// cudaGetLastError() after the launch (0 on success).
int rtw_microbench_launch(int body, int unit, const void* tab, float* out,
                          int S, int T, int n, void* stream) {
  if (S < 64 || S % 64 || T < kCols || T % kCols || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body * 3 + unit) {
    case kLane16 * 3 + kFp32:
      return (int)launch<kLane16, kFp32>(tab, out, S, T, n, st);
    case kLane16 * 3 + kTf32:
      return (int)launch<kLane16, kTf32>(tab, out, S, T, n, st);
    case kSub16 * 3 + kFp32:
      return (int)launch<kSub16, kFp32>(tab, out, S, T, n, st);
    case kSub16 * 3 + kTf32:
      return (int)launch<kSub16, kTf32>(tab, out, S, T, n, st);
    case kExtract * 3 + kFp32:
      return (int)launch<kExtract, kFp32>(tab, out, S, T, n, st);
    case kExtract * 3 + kTf32:
      return (int)launch<kExtract, kTf32>(tab, out, S, T, n, st);
    case kExtract * 3 + kBf16:
      return (int)launch<kExtract, kBf16>(tab, out, S, T, n, st);
    case kElemq * 3 + kFp32:
      return (int)launch<kElemq, kFp32>(tab, out, S, T, n, st);
    case kMinmask * 3 + kFp32:
      return (int)launch<kMinmask, kFp32>(tab, out, S, T, n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

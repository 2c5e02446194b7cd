// Closest sphere hit of a wavefront of rays (ROADMAP kernel K7).
//
// Replaces raytracingweekend_tpu/ops/pallas_intersect.py::hit_spheres_pallas
// (its body `_kernel`): for each ray, the smallest t over every sphere slot
// of the near-root-else-far-root rule of sphere.h:46-81, with moving centres
// lerped at the ray's time, and the first slot with that t. Plain version
// beside it: raytracingweekend_tpu_torch/ops/intersect.py::
// hit_spheres_reference.
//
// Inputs: rays o, d (n, 3) and time (n,) float32 where they lie (element
// strides given); the slots as ops/intersect.py::sphere_layout stages them
// from the (S, 12) table, in one of four forms <kAxes, kUniform>, 4-byte
// words from the base:
//   a float4 (cx, cy, cz, r^2) a slot, r^2 = -inf on an inactive slot;
//   y only (kAxisY, one shutter window): then a float dcy a slot;
//   all axes (kAxesAll): then a float4 (dcx, dcy, dcz, t0) a slot (t0 only
//   without one shutter window, else 0) and, without one, a float 1/dt.
// The static form serves a static table; a moving one takes a moving form
// even where its active slots move along no axis (ops/megakernel.py's
// sweep_axes rule).
// Outputs: best_t (BIG = 3e37 on a miss) and best_i int64 (0 on a miss:
// the caller tests best_t < BIG).
//
// Rounding: built with -fmad=false and without --use_fast_math; the FMAs
// are the ones XLA's CPU backend contracts in the JAX kernel (the first
// product of each sum, and b*b in b*b - a*cc), written out as fmaf, and
// the plain version writes the same; sqrtf and the division are IEEE. The
// staged forms give the JAX kernel's bits:
// - an inactive slot's r^2 = -inf makes cc +inf (or NaN) and disc -inf
//   (or NaN): a miss, as the active flag made it;
// - the hit test `disc > 0 && tf > t_min` is the JAX kernel's `disc > 0 &&
//   t > t_min` with t = tn > t_min ? tn : tf: inv_a > 0 and rounding is
//   monotone, so tf >= tn, and a NaN fails both;
// - the root is taken of disc where disc > 0 and of 1 elsewhere (unused
//   there), correctly rounded (sweep.cuh root_rn): the IEEE sqrtf branches
//   to a slow path for zero, negative and subnormal inputs, and
//   fmaxf(disc, 0) fed it 0 on every missing pair;
// - one shutter window: every active slot holds the same (t0, 1/dt) bits,
//   so frac = (time - t0) * (1/dt), once a ray, has the bits the JAX
//   kernel computes a slot; in the y-only form the static axes skip their
//   motion FMA (fmaf(frac, 0, c) is c up to the sign of a zero centre,
//   which changes no t, for a finite frac; a non-finite frac makes cy
//   non-finite on every slot, a miss there as in the JAX kernel).
//
// What bounds it: FP32 issue. A (ray, slot) pair is 22 flops (26-30 with
// motion) of scalar work, and the rays and results are 36 bytes a ray, so
// memory is negligible. The first version ran 69.4 / 76 SASS a pair
// (static / moving) at ~0.5 of the card's issue rate: three 16-byte shared
// loads and the active flag a slot, the per-slot motion fraction, the IEEE
// root's slow path on every miss. This design: the slots staged in shared
// memory as the 16-byte quad plus only the motion lanes of the table's
// form (one shared load a slot serves kRays rays, register-blocked a
// thread), the fraction once a ray under one window, the root without its
// slow path's range check, a two-compare hit test. A table that fits one
// chunk (kChunk slots) is staged once; a longer one streams through two
// chunk buffers by cp.async, the next chunk's copy in flight while the
// current one is swept.
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using rtw_sweep::kAxesAll;
using rtw_sweep::kAxesStatic;
using rtw_sweep::kAxisY;
using rtw_sweep::slot_words;

constexpr int kThreads = 128;
constexpr int kRays = 4;   // rays a thread
constexpr int kChunk = 1024;   // slots a staged chunk when streaming
constexpr float kBig = 3.0e37f;

// The rays where they lie: element strides of o and d (row, column) and of
// time.
struct Rays {
  const float* o;
  const float* d;
  const float* time;
  long long so0, so1, sd0, sd1, st;
};

template <int kAxes, bool kUniform>
struct Form {
  static constexpr int kWords = slot_words(kAxes, kUniform);
  static constexpr int kMotion =
      kAxes == kAxisY ? 1 : (kAxes == kAxesAll ? 4 : 0);
  static constexpr bool kShutter = kAxes == kAxesAll && !kUniform;
};

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int cnt) {
  // dst and src 16-byte aligned; cnt floats, 16 bytes a copy, then the
  // tail 4 bytes a copy
  const int n16 = cnt >> 2;
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + 4 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + 4 * i));
  }
  for (int i = 4 * n16 + threadIdx.x; i < cnt; i += kThreads) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src + i));
  }
}

// Stage slots [base, base + m) of the S staged slots into the chunk buffer
// `buf` of capacity C (a multiple of 4): quads at word 0, motion lanes at
// 4 C, 1/dt at 8 C; one commit group.
template <int kAxes, bool kUniform>
__device__ __forceinline__ void stage_chunk(float* buf, int C,
                                            const float* staged, int S,
                                            int base, int m) {
  using F = Form<kAxes, kUniform>;
  copy_async(buf, staged + 4 * base, 4 * m);
  if (F::kMotion) {
    copy_async(buf + 4 * C, staged + 4 * S + F::kMotion * base,
               F::kMotion * m);
  }
  if (F::kShutter) copy_async(buf + 8 * C, staged + 8 * S + base, m);
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int kAxes, bool kUniform>
__global__ void __launch_bounds__(kThreads)
hit_spheres_kernel(Rays rays, const float* __restrict__ staged, int n, int S,
                   int C, float t_min, float t0u, float idtu,
                   float* __restrict__ best_t_out,
                   long long* __restrict__ best_i_out) {
  using F = Form<kAxes, kUniform>;
  extern __shared__ __align__(16) float sm[];
  const int nch = (S + C - 1) / C;
  // the first chunk's copy overlaps the rays' loads
  stage_chunk<kAxes, kUniform>(sm, C, staged, S, 0, min(C, S));

  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float a[kRays], inv_a[kRays], fr[kRays], best[kRays];
  int bi[kRays];
  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const long long lane = first + j * kThreads;
    ox[j] = oy[j] = oz[j] = dy[j] = dz[j] = 0.f;
    dx[j] = 1.f;
    float tm = 0.f;
    if (lane < n) {
      const float* o = rays.o + lane * rays.so0;
      const float* d = rays.d + lane * rays.sd0;
      ox[j] = o[0];
      oy[j] = o[rays.so1];
      oz[j] = o[2 * rays.so1];
      dx[j] = d[0];
      dy[j] = d[rays.sd1];
      dz[j] = d[2 * rays.sd1];
      tm = rays.time[lane * rays.st];
    }
    a[j] = fmaf(dz[j], dz[j], fmaf(dx[j], dx[j], dy[j] * dy[j]));
    inv_a[j] = 1.0f / a[j];
    // per-slot shutters keep the ray's time; one window its fraction
    fr[j] = F::kShutter ? tm : (tm - t0u) * idtu;
    best[j] = kBig;
    bi[j] = 0;
  }

  for (int c = 0; c < nch; ++c) {
    const int base = c * C;
    const int m = min(C, S - base);
    if (c + 1 < nch) {
      stage_chunk<kAxes, kUniform>(sm + ((c + 1) & 1) * F::kWords * C, C,
                                   staged, S, base + C,
                                   min(C, S - base - C));
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncthreads();
    const float* buf = sm + (c & 1) * F::kWords * C;
    const float4* quad = reinterpret_cast<const float4*>(buf);
    const float* dcy = buf + 4 * C;
    const float4* motion = reinterpret_cast<const float4*>(buf + 4 * C);
    const float* idt = buf + 8 * C;
#pragma unroll 2
    for (int k = 0; k < m; ++k) {
      const float4 q = quad[k];
      float my = 0.f, sid = 0.f;
      float4 mv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kAxes == kAxisY) my = dcy[k];
      if (kAxes == kAxesAll) mv = motion[k];
      if (F::kShutter) sid = idt[k];
      const int idx = base + k;
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float cx = q.x, cy = q.y, cz = q.z;
        if (kAxes == kAxisY) cy = fmaf(fr[j], my, cy);
        if (kAxes == kAxesAll) {
          const float f = F::kShutter ? (fr[j] - mv.w) * sid : fr[j];
          cx = fmaf(f, mv.x, cx);
          cy = fmaf(f, mv.y, cy);
          cz = fmaf(f, mv.z, cz);
        }
        const float ocx = ox[j] - cx;
        const float ocy = oy[j] - cy;
        const float ocz = oz[j] - cz;
        const float b = fmaf(ocz, dz[j], fmaf(ocx, dx[j], ocy * dy[j]));
        const float cc = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - q.w;
        const float disc = fmaf(b, b, -(a[j] * cc));
        const bool pos = disc > 0.f;
        const float sq = rtw_sweep::root_rn(pos ? disc : 1.f);
        const float tn = (-b - sq) * inv_a[j];
        const float tf = (-b + sq) * inv_a[j];
        const float t = tn > t_min ? tn : tf;
        // strict: the first slot with the smallest t wins
        const bool win = pos & (tf > t_min) & (t < best[j]);
        best[j] = win ? t : best[j];
        bi[j] = win ? idx : bi[j];
      }
    }
    __syncthreads();   // the buffer is restaged two chunks on
  }

#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int lane = first + j * kThreads;
    if (lane < n) {
      best_t_out[lane] = best[j];
      best_i_out[lane] = bi[j];
    }
  }
}

template <int kAxes, bool kUniform>
cudaError_t launch(const Rays& rays, const float* staged, int n, int S,
                   float t_min, float t0, float idt, float* best_t,
                   long long* best_i, cudaStream_t stream) {
  using F = Form<kAxes, kUniform>;
  auto kern = hit_spheres_kernel<kAxes, kUniform>;
  const int C = S <= kChunk ? (S + 3) / 4 * 4 : kChunk;
  const size_t smem =
      sizeof(float) * F::kWords * C * (S > kChunk ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return e;
    }
  }
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  kern<<<blocks, kThreads, smem, stream>>>(rays, staged, n, S, C, t_min, t0,
                                           idt, best_t, best_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K7 on `stream`: rays o, d (n, 3) and time (n,) float32 with their
// element strides; `staged` the S slots of form (axes, uniform) laid out
// as ops/intersect.py::sphere_layout stages them ((0, 1) static, (2, 1) y
// only, (7, 1) all axes under one window (t0, idt), (7, 0) per-slot
// shutters). Outputs best_t (n,) float32 and best_i (n,) int64.
// Returns cudaGetLastError() after the launch (0 on success).
int rtw_hit_spheres_launch(const float* o, long long so0, long long so1,
                           const float* d, long long sd0, long long sd1,
                           const float* time, long long st,
                           const float* staged, int axes, int uniform,
                           float t0, float idt, float* best_t,
                           long long* best_i, int n, int s, float t_min,
                           void* stream) {
  if (n <= 0 || s <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const Rays rays{o, d, time, so0, so1, sd0, sd1, st};
  if (axes == kAxesStatic && uniform) {
    return (int)launch<kAxesStatic, true>(rays, staged, n, s, t_min, t0, idt,
                                          best_t, best_i, stm);
  }
  if (axes == kAxisY && uniform) {
    return (int)launch<kAxisY, true>(rays, staged, n, s, t_min, t0, idt,
                                     best_t, best_i, stm);
  }
  if (axes == kAxesAll) {
    return uniform ? (int)launch<kAxesAll, true>(rays, staged, n, s, t_min,
                                                 t0, idt, best_t, best_i,
                                                 stm)
                   : (int)launch<kAxesAll, false>(rays, staged, n, s, t_min,
                                                  t0, idt, best_t, best_i,
                                                  stm);
  }
  return (int)cudaErrorInvalidValue;
}

// K7's staging constants, for the host's checks: out[0] = rays a thread,
// out[1] = threads a block, out[2] = slots a streamed chunk.
void rtw_k7_consts(int* out) {
  out[0] = kRays;
  out[1] = kThreads;
  out[2] = kChunk;
}

}  // extern "C"

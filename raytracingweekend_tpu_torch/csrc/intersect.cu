// Closest sphere hit of a wavefront of rays (ROADMAP kernel K7).
//
// Replaces raytracingweekend_tpu/ops/pallas_intersect.py::hit_spheres_pallas
// (its body `_kernel`): for each ray, the smallest t over every sphere slot
// of the near-root-else-far-root rule of sphere.h:46-81, with moving centres
// lerped at the ray's time, and the first slot with that t. Plain version
// beside it: raytracingweekend_tpu_torch/ops/intersect.py::
// hit_spheres_reference.
//
// Inputs: rays as float32 SoA rows (ox, oy, oz, dx, dy, dz, time) of N
// lanes; the sphere table as three float4 per slot,
//   q0 = (cx, cy, cz, r^2), q1 = (dcx, dcy, dcz, t0), q2 = (1/dt, active, 0, 0)
// (a negative radius enters as r^2; 1/dt is 0 where time1 == time0).
// Outputs: best_t (BIG = 3e37 on a miss) and best_i (0 on a miss: the
// caller tests best_t < BIG).
//
// One thread per ray, blocks of 256. The table is streamed through shared
// memory in chunks of kChunk slots, so any S works (random_balls_huge's
// 14592 slots take 700 KB, more than a block's 227 KB). A thread keeps a
// running (best_t, best_i) and replaces it only on a strictly smaller t,
// visiting slots in order, so the first slot with the smallest t wins, as
// jnp.argmin picks it.
//
// Rounding: built with -fmad=false and without --use_fast_math; the FMAs
// are the ones XLA's CPU backend contracts in the JAX kernel (the first
// product of each sum, and b*b in b*b - a*cc), written out as fmaf, and
// the plain version writes the same; sqrtf and the division are IEEE.
//
// What bounds it: FP32 issue. A (ray, slot) pair costs 22 flops (30 with
// motion) of dependent scalar work and ~40 instructions; the rays and the
// result are 36 bytes a ray, so memory is negligible. The table is read
// from shared memory as a broadcast (every thread of a warp reads the same
// slot).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;       // slots per shared-memory chunk (12 KB)
constexpr float kBig = 3.0e37f;

template <bool kMoving>
__global__ void __launch_bounds__(kThreads)
hit_spheres_kernel(const float* __restrict__ rays,
                   const float4* __restrict__ table, int n, int s,
                   float t_min, float* __restrict__ best_t_out,
                   int* __restrict__ best_i_out) {
  __shared__ float4 tile[kChunk * 3];
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lane < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 0.f, dz = 0.f;
  float time = 0.f;
  if (live) {
    ox = rays[lane];
    oy = rays[n + lane];
    oz = rays[2 * n + lane];
    dx = rays[3 * n + lane];
    dy = rays[4 * n + lane];
    dz = rays[5 * n + lane];
    time = rays[6 * n + lane];
  }
  const float a = fmaf(dz, dz, fmaf(dx, dx, dy * dy));
  const float inv_a = 1.0f / a;
  float best_t = kBig;
  int best_i = 0;
  for (int base = 0; base < s; base += kChunk) {
    const int m = min(kChunk, s - base);
    __syncthreads();
    for (int j = threadIdx.x; j < 3 * m; j += kThreads) {
      tile[j] = table[3 * base + j];
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float4 q0 = tile[3 * k];
      const float4 q2 = tile[3 * k + 2];
      float cx = q0.x, cy = q0.y, cz = q0.z;
      if (kMoving) {
        const float4 q1 = tile[3 * k + 1];
        const float frac = (time - q1.w) * q2.x;
        cx = fmaf(frac, q1.x, cx);
        cy = fmaf(frac, q1.y, cy);
        cz = fmaf(frac, q1.z, cz);
      }
      const float ocx = ox - cx;
      const float ocy = oy - cy;
      const float ocz = oz - cz;
      const float b = fmaf(ocz, dz, fmaf(ocx, dx, ocy * dy));
      const float cc = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - q0.w;
      const float disc = fmaf(b, b, -(a * cc));
      const float sq = sqrtf(fmaxf(disc, 0.f));
      const float tn = (-b - sq) * inv_a;
      const float tf = (-b + sq) * inv_a;
      const float t = tn > t_min ? tn : tf;
      if (disc > 0.f && t > t_min && q2.y > 0.f && t < best_t) {
        best_t = t;
        best_i = base + k;
      }
    }
  }
  if (live) {
    best_t_out[lane] = best_t;
    best_i_out[lane] = best_i;
  }
}

}  // namespace

extern "C" {

// Launch K7 on `stream`: rays (7, n) float32 SoA, table (s, 12) float32,
// outputs best_t (n,) float32 and best_i (n,) int32. Returns
// cudaGetLastError() after the launch (0 on success).
int rtw_hit_spheres_launch(const float* rays, const float* table,
                           float* best_t, int* best_i, int n, int s,
                           int moving, float t_min, void* stream) {
  if (n <= 0 || s <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  const float4* tab = reinterpret_cast<const float4*>(table);
  if (moving) {
    hit_spheres_kernel<true><<<blocks, kThreads, 0, st>>>(
        rays, tab, n, s, t_min, best_t, best_i);
  } else {
    hit_spheres_kernel<false><<<blocks, kThreads, 0, st>>>(
        rays, tab, n, s, t_min, best_t, best_i);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

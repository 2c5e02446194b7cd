// Sweep twin: the book-1 dense sweep alone (ROADMAP kernel K8).
//
// Replaces tools/sweep_twin.py::make_fn.kern (its pallas_call at :164), a
// ceiling instrument for the book-1 megakernel: the same sphere table, the
// same moving-centre quadratic and the same serial bounce dependency, but
// no shading, RNG, regeneration or state rows. Here it bounds the port's
// K1 (csrc/megakernel.cu::mega_kernel), so it stages the (9, S) SoA of the
// port's book-1 plan as K1 does and sweeps it with the slot loop of K1's
// book-1 instantiation (sweep.cuh, shared: centres moving along y only,
// one shutter window), and "K1 - twin" is what shading, RNG and tile tails
// really cost on the card. The table's x and z motion lanes must be zero,
// as the book-1 plan's are (tools/sweep_twin.py::book1_inputs checks).
// Plain version beside it: raytracingweekend_tpu_torch/tools/sweep_twin.py::
// sweep_twin_reference.
//
// One block per grid step, T <= kDenseMaxT lanes a block (K1's launch
// bounds: ptxas then gives `quad` 32 registers, eight 256-lane blocks an
// SM, 7% faster than the 40 of a 768 bound), one thread a lane. The
// TPU runs its G grid steps one after another; here the G blocks run at
// once, and every block computes the same rays (the tool's rays depend
// only on the lane, :80-92). Per iteration a lane sweeps every slot of the
// shared-memory table with a running best and the strict `<` (the first
// slot with the smallest t wins: the TPU's 128-slot block min and merge
// give the same minimum), then derives its next ray from the sweep's t
// (the tool's coupling stand-in). The loop runs while it < K and any lane
// of the block hit (`__syncthreads_or`: the tool's cross-lane any() and
// scalar branch, kept data-dependent). Row 1 of `out` counts iterations.
//
// `ext` adds the winner's attributes: after each sweep a hitting lane reads
// its winner slot's 24 rows of `attr` (24, S) through the read-only path,
// as K1's shading does, and keeps them; a missing lane keeps its last ones.
// The TPU kernel extracts them with a one-hot MXU dot that SUMS the
// columns of slots tied at a block's minimum; this kernel takes the first
// tied slot (the port leaves one-hot lookups out). The (G, 24, T) rows are
// written at the end, so nvcc cannot drop the loads.
//
// Rounding: built with -fmad=false; the FMAs are written out where XLA's
// CPU backend contracts the tool's expressions (the first product of each
// sum), the sweep's are K1's, and the root is K1's disc * rsqrtf(disc)
// (NaN on a miss, and NaN is a miss). The plain version writes the same.
//
// What bounds it: FP32 issue, as K1. The loop spends 22 FP32 operations a
// slot (the y motion FMA, then the quadratic and its root, 20;
// tools/sweep_twin.py::bound_ms counts from the plan); the staged slots
// sit in shared memory, 20 bytes a slot read as two broadcasts (a 16-byte
// quad and dcy); the launch moves ~36 S bytes in and 8 (or 104 with ext)
// bytes a lane out.
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace rtw_sweep;  // kBig, the slot layout and loop
constexpr float kTmin = 0.001f;
constexpr int kAttrRows = 24;

struct Ray {
  float ox, oy, oz, dx, dy, dz, time;
};

// The slot loop's instantiation: K1's for the book-1 plan
constexpr int kTwinAxes = kAxisY;

template <bool kExt>
__global__ void __launch_bounds__(kDenseMaxT)
    sweep_twin_kernel(const float* __restrict__ soa,
                                  const float* __restrict__ attr,
                                  float* __restrict__ out,
                                  float* __restrict__ attrs_out, int S,
                                  int K, float ut_t0, float ut_idt,
                                  float inv_T) {
  extern __shared__ float sm[];  // staged slots (sweep.cuh)
  stage_slots<kTwinAxes, true>(sm, soa, S);
  __syncthreads();

  const int T = blockDim.x;
  const float lane = (float)threadIdx.x;
  // the tool's book-1-like camera (:80-92): origin cluster, fanned
  // directions below the horizon (not unit length: |d|^2 ~ 0.7)
  const float inv = rsqrtf(fmaf((lane * 1e-4f) * lane, 1e-4f, 3.0f));
  Ray ray = {fmaf(lane, 1e-4f, 13.0f), fmaf(lane, 3e-5f, 2.0f),
             fmaf(lane, -2e-5f, 3.0f), -inv,
             -inv * fmaf(lane, 1e-5f, 0.3f), -inv, lane * inv_T};
  float iters = 0.f;
  float af[kAttrRows];
#pragma unroll
  for (int r = 0; r < kAttrRows; ++r) af[r] = 0.f;

  for (int it = 0; it < K; ++it) {
    // ---- K1's slot loop (sweep.cuh, as megakernel.cu `sweep<kAxisY, true>`)
    float best;
    const int bidx = sweep_slots<kTwinAxes, true>(
        sm, S, ray, (ray.time - ut_t0) * ut_idt, kTmin, best);
    if (kExt && best < kBig) {
#pragma unroll
      for (int r = 0; r < kAttrRows; ++r) {
        af[r] = __ldg(attr + (size_t)r * S + bidx);
      }
    }
    // ---- the tool's coupling stand-in: next rays from this sweep ----
    const float tcl = fminf(best, 100.0f);
    ray.ox = fmaf(ray.ox, 0.999f, 0.001f * tcl);
    ray.oy = fmaf(ray.oy, 0.999f, 0.0003f * tcl);
    ray.oz = fmaf(ray.oz, 0.999f, -(0.0002f * tcl));
    ray.dx = fmaf(ray.dx, 0.9999f, 1e-5f * tcl);
    ray.dy = fmaf(ray.dy, 0.9999f, -(1e-5f * tcl));
    ray.time = fminf(ray.time + 1e-4f, 1.0f);
    iters += 1.f;
    if (!__syncthreads_or(best < kBig)) break;
  }

  float* o = out + (size_t)blockIdx.x * 2 * T + threadIdx.x;
  o[0] = ray.ox;
  o[T] = iters;
  if (kExt) {
    float* a = attrs_out + (size_t)blockIdx.x * kAttrRows * T + threadIdx.x;
#pragma unroll
    for (int r = 0; r < kAttrRows; ++r) a[(size_t)r * T] = af[r];
  }
}

template <class Kernel>
cudaError_t launch(Kernel kern, int G, int T, size_t smem,
                   cudaStream_t stream, const float* soa, const float* attr,
                   float* out, float* attrs_out, int S, int K, float ut_t0,
                   float ut_idt, float inv_T) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return e;
    }
  }
  kern<<<G, T, smem, stream>>>(soa, attr, out, attrs_out, S, K, ut_t0,
                               ut_idt, inv_T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K8 on `stream`: soa (9, S) float32, attr (24, S) float32, out
// (G, 2, T) float32 (ox, iterations), attrs_out (G, 24, T) float32 when
// ext != 0 (else unused). G blocks of T lanes, at most K iterations.
// Returns cudaGetLastError() after the launch (0 on success): a launch the
// device refuses (T > kDenseMaxT, or the staged table past a block's
// shared memory)
// returns its error. The table's x and z motion lanes must be zero (the
// slot loop lerps y only).
int rtw_sweep_twin_launch(const float* soa, const float* attr, float* out,
                          float* attrs_out, int S, int T, int G, int K,
                          int ext, float ut_t0, float ut_idt, float inv_T,
                          void* stream) {
  if (S <= 0 || T <= 0 || G <= 0 || K < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * slot_words(kTwinAxes, true) * (size_t)S;
  if (ext) {
    return (int)launch(sweep_twin_kernel<true>, G, T, smem, st, soa, attr,
                       out, attrs_out, S, K, ut_t0, ut_idt, inv_T);
  }
  return (int)launch(sweep_twin_kernel<false>, G, T, smem, st, soa, attr,
                     out, attrs_out, S, K, ut_t0, ut_idt, inv_T);
}

}  // extern "C"

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
//   sub16    the same product with the matrix stored (16, S), loaded
//            column-major
//   extract  acc = acc * 0.5 + pad(at (24, S) @ (acc == 0)), rows past 24
//            padded with zeros
//   elemq    the moving-sphere quadratic of the table's row s against a
//            ray made from acc[0] (sqrtf, near-else-far root, 3e37 miss)
//   minmask  acc = acc + (acc == column min)
// Units: the TPU's "f32 default" (one reduced-precision MXU pass) runs on
// the TF32 tensor cores (wmma m16n16k8; inputs rounded by
// __float_to_tf32, round to nearest, ties away from zero); "f32 HIGHEST"
// runs on the FP32 pipes with every multiply-add an fmaf (built with
// -fmad=false); "bf16" on the BF16 tensor cores (wmma m16n16k16) with
// float32 accumulation.
//
// Every body is independent per column of the accumulator: a step reads
// only its own column. So a block owns kCols = 16 columns and keeps their
// S rows in shared memory through all N steps (the whole accumulator, 4 MiB
// at S = 512 and T = 2048, fits no block), with the body's table staged
// beside it; T / 16 blocks of 256 threads. Each step writes the whole
// accumulator back, as the tool's acc[...] = f(...) does, so rows that
// only later steps would read stay live.
//
// What bounds it: nothing leaves the chip between steps, so operations:
// 2 S 16 T flops a lane16 / sub16 step, 2 24 S T an extract step (on the
// tensor cores in TF32 / BF16, else the FP32 pipes), ~28 S T an elemq step
// and 3 S T a minmask step on the FP32 pipes. At the tool's S = 512,
// T = 2048 a step is microseconds of work spread over 128 blocks, one a
// SM: this first version is simple and latency-bound (the FP32 extract is
// two serial 512-term chains a thread), not tuned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kCols = 16;      // accumulator columns a block owns
constexpr int kThreads = 256;  // 8 warps; thread t: column t % 16, rows
                               // t / 16 + 16 i
constexpr int kWarps = kThreads / 32;
constexpr int kAttr = 24;      // extract's matrix rows (padded to 32)
constexpr int kAttrPad = 32;
constexpr int kSphLanes = 9;   // elemq reads the table's lanes 0..8
constexpr int kSphStride = 128;

enum Body { kLane16 = 0, kSub16 = 1, kExtract = 2, kElemq = 3, kMinmask = 4 };
enum Unit { kFp32 = 0, kTf32 = 1, kBf16 = 2 };

template <int kUnit>
struct Elem {
  using type = float;
};
template <>
struct Elem<kBf16> {
  using type = __nv_bfloat16;
};

template <int kUnit>
__device__ __forceinline__ typename Elem<kUnit>::type to_unit(float x) {
  if constexpr (kUnit == kTf32) {
    return wmma::__float_to_tf32(x);
  } else if constexpr (kUnit == kBf16) {
    return __float2bfloat16(x);
  } else {
    return x;
  }
}

// Shared memory of one block, in bytes, laid out as the kernel reads it:
// the accumulator (S, 16) float32, then the body's tables. Every region
// starts on a 32-byte boundary for wmma (S % 64 == 0).
__host__ __device__ inline size_t smem_bytes(int body, int unit, int S) {
  const size_t acc = sizeof(float) * S * kCols;
  switch (body) {
    case kLane16:
    case kSub16:
      return acc + sizeof(float) * (S * kCols + kCols * kCols);
    case kExtract: {
      const size_t e = unit == kBf16 ? 2 : 4;
      size_t b = acc + e * kAttrPad * S + sizeof(float) * kAttrPad * kCols;
      if (unit != kFp32) {
        b += e * S * kCols + sizeof(float) * kWarps * 16 * kCols;
      }
      return b;
    }
    case kElemq:
      return acc + sizeof(float) * (kSphLanes * S + kCols);
    default:
      return acc + sizeof(float) * (kThreads + kCols);
  }
}

template <int kBody, int kUnit>
__global__ void __launch_bounds__(kThreads)
microbench_kernel(const void* __restrict__ tab, float* __restrict__ out,
                  int S, int T, int n) {
  using E = typename Elem<kUnit>::type;
  extern __shared__ __align__(32) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* rest = smem + sizeof(float) * S * kCols;
  const int t = threadIdx.x;
  const int c = t & (kCols - 1);
  const int g = t >> 4;
  const int w = t >> 5;

  for (int i = t; i < S * kCols; i += kThreads) {
    acc[i] = kBody == kMinmask ? 1.f : 0.f;
  }

  if constexpr (kBody == kLane16 || kBody == kSub16) {
    float* mat = reinterpret_cast<float*>(rest);  // (S,16) or (16,S)
    float* rhs = mat + S * kCols;                 // (16, 16)
    const float* src = static_cast<const float*>(tab);
    for (int i = t; i < S * kCols; i += kThreads) {
      mat[i] = to_unit<kUnit>(__ldg(src + i));
    }
    for (int step = 0; step < n; ++step) {
      __syncthreads();
      rhs[t] = to_unit<kUnit>(fmaf(acc[t], 1e-30f, 1.0f));  // rows 0..15
      __syncthreads();
      if constexpr (kUnit == kFp32) {
        for (int s = g; s < S; s += 16) {
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const float m =
                kBody == kLane16 ? mat[s * 16 + k] : mat[k * S + s];
            sum = fmaf(m, rhs[k * kCols + c], sum);
          }
          acc[s * kCols + c] = sum;
        }
      } else {
        using Layout = typename std::conditional<kBody == kLane16,
                                                 wmma::row_major,
                                                 wmma::col_major>::type;
        wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                       Layout> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                       wmma::row_major> fb;
        wmma::fragment<wmma::accumulator, 16, 16, 8, float> fc;
        for (int mt = w; mt < S / 16; mt += kWarps) {
          wmma::fill_fragment(fc, 0.f);
#pragma unroll
          for (int k0 = 0; k0 < 16; k0 += 8) {
            if constexpr (kBody == kLane16) {
              wmma::load_matrix_sync(fa, mat + mt * 16 * 16 + k0, 16);
            } else {
              wmma::load_matrix_sync(fa, mat + k0 * S + mt * 16, S);
            }
            wmma::load_matrix_sync(fb, rhs + k0 * kCols, kCols);
            wmma::mma_sync(fc, fa, fb, fc);
          }
          wmma::store_matrix_sync(acc + mt * 16 * kCols, fc, kCols,
                                  wmma::mem_row_major);
        }
      }
    }
  } else if constexpr (kBody == kExtract) {
    E* at = reinterpret_cast<E*>(rest);                    // (32, S)
    float* rbuf = reinterpret_cast<float*>(at + kAttrPad * S);  // (32, 16)
    E* mbuf = reinterpret_cast<E*>(rbuf + kAttrPad * kCols);    // (S, 16)
    float* part = reinterpret_cast<float*>(mbuf + S * kCols);  // (8,16,16)
    const E* src = static_cast<const E*>(tab);
    for (int i = t; i < kAttrPad * S; i += kThreads) {
      if constexpr (kUnit == kBf16) {
        at[i] = i < kAttr * S ? src[i] : __float2bfloat16(0.f);
      } else {
        at[i] = to_unit<kUnit>(i < kAttr * S ? __ldg(src + i) : 0.f);
      }
    }
    for (int step = 0; step < n; ++step) {
      __syncthreads();
      if constexpr (kUnit == kFp32) {
        // r[i][c] = sum over s of at[i][s] (acc[s][c] == 0), in slot order
        for (int o = t; o < kAttr * kCols; o += kThreads) {
          const int i = o >> 4, cc = o & (kCols - 1);
          float sum = 0.f;
          for (int s = 0; s < S; ++s) {
            sum = fmaf(at[i * S + s], acc[s * kCols + cc] == 0.f ? 1.f : 0.f,
                       sum);
          }
          rbuf[o] = sum;
        }
      } else {
        for (int s = g; s < S; s += 16) {
          mbuf[s * kCols + c] =
              to_unit<kUnit>(acc[s * kCols + c] == 0.f ? 1.f : 0.f);
        }
        __syncthreads();
        // warp w: row tile w % 2 over the slot quarter w / 2
        constexpr int kK = kUnit == kBf16 ? 16 : 8;
        using P = typename std::conditional<kUnit == kBf16, __nv_bfloat16,
                                            wmma::precision::tf32>::type;
        wmma::fragment<wmma::matrix_a, 16, 16, kK, P, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, kK, P, wmma::row_major> fb;
        wmma::fragment<wmma::accumulator, 16, 16, kK, float> fc;
        const int mt = w & 1, q = S / 4, k_lo = (w >> 1) * q;
        wmma::fill_fragment(fc, 0.f);
        for (int k0 = k_lo; k0 < k_lo + q; k0 += kK) {
          wmma::load_matrix_sync(fa, at + mt * 16 * S + k0, S);
          wmma::load_matrix_sync(fb, mbuf + k0 * kCols, kCols);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(part + w * 16 * kCols, fc, kCols,
                                wmma::mem_row_major);
        __syncthreads();
        // the four quarters of each row tile, in slot order
        for (int o = t; o < kAttr * kCols; o += kThreads) {
          const int i = o >> 4, cc = o & (kCols - 1);
          const int e = (i & 15) * kCols + cc, m0 = i >> 4;
          rbuf[o] = ((part[m0 * 256 + e] + part[(m0 + 2) * 256 + e]) +
                     part[(m0 + 4) * 256 + e]) +
                    part[(m0 + 6) * 256 + e];
        }
      }
      __syncthreads();
      for (int s = g; s < S; s += 16) {
        const float v = acc[s * kCols + c];
        acc[s * kCols + c] =
            s < kAttr ? fmaf(v, 0.5f, rbuf[s * kCols + c]) : v * 0.5f;
      }
    }
  } else if constexpr (kBody == kElemq) {
    float* sph = reinterpret_cast<float*>(rest);  // (9, S) SoA
    float* a0 = sph + kSphLanes * S;              // acc[0] of the step
    const float* src = static_cast<const float*>(tab);
    for (int i = t; i < kSphLanes * S; i += kThreads) {
      const int k = i / S, s = i % S;
      sph[i] = __ldg(src + (size_t)s * kSphStride + k);
    }
    for (int step = 0; step < n; ++step) {
      __syncthreads();
      if (t < kCols) a0[t] = acc[t];
      __syncthreads();
      const float ox = fmaf(a0[c], 1e-30f, 1.0f);
      const float oy = ox, oz = ox;
      const float dx = ox * 0.5f;
      const float dy = dx, dz = dx;
      const float tmv = ox * 0.1f;
      for (int s = g; s < S; s += 16) {
        const float frac = (tmv - sph[6 * S + s]) * sph[7 * S + s];
        const float cx = fmaf(frac, sph[3 * S + s], sph[s]);
        const float cy = fmaf(frac, sph[4 * S + s], sph[S + s]);
        const float cz = fmaf(frac, sph[5 * S + s], sph[2 * S + s]);
        const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
        const float b = fmaf(ocz, dz, fmaf(ocx, dx, ocy * dy));
        const float cc =
            fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - sph[8 * S + s];
        const float disc = fmaf(b, b, -cc);
        const float sq = sqrtf(disc);
        const float tn = -b - sq;
        const float tc = tn > 1e-3f ? tn : -b + sq;
        acc[s * kCols + c] = tc > 1e-3f ? tc : 3e37f;
      }
    }
  } else {  // kMinmask
    float* part = reinterpret_cast<float*>(rest);  // (16, 16) partial mins
    for (int step = 0; step < n; ++step) {
      __syncthreads();
      float m = acc[g * kCols + c];
      for (int s = g + 16; s < S; s += 16) m = fminf(m, acc[s * kCols + c]);
      part[g * kCols + c] = m;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 16; ++k) m = fminf(m, part[k * kCols + c]);
      for (int s = g; s < S; s += 16) {
        const float v = acc[s * kCols + c];
        acc[s * kCols + c] = v + (v == m ? 1.f : 0.f);
      }
    }
  }

  __syncthreads();
  if (t < 8 * kCols) {
    out[(size_t)g * T + blockIdx.x * kCols + c] = acc[g * kCols + c];
  }
}

template <int kBody, int kUnit>
cudaError_t launch(const void* tab, float* out, int S, int T, int n,
                   cudaStream_t stream) {
  auto kern = microbench_kernel<kBody, kUnit>;
  const size_t smem = smem_bytes(kBody, kUnit, S);
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
// out (8, T) float32; n steps. S % 64 == 0, T % 16 == 0. Returns
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

// The Mosaic compiler-bug repros as kernels for Hopper (ROADMAP kernels
// K10-K14).
//
// Replaces the ten pallas_calls of tools/mosaic_repros/:
//   K10 repro_f32_iota.py: _kernel_f32_iota (:37), _kernel_int_iota_cast
//       (:41), pallas_call at :47
//   K11 repro_slice_broadcast_layout.py: _kernel_reg_slice (:41),
//       _kernel_ref_load (:48), pallas_call at :56
//   K12 repro_scalar_reduce.py: kernel (:28), pallas_call at :55
//   K13 repro_dynamic_cull.py: kern_a (:70), kern_b (:87), kern_c (:104),
//       kern_d (:138), pallas_calls at :75, :92, :120, :158
//   K14 repro_dot_k3_subslice.py: _kernel_subslice (:35), _kernel_dense
//       (:44), pallas_calls at :56, :64
// Plain versions beside them: raytracingweekend_tpu_torch/tools/
// mosaic_repros/<repro>.py::*_reference.
//
// Each repro keeps the TPU formulations apart, so each becomes its own
// kernel here, with the difference the repro is about written into it:
//   K10 the f32 iota adds 1.0f per row (no integer-to-float conversion);
//       the int iota converts the row index with __int2float_rn (I2F).
//   K11 the register slice loads a thread's lanes of the (1, T) row once,
//       into registers, and slices them per W-lane chunk; the ref load
//       re-reads the chunk's lanes inside each chunk. Both apply the lane
//       offset ch * W to the load and to the store alike.
//   K12 min and max of the block by warp shuffles, then shared memory, into
//       one __shared__ scalar pair (the SMEM scratch); every thread runs
//       the repro's while loop on the span read back from it. fminf /
//       fmaxf, not the unsigned-bits min of csrc/megakernel.cu, whose
//       order holds for non-negative floats only.
//   K13 the runtime scalars are read inside the kernel from a device int32
//       array (never launch arguments), as the repro's SMEM input; dynamic
//       slice starts are clamped into the table as lax.dynamic_slice
//       clamps them. C writes its id list to __shared__ memory (entries it
//       does not write are 0) and loops over min(max(n, 0), 8) of them,
//       each id read with a dynamic index. D compacts with one warp's
//       __ballot_sync and a __popc prefix, in ascending row order, the
//       rest filled with -1.
//   K14 (S, 3) x (3, T) at the TPU's default precision, which is the
//       H100's TF32 tensor cores (mma.sync m16n8k8, float32
//       accumulation), K padded from 3 to 8 with zeros, one warp a 16 x 16
//       tile of two n8 products. The sub-slice form reads lanes 0..2 of
//       the (S, 128) table with leading dimension 128; an 8-wide fragment
//       load straight from the table would pick up its lanes 3..7 (the TPU
//       bug's "neighbouring lanes"), so each lane loads only its k < 3
//       elements from global memory into its fragment registers and holds
//       zeros for the rest: no shared memory, no barrier.
//
// What bounds them: each moves at most 133 KB and does at most 2^18
// operations, nanoseconds of the card's memory and arithmetic rates; a
// launch costs microseconds, so every kernel here is launch-bound. They
// are checks of what the TPU's compiler refused or miscompiled, not hot
// paths: one block (K12, K13 C / D) or a few dozen. What a design can
// still cut is the launch's own cost: each entry takes one argument block
// (below), which the host packs in one call, and an empty kernel,
// launched the same way, measures the floor of a launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 8;  // K11's register slice holds T / W <= 8
constexpr int kIds = 8;        // K13 C's id list, the repro's SMEM (8,)

// ---- K10 ----------------------------------------------------------------

__global__ void repro_iota_f32_kernel(float* __restrict__ out, int rows,
                                      int T) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= T) return;
  float v = 0.f;
  for (int r = 0; r < rows; ++r) {
    out[(size_t)r * T + j] = v;
    v += 1.0f;
  }
}

__global__ void repro_iota_int_cast_kernel(float* __restrict__ out, int rows,
                                           int T) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * T) return;
  out[idx] = __int2float_rn(idx / T);
}

// ---- K11: block i writes out row i, thread j lanes j + ch W -------------

template <bool kRegSlice>
__global__ void repro_slice_kernel(const float* __restrict__ row,
                                   const float* __restrict__ col,
                                   float* __restrict__ out, int T, int W) {
  const int i = blockIdx.x, j = threadIdx.x, chunks = T / W;
  const float c = col[i];
  float* dst = out + (size_t)i * T;
  if constexpr (kRegSlice) {
    float r[kMaxChunks];
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch < chunks) r[ch] = row[ch * W + j];
    }
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch < chunks) dst[ch * W + j] = r[ch] * c;
    }
  } else {
    for (int ch = 0; ch < chunks; ++ch) {
      dst[ch * W + j] = row[ch * W + j] * c;
    }
  }
}

// ---- K12: one block over the n elements, rows 0..2 of width `cols` ------

__global__ void __launch_bounds__(kThreads)
repro_scalar_reduce_kernel(const float* __restrict__ x,
                           float* __restrict__ out, int n, int cols) {
  __shared__ float wmin[kThreads / 32], wmax[kThreads / 32];
  __shared__ float s_ref[4];  // the repro's SMEM scratch (4,)
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  float lo = x[t < n ? t : 0], hi = lo;
  for (int i = t + kThreads; i < n; i += kThreads) {
    lo = fminf(lo, x[i]);
    hi = fmaxf(hi, x[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    wmin[w] = lo;
    wmax[w] = hi;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 1; k < kThreads / 32; ++k) {
      lo = fminf(lo, wmin[k]);
      hi = fmaxf(hi, wmax[k]);
    }
    s_ref[0] = lo;
    s_ref[1] = hi;
  }
  __syncthreads();
  lo = s_ref[0];
  hi = s_ref[1];
  const float span = hi - lo;
  int trips = 0;
  while (__int2float_rn(trips) * 13.0f < span && trips < 100) ++trips;
  for (int i = t; i < 3 * cols; i += kThreads) {
    const int r = i / cols;
    out[i] = r == 0 ? lo : (r == 1 ? hi : __int2float_rn(trips));
  }
}

// ---- K13: the four dynamic-cull probes ----------------------------------

__device__ __forceinline__ int clamp_start(int start, int size, int extent) {
  return min(max(start, 0), extent - size);
}

// A: out (8, cols) = tab[8 k : 8 k + 8], k = s[0]
__global__ void repro_cull_a_kernel(const int* __restrict__ s,
                                    const float* __restrict__ tab,
                                    float* __restrict__ out, int rows,
                                    int cols) {
  const int r0 = clamp_start(s[0] * 8, 8, rows);
  for (int i = threadIdx.x; i < 8 * cols; i += blockDim.x) {
    out[i] = tab[(size_t)r0 * cols + i];
  }
}

// B: out (rows, 128) = att[:, 128 k : 128 k + 128], k = s[1]
__global__ void repro_cull_b_kernel(const int* __restrict__ s,
                                    const float* __restrict__ att,
                                    float* __restrict__ out, int rows,
                                    int cols) {
  const int c0 = clamp_start(s[1] * 128, 128, cols);
  for (int i = threadIdx.x; i < rows * 128; i += blockDim.x) {
    out[i] = att[(size_t)(i >> 7) * cols + c0 + (i & 127)];
  }
}

// C: ids (s0 - 2, s0, s1 + s2) to shared memory, then the sum of the n
// 8-row blocks they name, n = s[2], in id order
__global__ void repro_cull_c_kernel(const int* __restrict__ s,
                                    const float* __restrict__ tab,
                                    float* __restrict__ out, int rows,
                                    int cols) {
  __shared__ int ids[kIds];
  if (threadIdx.x < kIds) {
    const int k = threadIdx.x;
    ids[k] = k == 0 ? s[0] - 2 : (k == 1 ? s[0] : (k == 2 ? s[1] + s[2] : 0));
  }
  const int n = min(max(s[2], 0), kIds);
  __syncthreads();
  for (int e = threadIdx.x; e < 8 * cols; e += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) {
      const int r0 = clamp_start(ids[i] * 8, 8, rows);
      acc = acc + tab[(size_t)r0 * cols + e];
    }
    out[e] = acc;
  }
}

// D: one warp; row c votes when votes[c, 0] > 0; the voters' ids in
// ascending order, then -1
__global__ void repro_cull_d_kernel(const float* __restrict__ votes,
                                    int* __restrict__ out, int rows,
                                    int cols) {
  const int lane = threadIdx.x;
  const bool vote = lane < rows && votes[(size_t)lane * cols] > 0.f;
  const unsigned ballot = __ballot_sync(0xffffffffu, vote);
  if (lane < rows) {
    if (vote) out[__popc(ballot & ((1u << lane) - 1u))] = lane;
    if (lane >= __popc(ballot)) out[lane] = -1;
  }
}

// ---- K14: one warp a 16 x 16 output tile, two m16n8k8 products --------
//
// The fragments of mma.sync.m16n8k8 (TF32) by lane: g = lane / 4, k =
// lane % 4. A (16 x 8, row-major): a0 = A[g][k], a1 = A[g + 8][k], a2 and
// a3 the same rows at k + 4; B (8 x 8, column-major): b0 = B[k][g], b1 =
// B[k + 4][g]; D (16 x 8): d0, d1 = D[g][2 k], D[g][2 k + 1], d2, d3 the
// same at row g + 8. Depth 3 padded to 8: a2, a3 and b1 are zero in every
// lane, and the lanes k = 3 hold zeros too, so lanes 3..7 of the table
// are never read.

__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D = A B, one m16n8k8 product whose a2, a3 and b1 are zero
__device__ __forceinline__ float4 mma_k3(unsigned a0, unsigned a1,
                                         unsigned b0) {
  float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%6}, {%7,%6}, {%0,%1,%2,%3};\n"
      : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
      : "r"(a0), "r"(a1), "r"(0u), "r"(b0));
  return d;
}

template <int kLd>
__global__ void repro_dot_k3_kernel(const float* __restrict__ lhs,
                                    const float* __restrict__ rays,
                                    float* __restrict__ out, int T) {
  const int lane = threadIdx.x, g = lane >> 2, k = lane & 3;
  const int m0 = blockIdx.y * 16, n0 = blockIdx.x * 16;
  unsigned a0 = 0, a1 = 0, b0 = 0, b1 = 0;  // b1: the second product's b0
  if (k < 3) {
    a0 = tf32_bits(lhs[(size_t)(m0 + g) * kLd + k]);
    a1 = tf32_bits(lhs[(size_t)(m0 + g + 8) * kLd + k]);
    b0 = tf32_bits(rays[(size_t)k * T + n0 + g]);
    b1 = tf32_bits(rays[(size_t)k * T + n0 + 8 + g]);
  }
  const float4 lo = mma_k3(a0, a1, b0), hi = mma_k3(a0, a1, b1);
  float* top = out + (size_t)(m0 + g) * T + n0 + 2 * k;
  float* bottom = top + (size_t)8 * T;
  *reinterpret_cast<float2*>(top) = make_float2(lo.x, lo.y);
  *reinterpret_cast<float2*>(top + 8) = make_float2(hi.x, hi.y);
  *reinterpret_cast<float2*>(bottom) = make_float2(lo.z, lo.w);
  *reinterpret_cast<float2*>(bottom + 8) = make_float2(hi.z, hi.w);
}

// ---- the launch floor ---------------------------------------------------

// An empty kernel of one warp. It replaces no TPU kernel: launched through
// the repros' launcher (tools/mosaic_repros/_common.py), it costs what any
// launch of K10-K14 costs before its body runs, on the host and on the
// device, the floor their rows are read against.
__global__ void repro_empty_kernel() {}

int blocks(int n, int per) { return (n + per - 1) / per; }

template <class T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}

cudaStream_t stream_of(long long v) { return ptr<CUstream_st>(v); }

}  // namespace

extern "C" {

// Every entry takes one argument, a block of int64 slots: the launch's
// arguments in the order its comment gives (pointers as addresses), then
// the raw handle of the stream to launch on. It returns
// cudaGetLastError() after the launch (0 on success); shapes and
// alignment are checked by the Python wrappers
// (tools/mosaic_repros/_common.py::Entry packs the block).

// The launch floor: [stream].
int rtw_repro_empty_launch(const long long* a) {
  repro_empty_kernel<<<1, 32, 0, stream_of(a[0])>>>();
  return (int)cudaGetLastError();
}

// K10: [form, out, rows, T, stream], out (rows, T); form 0 f32 iota, 1 int
// iota + cast.
int rtw_repro_iota_launch(const long long* a) {
  const int form = (int)a[0], rows = (int)a[2], T = (int)a[3];
  float* out = ptr<float>(a[1]);
  cudaStream_t st = stream_of(a[4]);
  if (form == 0) {
    repro_iota_f32_kernel<<<blocks(T, kThreads), kThreads, 0, st>>>(out, rows,
                                                                    T);
  } else if (form == 1) {
    repro_iota_int_cast_kernel<<<blocks(rows * T, kThreads), kThreads, 0,
                                 st>>>(out, rows, T);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K11: [form, row, col, out, SB, T, W, stream], row (1, T), col (SB, 1),
// out (SB, T); W threads a block, T % W == 0, T / W <= 8; form 0 register
// slice, 1 ref load.
int rtw_repro_slice_launch(const long long* a) {
  const int form = (int)a[0], SB = (int)a[4], T = (int)a[5], W = (int)a[6];
  const float* row = ptr<const float>(a[1]);
  const float* col = ptr<const float>(a[2]);
  float* out = ptr<float>(a[3]);
  cudaStream_t st = stream_of(a[7]);
  if (form == 0) {
    repro_slice_kernel<true><<<SB, W, 0, st>>>(row, col, out, T, W);
  } else if (form == 1) {
    repro_slice_kernel<false><<<SB, W, 0, st>>>(row, col, out, T, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K12: [x, out, n, cols, stream], x of n elements, out of n elements whose
// rows 0..2 (width cols) are written: min, max, trips.
int rtw_repro_scalar_reduce_launch(const long long* a) {
  repro_scalar_reduce_kernel<<<1, kThreads, 0, stream_of(a[4])>>>(
      ptr<const float>(a[0]), ptr<float>(a[1]), (int)a[2], (int)a[3]);
  return (int)cudaGetLastError();
}

// K13: [probe, s, tab, out, rows, cols, stream], probe 0..3 = A..D. s: the
// (4,) int32 scalars (A, B, C); tab: the table (rows, cols); out: float32
// (A, B, C) or int32 (D).
int rtw_repro_cull_launch(const long long* a) {
  const int probe = (int)a[0], rows = (int)a[4], cols = (int)a[5];
  const int* s = ptr<const int>(a[1]);
  const float* tab = ptr<const float>(a[2]);
  float* o = ptr<float>(a[3]);
  cudaStream_t st = stream_of(a[6]);
  switch (probe) {
    case 0:
      repro_cull_a_kernel<<<1, kThreads, 0, st>>>(s, tab, o, rows, cols);
      break;
    case 1:
      repro_cull_b_kernel<<<1, kThreads, 0, st>>>(s, tab, o, rows, cols);
      break;
    case 2:
      repro_cull_c_kernel<<<1, kThreads, 0, st>>>(s, tab, o, rows, cols);
      break;
    case 3:
      repro_cull_d_kernel<<<1, 32, 0, st>>>(tab, ptr<int>(a[3]), rows, cols);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K14: [form, lhs, rays, out, S, T, stream], lhs (S, 128) table (form 0,
// sub-slice) or (S, 3) (form 1, dense), rays (3, T), out (S, T);
// S % 16 == 0, T % 16 == 0.
int rtw_repro_dot_k3_launch(const long long* a) {
  const int form = (int)a[0], S = (int)a[4], T = (int)a[5];
  const float* lhs = ptr<const float>(a[1]);
  const float* rays = ptr<const float>(a[2]);
  float* out = ptr<float>(a[3]);
  cudaStream_t st = stream_of(a[6]);
  const dim3 grid(T / 16, S / 16);
  if (form == 0) {
    repro_dot_k3_kernel<128><<<grid, 32, 0, st>>>(lhs, rays, out, T);
  } else if (form == 1) {
    repro_dot_k3_kernel<3><<<grid, 32, 0, st>>>(lhs, rays, out, T);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

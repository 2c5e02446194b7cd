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
//   K10 the f32 iota makes its first row's value from the row's bits (an
//       OR and an FADD) and adds 1.0f a row after it (no integer-to-float
//       conversion); the int iota converts the row index with
//       __int2float_rn (I2F). Both store float4s where the width allows,
//       from a grid over columns and runs of rows.
//   K11 the register slice loads a thread's lanes of the (1, T) row once,
//       into registers, and slices them per W-lane chunk; the ref load
//       re-reads the chunk's lanes inside each chunk. Both apply the lane
//       offset ch * W to the load and to the store alike.
//   K12 min and max as jnp.min / jnp.max take them: NaN if any element is
//       NaN (PTX min.NaN / max.NaN), and of +0.0 and -0.0 the min -0.0,
//       the max +0.0 (PTX's order, XLA's). Up to 8192 elements one block
//       (at the repro's (8, 128) one warp, each lane's eight float4 loads
//       in flight at once): a tree in each thread, a butterfly shuffle
//       that leaves the pair in every lane, the pair written by one lane
//       to a __shared__ scratch (the SMEM scratch) and read back after
//       __syncwarp (one __syncthreads for more warps). The repro's while
//       loop in closed form: ceil(span / 13) clamped to [0, 100], then
//       corrected by one against the exact i * 13 comparison. Rows 0..2
//       stored with no integer division, float4s where the width allows.
//       Past 8192 elements a grid: each block reduces a grid-stride share
//       into per-call partials, and the last block to take an atomic
//       ticket combines them, counts and stores, in one launch. Indices
//       are 64-bit.
//   K13 the runtime scalars are read inside the kernel from a device int32
//       array (never launch arguments), as the repro's SMEM input; a
//       dynamic slice start is the int32 product k * size, wrapped as
//       JAX's is, then clamped into the table as lax.dynamic_slice clamps
//       it. C writes its id list to __shared__ memory (entries it does
//       not write are 0) and takes min(max(n, 0), 8) of them, each id read
//       with a dynamic index. A-C run a thread a float4 of the output (a
//       float where the width is not a multiple of 4), so a thread's chain
//       is the scalars, then one wave of independent loads (C: all its
//       blocks, added after in id order). D compacts with one
//       warp's __ballot_sync and a __popc prefix, in ascending row order,
//       the rest filled with -1; its column count is 64-bit.
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
// paths: one block or warp (K12, K13 D) or a few dozen (K12's grid, for
// inputs past 8192 elements, is bound by their bytes). What a design can
// still cut is the launch's own cost: each entry takes one argument block
// (below), which the host packs in one call, and an empty kernel,
// launched the same way, measures the floor of a launch.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 8;  // K11's register slice holds T / W <= 8
constexpr int kIds = 8;        // K13 C's id list, the repro's SMEM (8,)
constexpr long long kMaxGridY = 65535;  // a grid's y extent

// ---- K10: out (rows, T) as units of kVec floats, U units a row --------
//
// Block (x, y) covers units x * blockDim.x ... of rows y * R ... y * R +
// R - 1 (R from the host, so that the grid's y fits), one unit a thread a
// row, indexed in 64 bits: every shape the wrapper admits (rows <= 2^24,
// any T) is written, and no thread divides (an integer division would
// convert to float). kVec = 4 (a float4 store) where T % 4 == 0 and the
// output is 16-byte aligned.

template <int kVec>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T splat(float v) { return v; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T splat(float v) {
    return make_float4(v, v, v, v);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

// Row r < 2^24 as a float with no integer-to-float conversion: its low 23
// bits under 2^23's exponent, less 2^23 (an OR and one FADD, exact), and
// bit 23 added back as 2^23 (exact below 2^24).
__device__ __forceinline__ float row_value(int r) {
  const float low = __int_as_float(0x4B000000 | (r & 0x7FFFFF)) - 8388608.0f;
  return (r & 0x800000) ? low + 8388608.0f : low;
}

template <bool kCast, int kVec>
__device__ __forceinline__ void iota_rows(float* __restrict__ out, int rows,
                                          size_t units, int per_block) {
  using V = typename Vec<kVec>::T;
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= units) return;
  const int r0 = blockIdx.y * per_block, r1 = min(r0 + per_block, rows);
  V* dst = reinterpret_cast<V*>(out) + (size_t)r0 * units + j;
  float v = kCast ? 0.f : row_value(r0);
  for (int r = r0; r < r1; ++r, dst += units, v += 1.0f) {
    *dst = Vec<kVec>::splat(kCast ? __int2float_rn(r) : v);
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    repro_iota_f32_kernel(float* __restrict__ out, int rows, size_t units,
                          int per_block) {
  iota_rows<false, kVec>(out, rows, units, per_block);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    repro_iota_int_cast_kernel(float* __restrict__ out, int rows,
                               size_t units, int per_block) {
  iota_rows<true, kVec>(out, rows, units, per_block);
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

// ---- K12: min, max and the trip count of x's n elements, rows 0..2 -----
//
// A thread's share is read in waves of kPer units (kVec floats, Vec
// above), all kPer loads of a wave issued before any is used; the
// one-block form's shapes (n <= 8192 at kVec = 4) take one wave.

constexpr int kPer = 8;

// min / max that return NaN when either operand is NaN (jnp.min's rule;
// fminf / fmaxf drop it); of +0.0 and -0.0 PTX's min is -0.0, its max
// +0.0, as XLA's
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (lo, hi) and a (min, max) pair
__device__ __forceinline__ void take(float& lo, float& hi, float2 p) {
  lo = min_nan(lo, p.x);
  hi = max_nan(hi, p.y);
}

// the identities of min and max: +inf, -inf
__device__ __forceinline__ float2 no_pair() {
  return make_float2(__int_as_float(0x7f800000),
                     __int_as_float((int)0xff800000));
}

// a unit's (min, max)
__device__ __forceinline__ float2 unit_pair(float v) {
  return make_float2(v, v);
}
__device__ __forceinline__ float2 unit_pair(float4 v) {
  return make_float2(min_nan(min_nan(v.x, v.y), min_nan(v.z, v.w)),
                     max_nan(max_nan(v.x, v.y), max_nan(v.z, v.w)));
}

// The block's thread t takes units base + k T (k < kPer, T threads) of
// each wave, the waves gridDim.x blocks apart; a unit past the end reads
// the wave's first (min and max are idempotent), so every load of a wave
// is unconditional. A wave reduces as a tree (depth 2 in a float4, then 3
// over the kPer units), not as a chain through each float; every loop
// here has a constant trip count, so the arrays stay in registers.
template <int kVec>
__device__ __forceinline__ void reduce_share(const float* __restrict__ x,
                                             size_t units, float& lo,
                                             float& hi) {
  using V = typename Vec<kVec>::T;
  static_assert(kPer == 8, "the tree below has three levels");
  const V* src = reinterpret_cast<const V*>(x);
  const size_t T = blockDim.x, wave = T * kPer;
  const size_t stride = wave * gridDim.x;
  for (size_t base = blockIdx.x * wave + threadIdx.x; base < units;
       base += stride) {
    V v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const size_t u = base + k * T;
      v[k] = __ldg(src + (u < units ? u : base));
    }
    float2 p[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) p[k] = unit_pair(v[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) take(p[k].x, p[k].y, p[k + 4]);
#pragma unroll
    for (int k = 0; k < 2; ++k) take(p[k].x, p[k].y, p[k + 2]);
    take(p[0].x, p[0].y, p[1]);
    take(lo, hi, p[0]);
  }
}

// Every thread's (lo, hi) to the block's, in every thread: a butterfly
// leaves each warp's pair in all its lanes; lane 0 of each warp writes it
// to the scratch s (the repro's SMEM scratch) and every thread reads the
// pairs back, after __syncwarp for one warp, after one __syncthreads for
// more.
__device__ __forceinline__ void block_minmax(float& lo, float& hi,
                                             float2* s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = make_float2(lo, hi);
  if (warps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  lo = s[0].x;
  hi = s[0].y;
  for (int w = 1; w < warps; ++w) take(lo, hi, s[w]);
}

// The repro's while loop in closed form: the least i in [0, 100] with
// i * 13 >= span (i * 13 is exact), as a float. ceil(span / 13) by a
// multiply is at most one off the exact quotient's ceiling; the exact
// comparisons correct it. NaN gives 0 (fmaxf drops it), +inf 100.
__device__ __forceinline__ float trips_of(float span) {
  float i = fminf(fmaxf(ceilf(span * (1.0f / 13.0f)), 0.0f), 100.0f);
  if (i > 0.0f && (i - 1.0f) * 13.0f >= span) {
    i -= 1.0f;
  } else if (i < 100.0f && i * 13.0f < span) {
    i += 1.0f;
  }
  return i;
}

// Rows 0..2 of out (width cols) = lo, hi, trips: the block's thread t
// writes columns t, t + T, ... of each row, float4s where `vec` (cols % 4
// == 0 and out 16-byte aligned); no integer division.
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           long long cols, bool vec,
                                           float lo, float hi,
                                           float trips) {
  const float v[3] = {lo, hi, trips};
  const size_t T = blockDim.x, t = threadIdx.x;
  if (vec) {
    const size_t c4 = (size_t)cols / 4;
    float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int r = 0; r < 3; ++r, o += c4) {
      const float4 s = Vec<4>::splat(v[r]);
      for (size_t c = t; c < c4; c += T) o[c] = s;
    }
  } else {
    float* o = out;
#pragma unroll
    for (int r = 0; r < 3; ++r, o += cols) {
      for (size_t c = t; c < (size_t)cols; c += T) o[c] = v[r];
    }
  }
}

// One block: its threads reduce x, the pair goes through the scratch, and
// every thread counts the trips and stores its columns. One block an SM at
// most (the bound's 1) frees ptxas to keep a lane's kPer loads in flight
// at once: under the bare bound it issued half of them, then waited on the
// first (two round trips; 1.66 against 1.53 µs on the H100).
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
    repro_scalar_reduce_kernel(const float* __restrict__ x,
                               float* __restrict__ out, long long n,
                               long long cols, bool vec) {
  __shared__ float2 s_ref[kThreads / 32];
  float lo = no_pair().x, hi = no_pair().y;
  reduce_share<kVec>(x, (size_t)n / kVec, lo, hi);
  block_minmax(lo, hi, s_ref);
  store_rows(out, cols, vec, lo, hi, trips_of(hi - lo));
}

// The grid: each block reduces its grid-stride share to part[blockIdx.x];
// the block that takes the last ticket (after a __threadfence, so every
// partial is visible) combines them, counts the trips and stores.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    repro_scalar_reduce_grid_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, long long n,
                                    long long cols, bool vec,
                                    float2* __restrict__ part,
                                    unsigned* __restrict__ ticket) {
  __shared__ float2 s_ref[kThreads / 32];
  __shared__ bool last;
  float lo = no_pair().x, hi = no_pair().y;
  reduce_share<kVec>(x, (size_t)n / kVec, lo, hi);
  block_minmax(lo, hi, s_ref);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = make_float2(lo, hi);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  lo = no_pair().x;
  hi = no_pair().y;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    take(lo, hi, __ldcg(part + b));
  }
  block_minmax(lo, hi, s_ref);
  store_rows(out, cols, vec, lo, hi, trips_of(hi - lo));
}

// ---- K13: the four dynamic-cull probes ----------------------------------
//
// A-C: one thread a unit (kVec floats, Vec above) of the output, units
// over the grid; kVec = 4 where the table's width is a multiple of 4 and
// both arrays are 16-byte aligned. A thread's chain is two round trips to
// memory: the scalars, then one wave of independent table loads.

// Block k's slice start, k * size as JAX's int32 product (wrapping; the
// product is taken in unsigned, where wrapping is defined), clamped into
// the extent as lax.dynamic_slice clamps.
__device__ __forceinline__ long long block_start(int k, int size,
                                                 long long extent) {
  const int start = (int)((unsigned)k * (unsigned)size);
  return min(max((long long)start, 0ll), extent - size);
}

__device__ __forceinline__ size_t unit_index() {
  return (size_t)blockIdx.x * kThreads + threadIdx.x;
}

// A: out (8, cols) = tab[8 k : 8 k + 8], k = s[0]; cu = cols / kVec
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    repro_cull_a_kernel(const int* __restrict__ s,
                        const float* __restrict__ tab,
                        float* __restrict__ out, long long rows,
                        long long cu) {
  using V = typename Vec<kVec>::T;
  const size_t u = unit_index();
  if (u >= 8 * (size_t)cu) return;
  const long long r0 = block_start(s[0], 8, rows);
  reinterpret_cast<V*>(out)[u] =
      reinterpret_cast<const V*>(tab)[(size_t)r0 * cu + u];
}

// B: out (rows, 128) = att[:, 128 k : 128 k + 128], k = s[1]
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    repro_cull_b_kernel(const int* __restrict__ s,
                        const float* __restrict__ att,
                        float* __restrict__ out, long long rows,
                        long long cols) {
  using V = typename Vec<kVec>::T;
  constexpr int kRow = 128 / kVec;  // units an output row
  const size_t u = unit_index();
  if (u >= (size_t)rows * kRow) return;
  const long long c0 = block_start(s[1], 128, cols);
  const float* src = att + (u / kRow) * cols + c0 + (u % kRow) * kVec;
  reinterpret_cast<V*>(out)[u] = *reinterpret_cast<const V*>(src);
}

// C: ids (s0 - 2, s0, s1 + s2) to shared memory (the rest 0), then the sum
// of the n = s[2] 8-row blocks they name, in id order. Each lane reads the
// id of its lane index (a dynamic index into the shared list) and clamps
// its start; the warp shares the starts by shuffle, and a thread issues
// its loads of all n blocks at once, then adds them in id order.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    repro_cull_c_kernel(const int* __restrict__ s,
                        const float* __restrict__ tab,
                        float* __restrict__ out, long long rows,
                        long long cu) {
  using V = typename Vec<kVec>::T;
  __shared__ int ids[kIds];
  const int t = threadIdx.x;
  if (t < kIds) {
    ids[t] = t == 0 ? s[0] - 2 : (t == 1 ? s[0] : (t == 2 ? s[1] + s[2] : 0));
  }
  const int n = min(max(s[2], 0), kIds);
  __syncthreads();
  const long long mine = block_start(ids[t & (kIds - 1)], 8, rows);
  const size_t u = unit_index();
  const bool live = u < 8 * (size_t)cu;
  const V* src = reinterpret_cast<const V*>(tab) + u;
  V v[kIds];
#pragma unroll
  for (int i = 0; i < kIds; ++i) {
    const long long r0 = __shfl_sync(0xffffffffu, mine, i);
    if (live && i < n) v[i] = src[(size_t)r0 * cu];
  }
  if (!live) return;
  V acc = Vec<kVec>::splat(0.f);
#pragma unroll
  for (int i = 0; i < kIds; ++i) {
    if (i < n) acc = Vec<kVec>::add(acc, v[i]);
  }
  reinterpret_cast<V*>(out)[u] = acc;
}

// D: one warp; row c votes when votes[c, 0] > 0; the voters' ids in
// ascending order, then -1
__global__ void repro_cull_d_kernel(const float* __restrict__ votes,
                                    int* __restrict__ out, int rows,
                                    long long cols) {
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

template <class T>
T* ptr(long long v) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(v));
}

cudaStream_t stream_of(long long v) { return ptr<CUstream_st>(v); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K10's launch of form kCast (1: the int iota + cast) on out (rows, T)
template <bool kCast, int kVec>
int launch_iota(float* out, long long rows, long long T, cudaStream_t st) {
  const long long units = T / kVec;
  const long long warps = (units + 31) / 32;  // a block: U rounded to warps
  const int threads = warps < kThreads / 32 ? (int)warps * 32 : kThreads;
  const long long per_block = (rows + kMaxGridY - 1) / kMaxGridY;
  const dim3 grid((unsigned)((units + threads - 1) / threads),
                  (unsigned)((rows + per_block - 1) / per_block));
  if (kCast) {
    repro_iota_int_cast_kernel<kVec><<<grid, threads, 0, st>>>(
        out, (int)rows, (size_t)units, (int)per_block);
  } else {
    repro_iota_f32_kernel<kVec><<<grid, threads, 0, st>>>(
        out, (int)rows, (size_t)units, (int)per_block);
  }
  return (int)cudaGetLastError();
}

template <bool kCast>
int launch_iota_form(float* out, long long rows, long long T,
                     cudaStream_t st) {
  return T % 4 == 0 && aligned16(out)
             ? launch_iota<kCast, 4>(out, rows, T, st)
             : launch_iota<kCast, 1>(out, rows, T, st);
}

// K12's one block: a warp for every 32 kPer units, up to kThreads threads
// (at (8, 128) one warp: a block of one float4 a thread, eight warps, ran
// slower on its barrier)
template <int kVec>
int launch_reduce(const float* x, float* out, long long n, long long cols,
                  bool vec, cudaStream_t st) {
  const long long per_warp = 32 * kPer;
  const long long warps = (n / kVec + per_warp - 1) / per_warp;
  const int threads = warps < kThreads / 32 ? (int)warps * 32 : kThreads;
  repro_scalar_reduce_kernel<kVec><<<1, threads, 0, st>>>(x, out, n, cols,
                                                          vec);
  return (int)cudaGetLastError();
}

// K12's grid: as many blocks of kThreads as the card holds at once (a
// grid-stride loop with blocks waiting for a slot would run their shares
// after the rest), at most `blocks` (the partials' slots) and no more than
// the units fill; its ticket zeroed on the stream first.
template <int kVec>
int launch_reduce_grid(const float* x, float* out, long long n,
                       long long cols, bool vec, float2* part,
                       long long blocks, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, repro_scalar_reduce_grid_kernel<kVec>, kThreads, 0);
  }
  unsigned* ticket = reinterpret_cast<unsigned*>(part + blocks);
  if (e == cudaSuccess) e = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const long long fill = (n / kVec + kThreads * kPer - 1) / (kThreads * kPer);
  const long long grid =
      std::min(std::min(blocks, fill), (long long)std::max(sms * per_sm, 1));
  repro_scalar_reduce_grid_kernel<kVec><<<(unsigned)grid, kThreads, 0, st>>>(
      x, out, n, cols, vec, part, ticket);
  return (int)cudaGetLastError();
}

// K13's launch of probe A-C (see rtw_repro_cull_launch)
template <int kVec>
int launch_cull(int probe, const int* s, const float* tab, float* o,
                long long rows, long long cols, cudaStream_t st) {
  const long long units = (probe == 1 ? rows * 128 : 8 * cols) / kVec;
  const long long grid = (units + kThreads - 1) / kThreads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const unsigned g = (unsigned)grid;
  if (probe == 0) {
    repro_cull_a_kernel<kVec><<<g, kThreads, 0, st>>>(s, tab, o, rows,
                                                      cols / kVec);
  } else if (probe == 1) {
    repro_cull_b_kernel<kVec><<<g, kThreads, 0, st>>>(s, tab, o, rows, cols);
  } else {
    repro_cull_c_kernel<kVec><<<g, kThreads, 0, st>>>(s, tab, o, rows,
                                                      cols / kVec);
  }
  return (int)cudaGetLastError();
}

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
  float* out = ptr<float>(a[1]);
  cudaStream_t st = stream_of(a[4]);
  if (a[0] == 0) return launch_iota_form<false>(out, a[2], a[3], st);
  if (a[0] == 1) return launch_iota_form<true>(out, a[2], a[3], st);
  return (int)cudaErrorInvalidValue;
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
// rows 0..2 (width cols) are written: min, max, trips; one block (the
// wrapper takes it up to 8192 elements). Loads are float4s where n % 4 ==
// 0 and x is 16-byte aligned, stores where cols % 4 == 0 and out is.
int rtw_repro_scalar_reduce_launch(const long long* a) {
  const float* x = ptr<const float>(a[0]);
  float* out = ptr<float>(a[1]);
  const long long n = a[2], cols = a[3];
  const bool vec = cols % 4 == 0 && aligned16(out);
  cudaStream_t st = stream_of(a[4]);
  return n % 4 == 0 && aligned16(x)
             ? launch_reduce<4>(x, out, n, cols, vec, st)
             : launch_reduce<1>(x, out, n, cols, vec, st);
}

// K12's grid: [x, out, n, cols, work, blocks, stream], as above; work: a
// float32 scratch of 2 blocks + 1 slots (`blocks` (min, max) partials,
// then the ticket), blocks >= 1.
int rtw_repro_scalar_reduce_grid_launch(const long long* a) {
  const float* x = ptr<const float>(a[0]);
  float* out = ptr<float>(a[1]);
  const long long n = a[2], cols = a[3], blocks = a[5];
  float2* part = ptr<float2>(a[4]);
  const bool vec = cols % 4 == 0 && aligned16(out);
  cudaStream_t st = stream_of(a[6]);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  return n % 4 == 0 && aligned16(x)
             ? launch_reduce_grid<4>(x, out, n, cols, vec, part, blocks, st)
             : launch_reduce_grid<1>(x, out, n, cols, vec, part, blocks, st);
}

// K13: [probe, s, tab, out, rows, cols, stream], probe 0..3 = A..D. s: the
// (4,) int32 scalars (A, B, C); tab: the table (rows, cols); out: float32
// (A, B, C) or int32 (D). A-C take float4 units where cols % 4 == 0 and
// tab and out are 16-byte aligned, else single floats.
int rtw_repro_cull_launch(const long long* a) {
  const int probe = (int)a[0];
  const long long rows = a[4], cols = a[5];
  const int* s = ptr<const int>(a[1]);
  const float* tab = ptr<const float>(a[2]);
  float* o = ptr<float>(a[3]);
  cudaStream_t st = stream_of(a[6]);
  if (probe == 3) {
    repro_cull_d_kernel<<<1, 32, 0, st>>>(tab, ptr<int>(a[3]), (int)rows,
                                          cols);
    return (int)cudaGetLastError();
  }
  if (probe < 0 || probe > 3) return (int)cudaErrorInvalidValue;
  return cols % 4 == 0 && aligned16(tab) && aligned16(o)
             ? launch_cull<4>(probe, s, tab, o, rows, cols, st)
             : launch_cull<1>(probe, s, tab, o, rows, cols, st);
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

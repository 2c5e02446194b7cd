// Megakernel for scenes of spheres, axis rects and constant media: the
// whole path-trace loop in one launch.
//
// Replaces raytracingweekend_tpu/ops/megakernel.py::_kernel in its C=1
// configuration (one dense sphere cluster, no culling): the sphere path
// with constant textures (ROADMAP kernel K1, mega_kernel) and, in
// mega_kernel_surfaces, the rect hit with baked flip / rotate_y /
// translate, the one-sample MIS over rect and sphere lights, one-sided
// emission (K2), the stochastic constant-medium boundaries with isotropic
// scatter (K3) and, in its kTextures instantiations, checker, Perlin-noise
// and image textures on spheres, rects and media (K4); in
// mega_kernel_culled, the cluster culling of large sphere tables (K5:
// _kernel's slab votes and dynamic survivor-list sweep, megakernel.py:553-996);
// and, in mega_kernel_culled_surfaces, that culled sweep followed by the
// rect, medium and texture hit and shading of K2-K4 (K5s: _kernel with
// `cull` on a scene with rects, lights, media or textures).
// Plain version beside it: raytracingweekend_tpu_torch/ops/megakernel.py::
// trace_mega_reference (noise: ops/noise.py).
//
// One thread owns one lane, a pixel slot, and loops over bounces:
//   camera ray (jitter, shutter time, thin lens) -> closest hit over every
//   sphere slot (moving centres, sign-flipped half-b quadratic, near-else-far
//   root with t_min, first slot with the strictly smallest t wins) ->
//   shading from the winner's attribute row (lambertian cosine sample,
//   metal reflect + fuzz, dielectric with Schlick and the corrected exit
//   cosine) or the gradient sky on a miss -> Russian roulette ->
//   regeneration of the slot's next sample when its path ends.
//
// Two modes:
//   overdraw (exact == 0): one block is one tile of T <= 1024 lanes; every
//     valid lane keeps tracing samples of its own pixel until the slowest
//     lane of the block has spp (__syncthreads_or after every `unroll`
//     bounces: the JAX kernel's cfg.unroll; the overshoot adds samples), and
//     the host epilogue renormalises by the per-lane sample count;
//   exact (exact == 1): every lane traces exactly spp samples on its own
//     and writes its winner code per iteration: -1 miss, [0, S) sphere
//     slot, S + r rect row, S + R + v medium row (the JAX tape encoding).
//     Blocks are 256 threads (the surfaces kernel's 64); T is then only
//     the tile width of the RNG key (tile = lane / T, lane % T), so the
//     streams match any logical T.
//
// Random numbers are the lowbias32 counter hash of (seed, tile, iteration,
// draw site, row, lane), bit for bit the JAX package's `_uniforms`.
// Built without --use_fast_math and with -fmad=false: every fused
// multiply-add is an explicit fmaf, placed where XLA's CPU backend contracts
// the JAX kernel's expressions (the plain version writes the same FMAs), so
// the kernel and its plain version round alike and differ only where their
// rsqrtf / expf / logf implementations do.
//
// What bounds it: FP32 issue. Book-1 scenes spend it in the S-slot
// quadratic, about 20 flops per (sphere, segment); Cornell scenes in the
// R-rect plane tests and the light-pdf re-intersection. Every table (the
// sphere slots, then the rect, light and medium rows and their static
// codes) is copied once per block into shared memory and broadcast to the
// threads of a warp. The dense sweep's slots are staged as sweep.cuh lays
// them out: a 16-byte (centre, -r^2) quad a slot and only the motion lanes
// the instantiation lerps (its template mask of moving axes: static, y
// only as in book 1, or all), so a book-1 slot costs two shared loads in
// place of the (9, S) table's seven. The surfaces kernel is instantiated
// a feature set (kF*: rects, lights, media, each texture kind; the host
// plans the form that holds its scene's), so a form carries only the
// code and registers of what its scenes use. Its rects run by transform
// group and axis, the plane lanes picked at compile time and each row two
// 16-byte loads and one branchless test (rect_run); the lights and media
// loop at run time over their codes. Its camera vector sits in shared
// memory, its sweep stops at the last live slot, and its overdraw blocks
// take their tiles longest first, in the order the host learned from the
// last launch. The sphere attribute rows stay in global
// memory and are read once per bounce through the read-only path (__ldg).
//
// Culling (K5): a dense sweep of S slots costs ~25 instructions a slot and
// its staged slots (16-36 bytes each) stop fitting in shared memory at
// 6400-14500 slots. The
// culled kernel keeps only the (C, 6) cluster boxes there; each warp
// ballots a cluster (the TPU kernel's whole-tile any() becomes a warp's),
// so a warp visits only the clusters one of its rays can reach before its
// running best, in near-to-far order keyed by a __reduce_min_sync of the
// slab entries, and sweeps them for the lanes whose own rays need them.
// A warp's need is often a few lanes (1 lane on ~10% of visits at
// random_balls_large): below kBcast needing lanes the warp sweeps the
// cluster once per needing lane, 32 slots at a time with two warp
// minimums, instead of all SB slots for all 32 lanes. With static
// spheres a warp copies the centre quads of the next cluster one of its
// rays can reach into shared memory (cp.async) while it re-votes and
// sweeps the current one, and reads them there, broadcast or 32
// consecutive; moving slots read all their quads through L1. The culled
// surfaces kernel (K5s) adds the surfaces tables behind the boxes and
// bucket slots in shared memory, and runs the surfaces bounce after the
// sweep on the warp's active lanes.
//
// Plan modes (the JAX kernel's cfg.sg, cfg.batch_votes and cfg.unroll; the
// host's make_plan, each off by default): two-level votes on the union
// boxes of super-groups of clusters, batched votes against t_min alone,
// and U bounce iterations between an overdraw block's checks. The culled
// kernels compile the three in their own instantiations
// (mega_kernel_culled_modes, mega_kernel_culled_surfaces_modes), launched
// only for a plan that takes one, so the default plan's kernels carry none
// of their code or registers; the dense kernels take U at run time, a
// three-instruction divisibility test a bounce (checks). k lanes a pixel
// and the coherent pixel layout are the host's (the pixel table).
//
// Textures (K4): a Perlin evaluation makes 6 permutation reads and 8
// gradient reads per octave at data-dependent addresses (marble and turb
// take 7 octaves), so the 256-entry permutation and the 256 float32
// gradients, each a float4 (one 16-byte load, 4 KB), sit in shared
// memory, where a warp's scattered reads do not serialise as they would
// in constant memory. The JAX kernel's bf16
// hi/lo one-hot lookups of those tables are a TPU device: this kernel
// indexes the exact float32 values. Texels stay in device memory (the
// earth image is 768 KB, resident in the 50 MB L2) and are read through
// __ldg, one nearest texel per hit. The sphere uv keeps the JAX kernel's
// polynomial atan2 / asin, and sinf / floorf are IEEE (no fast math), so
// the texel index and the noise round as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sweep.cuh"

// The culled kernels' plan-mode instantiations' launch, compiled apart in
// megakernel_modes.cu (this source again, with RTW_MODES_TU), so that nvcc
// builds the two halves in parallel: `moving`, `uniform_time` the form,
// `surfaces` -1 for K5, else K5s with (1) or without (0) textures; p, k,
// q, x this source's Params, Clusters, Surfaces, Texels. Returns the
// launch's CUDA error.
extern "C" int rtw_culled_modes_launch(int moving, int uniform_time,
                                       int surfaces, size_t smem,
                                       const void* p, const void* k,
                                       const void* q, const void* x,
                                       void* stream);

namespace {

using namespace rtw_sweep;  // kBig, the sweep SoA lanes L_*, sweep_slots
constexpr float kHitCut = 1.0e30f;
constexpr int kOutRows = 8;
constexpr int kExactBlock = 256;

// attribute table rows (24, S), as ops/megakernel.py A_*
enum { A_CX, A_CY, A_CZ, A_DCX, A_DCY, A_DCZ, A_T0, A_IDT, A_RINV, A_MTYPE,
       A_ALBX, A_ALBY, A_ALBZ, A_MPARAM, A_NSCALE, A_CHK, A_EVENX, A_EVENY,
       A_EVENZ, A_ODDX, A_ODDY, A_ODDZ, A_NOISE, A_IMG };
// rect / light / medium lanes, as ops/megakernel.py RT_* / LT_* / MD_*; the
// shared-memory copy keeps the first k*Lanes of each 128-lane table row,
// and the texture lanes (RT_CHK.., MD_NOI..) only in texture launches
enum { RT_A0, RT_A1, RT_B0, RT_B1, RT_K, RT_COS, RT_SIN, RT_OFFX, RT_OFFY,
       RT_OFFZ, RT_NX, RT_NY, RT_NZ, RT_MTYPE, RT_ALBX, RT_ALBY, RT_ALBZ,
       RT_FUZZ, RT_RIDX, RT_CHK, RT_EVENX, RT_EVENY, RT_EVENZ, RT_ODDX,
       RT_ODDY, RT_ODDZ, RT_NOI, RT_NSC, RT_IMG, RT_IDA, RT_IDB };
enum { LT_A0, LT_A1, LT_B0, LT_B1, LT_K, LT_COS, LT_SIN, LT_OFFX, LT_OFFY,
       LT_OFFZ, LT_AREA, LT_CX, LT_CY, LT_CZ, LT_RAD, kLightLanes };
enum { MD_P0X, MD_P0Y, MD_P0Z, MD_P1X, MD_P1Y, MD_P1Z, MD_COS, MD_SIN,
       MD_OFFX, MD_OFFY, MD_OFFZ, MD_NIRHO, MD_ALBX, MD_ALBY, MD_ALBZ,
       MD_NOI, MD_NSC, MD_IMG };
constexpr int kRectLanes = RT_RIDX + 1, kRectTexLanes = RT_IDB + 1;
constexpr int kMedLanes = MD_ALBZ + 1, kMedTexLanes = MD_IMG + 1;
template <bool kTex>
__host__ __device__ constexpr int rect_lanes() {
  return kTex ? kRectTexLanes : kRectLanes;
}
template <bool kTex>
__host__ __device__ constexpr int med_lanes() {
  return kTex ? kMedTexLanes : kMedLanes;
}
constexpr int kTableLanes = 128;  // row stride of the rect/light/medium tables
constexpr int kNoiseSize = 256;   // Perlin permutation and gradient entries
// float32 roundings of the plain version's constants
constexpr float kInvPi = 0x1.45f306p-2f;   // 1 / pi
constexpr float kTwoPi = 0x1.921fb6p+2f;   // 2 pi
constexpr float kTiny20 = 0x1.79ca10p-67f; // 1e-20
constexpr float kTiny30 = 0x1.4484c0p-100f; // 1e-30
constexpr float kTiny38 = 0x1.b38fb8p-127f; // 1e-38 (subnormal)
// the sphere uv's constants, float32 roundings of the JAX kernel's, whose
// pi is 3.14159265358979
constexpr float kPiUv = 0x1.921fb6p+1f;        // pi
constexpr float kHalfPiUv = 0x1.921fb6p+0f;    // pi / 2
constexpr float kHalfInvPiUv = 0x1.45f306p-3f; // 0.5 / pi
constexpr float kInvPiUv = 0x1.45f306p-2f;     // 1 / pi
constexpr float kTexelBias = 0x1.0624dep-10f;  // 0.001 of the row index
// camera vector lanes, as ops/megakernel.py CAM_*
enum { CAM_OX, CAM_OY, CAM_OZ, CAM_LLX, CAM_LLY, CAM_LLZ, CAM_HX, CAM_HY,
       CAM_HZ, CAM_VX, CAM_VY, CAM_VZ, CAM_UX, CAM_UY, CAM_UZ, CAM_WX, CAM_WY,
       CAM_WZ, CAM_LENS, CAM_T0, CAM_T1, kCamLanes };

struct Params {
  const float* pixf;   // (n_tiles, 4, T): pixel i, pixel j, valid, pad
  const float* cam;    // (1, 128) camera vector
  const float* sph;    // (9, S) sweep SoA; culled: slot quads (S, 4 Q)
  const float* attr;   // (24, S) attribute rows
  float* out;          // (n_tiles, 8 + n_iters, T)
  int n_tiles, T, S, n_iters;
  uint32_t seed;
  float spp, max_depth, rr_depth;  // rr_depth < 0: no roulette
  int exact, lens, bg_gradient, uniform_time;
  float inv_nx, inv_ny, t_min, ut_t0, ut_idt;
  // overdraw: a block checks its lanes every `unroll` = U = u 2^shift
  // iterations (u odd): after iteration it when checks(p, it)
  uint32_t unroll, unroll_inv, unroll_lim;  // 1 / u mod 2^32, ~0u / U
  int unroll_shift;
};

// Whether U divides it, in three ALU instructions and no divide: it * (1 /
// u) mod 2^32, rotated right by shift, is at most ~0u / U exactly when it
// is a multiple of U (Granlund and Montgomery's divisibility test); always
// at U = 1.
__device__ __forceinline__ bool checks(const Params& p, uint32_t it) {
  const uint32_t y = it * p.unroll_inv;
  return __funnelshift_r(y, y, p.unroll_shift) <= p.unroll_lim;
}

// The rect, light and medium tables of a surfaces launch (K2, K3).
struct Surfaces {
  const float* rect;   // (max(R, 1), 128) rect rows
  const float* light;  // (max(L, 1), 128) light rows
  const float* med;    // (max(V, 1), 128) medium rows
  // static per-row codes, R + L + V of them:
  //   rect   axis | rotated << 2 | translated << 3 | transform group << 4
  //   light  kind | axis << 1 | rotated << 3 | translated << 4
  //   medium kind | rotated << 1 | translated << 2
  const int* codes;
  int R, L, V, has_spheres;
  float inv_L;  // 1 / L
};

// The texture tables of a texture launch (K4). In a texture launch the
// codes array continues after the R + L + V row codes with (height, width)
// of each image.
struct Texels {
  const int* perm;      // (256,) Perlin permutation
  const float* ranvec;  // (256, 3) Perlin unit gradients
  const float* images;  // (n_img, img_h, img_w, 3) texels, row 0 at the top
  int n_img, img_h, img_w;
};

// The features a surfaces instantiation compiles (its kFeat mask; the
// host's SURFACE_FORMS, ops/megakernel.py F_*): rects, the MIS lights,
// constant media, and the image, checker and noise textures. A feature
// left out is not compiled at all, so a form runs only the code (and
// holds only the registers) of what its scenes use; a form serves any
// scene whose features it holds, bit for bit (a loop over 0 rows, or a
// texture flag no row sets, changes nothing).
enum { kFRects = 1, kFLights = 2, kFMedia = 4, kFImage = 8, kFChecker = 16,
       kFNoise = 32 };
constexpr int kFTex = kFImage | kFChecker | kFNoise;
constexpr int kFSurf = kFRects | kFLights | kFMedia;  // every untextured one
constexpr int kFAll = kFSurf | kFTex;

struct Lane {
  float ox, oy, oz, dx, dy, dz, time;
  float tpx, tpy, tpz, rx, ry, rz, ax, ay, az;
  float segs, depth, done, iters;
};

// ---- RNG: lowbias32(seed + lane*K1 + row*K2 + it*K3 + tile*K4 + salt*K5) --
__device__ __forceinline__ uint32_t stream_base(uint32_t seed, uint32_t tile,
                                                uint32_t it, uint32_t salt,
                                                uint32_t lane) {
  return seed + lane * 0x9E3779B1u + it * 0xC2B2AE3Du + tile * 0x27D4EB2Fu +
         salt * 0x165667B1u;
}

__device__ __forceinline__ float uniform_row(uint32_t base, uint32_t row) {
  uint32_t x = base + row * 0x85EBCA77u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

// cos/sin(2 pi u), u in [0, 1): the JAX package's full-period polynomial
// pair in x = u - 1/2 (Horner over x^2; coefficients are the float32
// roundings of its constants). No sincosf: the polynomial keeps the exact
// mode's parity with the plain version tight.
__device__ __forceinline__ void cossin2pi(float u, float& c, float& s) {
  const float x = u - 0.5f;
  const float x2 = x * x;
  float cp = fmaf(-0x1.73ff2ap+0f, x2, 0x1.f3355ap+2f);
  cp = fmaf(cp, x2, -0x1.a67986p+4f);
  cp = fmaf(cp, x2, 0x1.e1efe2p+5f);
  cp = fmaf(cp, x2, -0x1.55d39ep+6f);
  cp = fmaf(cp, x2, 0x1.03c1f0p+6f);
  cp = fmaf(cp, x2, -0x1.3bd3ccp+4f);
  cp = fmaf(cp, x2, 0x1.000000p+0f);
  float sp = fmaf(-0x1.3ae924p-1f, x2, 0x1.e35294p+1f);
  sp = fmaf(sp, x2, -0x1.e2b4acp+3f);
  sp = fmaf(sp, x2, 0x1.50757ep+5f);
  sp = fmaf(sp, x2, -0x1.32d2b2p+6f);
  sp = fmaf(sp, x2, 0x1.466bc6p+6f);
  sp = fmaf(sp, x2, -0x1.4abbcep+5f);
  sp = fmaf(sp, x2, 0x1.921fb6p+2f);
  c = -cp;
  s = -(x * sp);
}

struct Cam {
  float c[kCamLanes];
};
// The camera vector staged in shared memory (the surfaces kernels): read
// where a ray is made, not held in 21 registers across the lane loop.
struct CamSm {
  const float* c;
};

// Fresh jittered camera ray for (tile, lane) at iteration `it`, salt 1
// (camera.h:36-50); the first rays of a launch use it = -1. `cam` is a Cam
// or a CamSm.
template <class CamT>
__device__ __forceinline__ void gen_ray(const Params& p, const CamT& cam,
                                        uint32_t tile, uint32_t lane,
                                        uint32_t it, float pxi, float pxj,
                                        Lane& L) {
  const float* c = cam.c;
  const uint32_t b = stream_base(p.seed, tile, it, 1u, lane);
  const float s = (pxi + uniform_row(b, 0)) * p.inv_nx;
  const float t = (pxj + uniform_row(b, 1)) * p.inv_ny;
  L.time = fmaf(uniform_row(b, 2), c[CAM_T1] - c[CAM_T0], c[CAM_T0]);
  float offx = 0.f, offy = 0.f, offz = 0.f;
  if (p.lens) {
    const float r = c[CAM_LENS] * sqrtf(uniform_row(b, 3));
    float cph, sph;
    cossin2pi(uniform_row(b, 4), cph, sph);
    const float rdx = r * cph, rdy = r * sph;
    offx = fmaf(c[CAM_UX], rdx, c[CAM_WX] * rdy);
    offy = fmaf(c[CAM_UY], rdx, c[CAM_WY] * rdy);
    offz = fmaf(c[CAM_UZ], rdx, c[CAM_WZ] * rdy);
  }
  L.ox = c[CAM_OX] + offx;
  L.oy = c[CAM_OY] + offy;
  L.oz = c[CAM_OZ] + offz;
  const float dx = fmaf(t, c[CAM_VX], fmaf(s, c[CAM_HX], c[CAM_LLX])) - L.ox;
  const float dy = fmaf(t, c[CAM_VY], fmaf(s, c[CAM_HY], c[CAM_LLY])) - L.oy;
  const float dz = fmaf(t, c[CAM_VZ], fmaf(s, c[CAM_HZ], c[CAM_LLZ])) - L.oz;
  const float inv = rsqrtf(fmaf(dz, dz, fmaf(dx, dx, dy * dy)));
  L.dx = dx * inv;
  L.dy = dy * inv;
  L.dz = dz * inv;
}

// Closest hit over every slot of the shared-memory table (sweep.cuh),
// lerping the centres along the axes of kAxes. Returns the winner slot (S
// on a miss) and its t in `best`.
template <int kAxes, bool kUniformTime>
__device__ __forceinline__ int sweep(const Params& p, const float* sm,
                                     const Lane& L, float& best) {
  const float frac_u = kUniformTime ? (L.time - p.ut_t0) * p.ut_idt : 0.f;
  return sweep_slots<kAxes, kUniformTime>(sm, p.S, L, frac_u, p.t_min,
                                          best);
}

__device__ __forceinline__ float attr_at(const Params& p, int row, int slot) {
  return __ldg(p.attr + (size_t)row * p.S + slot);
}

// One bounce iteration of one lane. Returns the winner code (-1 for a miss
// or an idle lane, else the sphere slot). kAxes is the sweep's moving-axis
// mask (sweep.cuh); any moving mask lerps the winner's centre on all three
// axes for its normal. With kSwept the closest hit comes from the caller
// (the culled kernel's sweep: swept_bidx, swept_best) and `sm` is not read.
template <int kAxes, bool kUniformTime, bool kSwept = false>
__device__ __forceinline__ int bounce(const Params& p, const float* sm,
                                      const Cam& cam, Lane& L, bool active,
                                      uint32_t tile, uint32_t lane,
                                      uint32_t it, float pxi, float pxj,
                                      int swept_bidx = 0,
                                      float swept_best = 0.f) {
  bool alive = false;
  int code = -1;
  float px = 0.f, py = 0.f, pz = 0.f, ndx = 0.f, ndy = 0.f, ndz = 0.f;
  if (active) {
    L.segs += 1.f;
    float best = swept_best;
    const int bidx =
        kSwept ? swept_bidx : sweep<kAxes, kUniformTime>(p, sm, L, best);
    if (best < kHitCut) {
      code = bidx;
      px = fmaf(best, L.dx, L.ox);
      py = fmaf(best, L.dy, L.oy);
      pz = fmaf(best, L.dz, L.oz);
      // ---- sphere normal ((p - c(t)) / r; a negative r points inward) ----
      float scx = attr_at(p, A_CX, bidx);
      float scy = attr_at(p, A_CY, bidx);
      float scz = attr_at(p, A_CZ, bidx);
      if (kAxes != kAxesStatic) {
        const float fr =
            (L.time - attr_at(p, A_T0, bidx)) * attr_at(p, A_IDT, bidx);
        scx = fmaf(fr, attr_at(p, A_DCX, bidx), scx);
        scy = fmaf(fr, attr_at(p, A_DCY, bidx), scy);
        scz = fmaf(fr, attr_at(p, A_DCZ, bidx), scz);
      }
      const float rinv = attr_at(p, A_RINV, bidx);
      const float nx = (px - scx) * rinv;
      const float ny = (py - scy) * rinv;
      const float nz = (pz - scz) * rinv;
      const float mtype = attr_at(p, A_MTYPE, bidx);
      const float mparam = attr_at(p, A_MPARAM, bidx);  // fuzz or IOR
      float wx = attr_at(p, A_ALBX, bidx);
      float wy = attr_at(p, A_ALBY, bidx);
      float wz = attr_at(p, A_ALBZ, bidx);
      const uint32_t b2 = stream_base(p.seed, tile, it, 2u, lane);
      bool scatter_ok = true;
      // mirror reflection, shared by metal and dielectric
      const float ddn = fmaf(L.dz, nz, fmaf(L.dx, nx, L.dy * ny));
      const float rfx = fmaf(-2.f * ddn, nx, L.dx);
      const float rfy = fmaf(-2.f * ddn, ny, L.dy);
      const float rfz = fmaf(-2.f * ddn, nz, L.dz);
      if (mtype < 0.5f) {
        // ---- lambertian: cosine sample about the normal (u0, u1) ----
        const float r2 = uniform_row(b2, 1);
        const float z = sqrtf(fmaxf(1.f - r2, 0.f));
        const float sq = sqrtf(r2);
        float cphi, sphi;
        cossin2pi(uniform_row(b2, 0), cphi, sphi);
        const float lx = cphi * sq, ly = sphi * sq;
        // branchless ONB about n (onb.h:32-38)
        const bool bigx = fabsf(nx) > 0.9f;
        float vx = bigx ? -nz : 0.f;
        float vy = bigx ? 0.f : nz;
        float vz = bigx ? nx : -ny;
        const float vinv =
            rsqrtf(fmaf(vz, vz, fmaf(vx, vx, vy * vy)) + 1e-30f);
        vx *= vinv;
        vy *= vinv;
        vz *= vinv;
        const float ux = fmaf(ny, vz, -(nz * vy));
        const float uy = fmaf(nz, vx, -(nx * vz));
        const float uz = fmaf(nx, vy, -(ny * vx));
        ndx = fmaf(z, nx, fmaf(lx, ux, ly * vx));
        ndy = fmaf(z, ny, fmaf(lx, uy, ly * vy));
        ndz = fmaf(z, nz, fmaf(lx, uz, ly * vz));
        scatter_ok = z > 0.f;
      } else if (mtype < 1.5f) {
        // ---- metal: reflect + fuzz * point in the unit ball (u2, u3, u4) --
        const float zb = 1.f - 2.f * uniform_row(b2, 2);
        const float rb = sqrtf(fmaxf(fmaf(-zb, zb, 1.f), 0.f));
        float cpb, spb;
        cossin2pi(uniform_row(b2, 3), cpb, spb);
        const float radb =
            expf(logf(fmaxf(uniform_row(b2, 4), 1e-30f)) * 0.333333343f);
        ndx = fmaf(mparam, rb * cpb * radb, rfx);
        ndy = fmaf(mparam, rb * spb * radb, rfy);
        ndz = fmaf(mparam, zb * radb, rfz);
      } else {
        // ---- dielectric, corrected exit cosine (material.h:142-225; u5) --
        const float ridx = mparam;
        const bool inside = ddn > 0.f;
        const float sgn = inside ? -1.f : 1.f;
        const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
        const float nint = inside ? ridx : 1.f / fmaxf(ridx, 1e-6f);
        const float cos_exit2 =
            fmaf(-(ridx * ridx), fmaf(-ddn, ddn, 1.f), 1.f);
        const float cos_exit = sqrtf(fmaxf(cos_exit2, 0.f));
        const float cosine = inside ? cos_exit : -ddn;
        const float dt = fmaf(L.dz, onz, fmaf(L.dx, onx, L.dy * ony));
        const float disc_r = fmaf(-(nint * nint), fmaf(-dt, dt, 1.f), 1.f);
        const float sqr = sqrtf(fmaxf(disc_r, 0.f));
        float r0 = (1.f - ridx) / (1.f + ridx);
        r0 = r0 * r0;
        const float omc = 1.f - cosine;
        const float omc2 = omc * omc;
        const float schl = fmaf((1.f - r0) * omc2 * omc2, omc, r0);
        const float rp = disc_r > 0.f ? schl : 1.f;
        if (uniform_row(b2, 5) < rp) {
          ndx = rfx;
          ndy = rfy;
          ndz = rfz;
        } else {
          ndx = fmaf(nint, fmaf(-onx, dt, L.dx), -(onx * sqr));
          ndy = fmaf(nint, fmaf(-ony, dt, L.dy), -(ony * sqr));
          ndz = fmaf(nint, fmaf(-onz, dt, L.dz), -(onz * sqr));
        }
        wx = wy = wz = 1.f;
      }
      const float ninv =
          rsqrtf(fmaf(ndz, ndz, fmaf(ndx, ndx, ndy * ndy)) + 1e-30f);
      ndx *= ninv;
      ndy *= ninv;
      ndz *= ninv;
      // ---- throughput, Russian roulette (u6) ----
      L.tpx *= wx;
      L.tpy *= wy;
      L.tpz *= wz;
      const float tpmax = fmaxf(L.tpx, fmaxf(L.tpy, L.tpz));
      alive = scatter_ok && tpmax > 0.f;
      if (alive && p.rr_depth >= 0.f && L.depth >= p.rr_depth) {
        const float pc = fminf(fmaxf(tpmax, 0.05f), 0.95f);
        if (uniform_row(b2, 6) < pc) {
          const float inv_p = 1.f / pc;
          L.tpx *= inv_p;
          L.tpy *= inv_p;
          L.tpz *= inv_p;
        } else {
          alive = false;
        }
      }
    } else if (p.bg_gradient) {
      // ---- gradient sky on a miss (RayTracingWeekend.cpp:143-158) ----
      const float tbg = 0.5f * (L.dy + 1.f);
      L.rx += L.tpx * fmaf(tbg, 0.5f, 1.f - tbg);
      L.ry += L.tpy * fmaf(tbg, 0.7f, 1.f - tbg);
      L.rz += L.tpz;
    }
    L.depth += 1.f;
    alive = alive && L.depth < p.max_depth;
    if (!alive) {
      L.ax += L.rx;
      L.ay += L.ry;
      L.az += L.rz;
      L.done += 1.f;
    }
  }
  // ---- continue the path, or regenerate the slot's next sample ----
  if (alive) {
    L.ox = px;
    L.oy = py;
    L.oz = pz;
    L.dx = ndx;
    L.dy = ndy;
    L.dz = ndz;
  } else {
    gen_ray(p, cam, tile, lane, it, pxi, pxj, L);
    L.tpx = L.tpy = L.tpz = 1.f;
    L.rx = L.ry = L.rz = 0.f;
    L.depth = 0.f;
  }
  return code;
}

// ---------------------------------------------------------------------------
// Rects, lights and media (the surfaces kernel: K2 and K3)
// ---------------------------------------------------------------------------

// Cycle split of the dense surfaces kernel's bounce, built only with
// -DRTW_SPLIT (tools/culled_ab.py, chip_smoke.py): each lane's clock64
// cycles in each part of its bounces (the closest sphere, the rects with
// the ray's reciprocals, the media, each material's shading, with the
// lambertian's light sample and light pdf apart, each texture kind, the
// regeneration of a finished sample, and the overdraw barrier), summed
// over the lanes; kSsTotal is the lane loop's. What no part holds (the
// hit point and normal, throughput and roulette, the wait of lanes that
// took a shorter branch) is the rest. Each lane counts in shared memory
// (kSurfParts words a lane) and adds its counts to g_surf_split at its
// end; with g_block_times set (rtw_split_blocks), each overdraw block's
// thread 0 writes its start and end on the global timer (ns) and its SM.
enum { kSsTotal, kSsSweep, kSsRects, kSsMedia, kSsLambertian, kSsLightDir,
       kSsLightPdf, kSsMetal, kSsDielectric, kSsEmission, kSsIsotropic,
       kSsNoise, kSsChecker, kSsImage, kSsRegen, kSsBarrier, kSurfParts };
#ifdef RTW_SPLIT
__device__ unsigned long long g_surf_split[kSurfParts];
__device__ unsigned long long* g_block_times;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct SurfSplit {
  unsigned* acc;  // this lane's counts, kDenseMaxT words apart
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void add(int i, long long t0) const {
    acc[i * kDenseMaxT] += (unsigned)(clock64() - t0);
  }
  __device__ __forceinline__ void flush() const {
#pragma unroll 1
    for (int i = 0; i < kSurfParts; ++i) {
      atomicAdd(&g_surf_split[i], (unsigned long long)acc[i * kDenseMaxT]);
    }
  }
};
#endif
// The surfaces bounce without a split (every other build and kernel).
struct NoSplit {
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void add(int, long long) const {}
  __device__ __forceinline__ void flush() const {}
};

// NaN-propagating min / max, as torch.minimum / maximum and XLA's: the
// slab of a ray that runs in a face's plane gives 0 * inf = NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The shared-memory copy of a surfaces launch's tables. The rects are
// also staged as runs (stage_surfaces): grouped by transform group, then
// by axis, each run's rows in row order, two float4 a row, (k, a0, a1,
// b0) and (b1, the row's index as int bits, 1 / (a1 - a0), 1 / (b1 -
// b0)); each group's header int4 is (the offset of its transform lanes
// in `rect` | rotated << 24 | translated << 25, then its rows along
// axis 0, 1 and 2).
struct Tables {
  const float* rect;   // (R, rect_lanes)
  const float* light;  // (L, kLightLanes)
  const float* med;    // (V, med_lanes)
  const int* code;     // R rect, L light, V medium codes
  const float4* runs;  // (R, 2) rect rows by group and axis
  const int4* grp;     // (G,) group headers
  int R, L, V, G, has_spheres;
  float inv_L;
};

// A ray in the object space of a row's baked transform: the world -> object
// map undoes translate, then rotate_y (hittable.h:294-416). `tf` holds cos,
// sin, offx, offy, offz in consecutive lanes.
__device__ __forceinline__ void to_object(const float* tf, bool rot,
                                          bool trans, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& rox, float& roy,
                                          float& roz, float& rdx, float& rdy,
                                          float& rdz) {
  rdy = dy;
  if (rot) {
    const float cth = tf[0], sth = tf[1];
    const float sx = ox - tf[2], sz = oz - tf[4];
    rox = fmaf(cth, sx, -(sth * sz));
    roy = oy - tf[3];
    roz = fmaf(sth, sx, cth * sz);
    rdx = fmaf(cth, dx, -(sth * dz));
    rdz = fmaf(sth, dx, cth * dz);
  } else if (trans) {
    rox = ox - tf[2];
    roy = oy - tf[3];
    roz = oz - tf[4];
    rdx = dx;
    rdz = dz;
  } else {
    rox = ox;
    roy = oy;
    roz = oz;
    rdx = dx;
    rdz = dz;
  }
}

// (a, b, n) components of a vector for rect axis code 0 (XY: plane z = k),
// 1 (XZ: plane y = k) or 2 (YZ: plane x = k)
__device__ __forceinline__ void plane_axes(int ax, float x, float y, float z,
                                           float& a, float& b, float& n) {
  a = ax == 2 ? y : x;
  b = ax == 0 ? y : z;
  n = ax == 0 ? z : (ax == 1 ? y : x);
}

// One run of rect rows along axis kAx (Tables::runs) against the object
// ray (o, d) of their group, `inv` its 1 / d_n: each row's plane t and
// point, merged into (rb_t, rwin) by the order of the row loop (the first
// row with the strictly smallest t): a smaller t, or an equal t of a row
// before the winner. With kTex, the winner's planar uv (hittable.h:
// 160-172) in r_u, r_v.
template <int kAx, bool kTex>
__device__ __forceinline__ void rect_run(const float4* rows, int n,
                                         float t_min, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float inv, float& rb_t,
                                         int& rwin, float& r_u, float& r_v) {
  float oa, ob, on, da, db, dn;
  plane_axes(kAx, ox, oy, oz, oa, ob, on);
  plane_axes(kAx, dx, dy, dz, da, db, dn);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const float4 q0 = rows[2 * i], q1 = rows[2 * i + 1];
    const int r = __float_as_int(q1.y);
    // d_n == 0 gives t = +-inf or NaN: every comparison then fails
    const float t = (q0.x - on) * inv;
    const float pa = fmaf(t, da, oa);
    const float pb = fmaf(t, db, ob);
    // one predicate chain and selects, no branch: & where && would
    // branch on each term
    const bool hit = (t > t_min) & ((t < rb_t) | ((t == rb_t) & (r < rwin))) &
                     (pa >= q0.y) & (pa <= q0.z) & (pb >= q0.w) &
                     (pb <= q1.x);
    rb_t = hit ? t : rb_t;
    rwin = hit ? r : rwin;
    if (kTex) {  // uv = planar offset / extent
      r_u = hit ? (pa - q0.y) * q1.z : r_u;
      r_v = hit ? (pb - q0.w) * q1.w : r_v;
    }
  }
}

// Closest rect (hittable.h:142-267): the first rect with the strictly
// smallest t wins. Rects of one transform group (a box's faces) share one
// object-space ray; each group's rows run axis by axis (Tables::runs), so
// a row's plane lanes are compile-time picks. Returns the winner row (-1:
// none) and its t in rb_t; with kTex, the winner's planar uv in r_u, r_v.
template <bool kTex>
__device__ __forceinline__ int rect_hit(const Params& p, const Tables& tb,
                                        const Lane& L, float idx, float idy,
                                        float idz, float& rb_t, float& r_u,
                                        float& r_v) {
  rb_t = kBig;
  int rwin = -1;
  const float4* rows = tb.runs;
#pragma unroll 1
  for (int g = 0; g < tb.G; ++g) {
    const int4 h = tb.grp[g];
    const bool rot = (h.x >> 24) & 1;
    float rox, roy, roz, rdx, rdy, rdz;
    to_object(tb.rect + (h.x & 0xFFFFFF), rot, (h.x >> 25) & 1, L.ox, L.oy,
              L.oz, L.dx, L.dy, L.dz, rox, roy, roz, rdx, rdy, rdz);
    const float irx = rot ? 1.f / rdx : idx;
    const float irz = rot ? 1.f / rdz : idz;
    rect_run<0, kTex>(rows, h.y, p.t_min, rox, roy, roz, rdx, rdy, rdz, irz,
                      rb_t, rwin, r_u, r_v);
    rows += 2 * h.y;
    rect_run<1, kTex>(rows, h.z, p.t_min, rox, roy, roz, rdx, rdy, rdz, idy,
                      rb_t, rwin, r_u, r_v);
    rows += 2 * h.z;
    rect_run<2, kTex>(rows, h.w, p.t_min, rox, roy, roz, rdx, rdy, rdz, irx,
                      rb_t, rwin, r_u, r_v);
    rows += 2 * h.w;
  }
  return rwin;
}

// Closest constant-medium scatter distance (hittable.h:430-479): t_in -
// log(u) / density inside the sphere or box boundary, u from salt 4 (one
// row per medium). Returns the winner row (-1: none) and its t in md_t.
template <bool kTex>
__device__ __forceinline__ int media_hit(const Params& p, const Tables& tb,
                                         const Lane& L, float idx, float idy,
                                         float idz, uint32_t b4,
                                         float& md_t) {
  md_t = kBig;
  int mwin = -1;
  for (int v = 0; v < tb.V; ++v) {
    const float* row = tb.med + v * med_lanes<kTex>();
    const int code = tb.code[tb.R + tb.L + v];
    const bool rot = code & 2;
    float mox, moy, moz, mdx, mdy, mdz;
    to_object(row + MD_COS, rot, code & 4, L.ox, L.oy, L.oz, L.dx, L.dy,
              L.dz, mox, moy, moz, mdx, mdy, mdz);
    float m_in, m_out;
    bool m_bh;
    if ((code & 1) == 0) {  // sphere boundary (a = 1)
      const float ocx = mox - row[MD_P0X];
      const float ocy = moy - row[MD_P0Y];
      const float ocz = moz - row[MD_P0Z];
      const float bq = fmaf(ocz, mdz, fmaf(ocx, mdx, ocy * mdy));
      const float rq2 = row[MD_P1X] * row[MD_P1X];
      const float ccq = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy)) - rq2;
      const float dq = fmaf(bq, bq, -ccq);
      const float sqq = sqrtf(fmaxf(dq, 0.f));
      m_in = -bq - sqq;
      m_out = -bq + sqq;
      m_bh = dq > 0.f;
    } else {  // box boundary: the signed-range slab (aabb.h:17-47)
      const float ivx = rot ? 1.f / mdx : idx;
      const float ivz = rot ? 1.f / mdz : idz;
      const float tx0 = (row[MD_P0X] - mox) * ivx;
      const float ty0 = (row[MD_P0Y] - moy) * idy;
      const float tz0 = (row[MD_P0Z] - moz) * ivz;
      const float tx1 = (row[MD_P1X] - mox) * ivx;
      const float ty1 = (row[MD_P1Y] - moy) * idy;
      const float tz1 = (row[MD_P1Z] - moz) * ivz;
      m_in = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                     min_nan(tz0, tz1));
      m_out = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                      max_nan(tz0, tz1));
      m_bh = m_out > m_in;
    }
    m_in = max_nan(m_in, p.t_min);
    const float u = fmaxf(uniform_row(b4, v), kTiny38);
    const float tci = fmaf(row[MD_NIRHO], logf(u), m_in);
    if (m_bh && m_in < m_out && tci < m_out && tci < md_t) {
      md_t = tci;
      mwin = v;
    }
  }
  return mwin;
}

// Branchless ONB about unit w (onb.h:32-38), as ops/megakernel.py::_onb.
__device__ __forceinline__ void onb(float wx, float wy, float wz, float& ux,
                                    float& uy, float& uz, float& vx,
                                    float& vy, float& vz) {
  const bool bigx = fabsf(wx) > 0.9f;
  vx = bigx ? -wz : 0.f;
  vy = bigx ? 0.f : wz;
  vz = bigx ? wx : -wy;
  const float vinv = rsqrtf(fmaf(vz, vz, fmaf(vx, vx, vy * vy)) + kTiny30);
  vx *= vinv;
  vy *= vinv;
  vz *= vinv;
  ux = fmaf(wy, vz, -(wz * vy));
  uy = fmaf(wz, vx, -(wx * vz));
  uz = fmaf(wx, vy, -(wy * vx));
}

// Direction from p toward a sample on light `row` (ul1, ul2: salt-3 rows 1
// and 2): a uniform point on a rect light through its baked transform
// (hittable.h:224-228), or a cone sample of a sphere light (sphere.h:101-108,
// utility.h:69-82).
__device__ __forceinline__ void light_dir(const float* row, int code,
                                          float ul1, float ul2, float px,
                                          float py, float pz, float& lx,
                                          float& ly, float& lz) {
  if ((code & 1) == 0) {
    const float pa = fmaf(ul1, row[LT_A1] - row[LT_A0], row[LT_A0]);
    const float pb = fmaf(ul2, row[LT_B1] - row[LT_B0], row[LT_B0]);
    const float kk = row[LT_K];
    const int ax = (code >> 1) & 3;
    float qx = ax == 2 ? kk : pa;
    const float qy0 = ax == 0 ? pb : (ax == 1 ? kk : pa);
    float qz = ax == 0 ? kk : pb;
    float qy = qy0;
    if (code & 8) {  // object -> world: Ry(theta)
      const float cth = row[LT_COS], sth = row[LT_SIN];
      const float wx = fmaf(cth, qx, sth * qz);
      const float wz = fmaf(cth, qz, -(sth * qx));
      qx = wx;
      qz = wz;
    }
    if (code & 16) {
      qx = qx + row[LT_OFFX];
      qy = qy + row[LT_OFFY];
      qz = qz + row[LT_OFFZ];
    }
    lx = qx - px;
    ly = qy - py;
    lz = qz - pz;
  } else {
    const float tcx = row[LT_CX] - px;
    const float tcy = row[LT_CY] - py;
    const float tcz = row[LT_CZ] - pz;
    const float dist2 = fmaf(tcz, tcz, fmaf(tcx, tcx, tcy * tcy));
    const float rad2 = row[LT_RAD] * row[LT_RAD];
    const float ctm = sqrtf(fmaxf(1.f - rad2 / fmaxf(dist2, kTiny20), 0.f));
    const float zc = fmaf(ul2, ctm - 1.f, 1.f);
    float cpl, spl;
    cossin2pi(ul1, cpl, spl);
    const float sc = sqrtf(fmaxf(fmaf(-zc, zc, 1.f), 0.f));
    const float winv = rsqrtf(fmaxf(dist2, kTiny20));
    const float wlx = tcx * winv, wly = tcy * winv, wlz = tcz * winv;
    float lux, luy, luz, lvx, lvy, lvz;
    onb(wlx, wly, wlz, lux, luy, luz, lvx, lvy, lvz);
    const float cph = cpl * sc, sph = spl * sc;
    lx = fmaf(zc, wlx, fmaf(cph, lux, sph * lvx));
    ly = fmaf(zc, wly, fmaf(cph, luy, sph * lvy));
    lz = fmaf(zc, wlz, fmaf(cph, luz, sph * lvz));
  }
}

// hittable_list::pdf_value over the lights list: the sum of each light's
// solid-angle pdf along unit direction mu from p, each light re-intersected
// (hittable.h:208-222, sphere.h:88-99).
__device__ __forceinline__ float light_pdf(const Params& p, const Tables& tb,
                                           float px, float py, float pz,
                                           float mux, float muy, float muz) {
  float acc = 0.f;
  for (int li = 0; li < tb.L; ++li) {
    const float* row = tb.light + li * kLightLanes;
    const int code = tb.code[tb.R + li];
    bool lh;
    float pdf;
    if ((code & 1) == 0) {
      float qox, qoy, qoz, qdx, qdy, qdz;
      to_object(row + LT_COS, code & 8, code & 16, px, py, pz, mux, muy, muz,
                qox, qoy, qoz, qdx, qdy, qdz);
      float qa, qb, qn, wa, wb, wn;
      const int ax = (code >> 1) & 3;
      plane_axes(ax, qox, qoy, qoz, qa, qb, qn);
      plane_axes(ax, qdx, qdy, qdz, wa, wb, wn);
      const float t = (row[LT_K] - qn) / wn;
      const float ha = fmaf(t, wa, qa);
      const float hb = fmaf(t, wb, qb);
      lh = t > p.t_min && ha >= row[LT_A0] && ha <= row[LT_A1] &&
           hb >= row[LT_B0] && hb <= row[LT_B1];
      // unit probe direction: dist^2 = t^2, cosine = |d_n|
      pdf = (t * t) / fmaxf(fabsf(wn) * row[LT_AREA], kTiny20);
    } else {
      const float ocx = px - row[LT_CX];
      const float ocy = py - row[LT_CY];
      const float ocz = pz - row[LT_CZ];
      const float rad2 = row[LT_RAD] * row[LT_RAD];
      const float b = fmaf(ocz, muz, fmaf(ocx, mux, ocy * muy));
      const float d2 = fmaf(ocz, ocz, fmaf(ocx, ocx, ocy * ocy));
      const float cc = d2 - rad2;
      const float disc = fmaf(b, b, -cc);
      const float sq = sqrtf(fmaxf(disc, 0.f));
      const float tn = -b - sq;
      const float t = tn > p.t_min ? tn : -b + sq;
      lh = disc > 0.f && t > p.t_min;
      const float ctm = sqrtf(fmaxf(1.f - rad2 / fmaxf(d2, kTiny20), 0.f));
      const float solid = kTwoPi * (1.f - ctm);
      pdf = 1.f / fmaxf(solid, kTiny20);
    }
    acc = acc + (lh ? pdf : 0.f);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Textures (K4)
// ---------------------------------------------------------------------------

// The shared-memory noise tables and the texel source of a texture launch.
struct TexTables {
  const int* perm;      // (256,) in shared memory
  const float4* rv;     // (256,) gradients (x, y, z, 0) in shared memory
  const int* hw;        // (height, width) per image
  const float* images;  // (n_img, img_h, img_w, 3) in device memory
  int img_h, img_w;
};

// Gradient Perlin noise in [-1, 1] (noise.h:89-151, hermite smoothstep),
// as ops/noise.py::perlin_noise. Negative lattice coordinates wrap through
// & 255 as int32 does.
__device__ __forceinline__ float perlin(const TexTables& tx, float px,
                                        float py, float pz) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float u = px - fx, v = py - fy, w = pz - fz;
  const int i = (int)fx, j = (int)fy, k = (int)fz;
  const float uu = u * u * (3.f - 2.f * u);
  const float vv = v * v * (3.f - 2.f * v);
  const float ww = w * w * (3.f - 2.f * w);
  const int pi[2] = {tx.perm[i & 255], tx.perm[(i + 1) & 255]};
  const int pj[2] = {tx.perm[j & 255], tx.perm[(j + 1) & 255]};
  const int pk[2] = {tx.perm[k & 255], tx.perm[(k + 1) & 255]};
  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const float wu = di ? uu : 1.f - uu;
    const float ru = u - (float)di;
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const float wv = dj ? vv : 1.f - vv;
      const float rv = v - (float)dj;
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float wwk = dk ? ww : 1.f - ww;
        const float rw = w - (float)dk;
        const float4 g = tx.rv[pi[di] ^ pj[dj] ^ pk[dk]];  // one LDS.128
        const float dot = fmaf(g.z, rw, fmaf(g.x, ru, g.y * rv));
        acc = fmaf(wu * wv * wwk, dot, acc);
      }
    }
  }
  return acc;
}

// 7-octave |fBm| turbulence (noise.h:74-86); the octave weights and scales
// are powers of two, so their products are exact.
__device__ __forceinline__ float turb(const TexTables& tx, float px,
                                      float py, float pz) {
  float acc = 0.f, wgt = 1.f, sc = 1.f;
#pragma unroll 1
  for (int o = 0; o < 7; ++o) {
    acc = acc + wgt * perlin(tx, px * sc, py * sc, pz * sc);
    wgt *= 0.5f;
    sc *= 2.f;
  }
  return fabsf(acc);
}

// The JAX kernel's octant-reduced polynomial atan2 (range (-pi, pi],
// atan2(0, 0) = 0, y = -0 on the -pi side), as ops/megakernel.py::_atan2.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float a = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), kTiny30);
  const float s = a * a;
  float p = fmaf(0x1.095508p-7f, s, -0x1.354312p-5f);
  p = fmaf(p, s, 0x1.5b2cfcp-4f);
  p = fmaf(p, s, -0x1.154068p-3f);
  p = fmaf(p, s, 0x1.97733cp-3f);
  p = fmaf(p, s, -0x1.55474ap-2f);
  p = fmaf(p, s, 0x1.fffff6p-1f);
  float r = a * p;
  if (ay > ax) r = kHalfPiUv - r;
  if (x < 0.f) r = kPiUv - r;
  return signbit(y) ? -r : r;
}

// The albedo of a hit under its texture, in the JAX kernel's order (a
// later override wins; a texture sets at most one of them):
//   noise   noi = 1 + NOISE_* (texture.h:55-69): marble, smooth, turb;
//   checker chk > 0.5 (texture.h:35-46): the sign of the product of sines
//           picks the odd colour (cols[3..5] * stride) or the even one;
//   image   img = 1 + image id (texture.h:73-98): the nearest texel at
//           (u, v), a sphere's from its unit normal (sphere.h:115-122).
template <int kFeat, class SS>
__device__ __forceinline__ void texture_albedo(
    const TexTables& tx, float noi, float nsc, float chk, const float* cols,
    int stride, float img, bool sphere_uv, float u, float v, float px,
    float py, float pz, float nx, float ny, float nz, float& wx, float& wy,
    float& wz, const SS& ss) {
  long long t0 = ss.now();
  if ((kFeat & kFNoise) && noi > 0.5f) {
    const int mode = (int)noi - 1;
    float val;
    if (mode == 0) {  // marble: 0.5 (1 + sin(scale z + 10 turb(p)))
      val = 0.5f * (1.f + sinf(fmaf(nsc, pz, 10.f * turb(tx, px, py, pz))));
    } else if (mode == 1) {  // smooth: 0.5 (1 + noise(scale p))
      val = 0.5f * (1.f + perlin(tx, px * nsc, py * nsc, pz * nsc));
    } else {  // turb(scale p)
      val = turb(tx, px * nsc, py * nsc, pz * nsc);
    }
    wx = wy = wz = val;
    ss.add(kSsNoise, t0);
  }
  t0 = ss.now();
  if ((kFeat & kFChecker) && chk > 0.5f) {
    const float sines = sinf(10.f * px) * sinf(10.f * py) * sinf(10.f * pz);
    const float* c = cols + (sines < 0.f ? 3 * stride : 0);
    wx = c[0];
    wy = c[stride];
    wz = c[2 * stride];
    ss.add(kSsChecker, t0);
  }
  t0 = ss.now();
  if ((kFeat & kFImage) && img > 0.5f) {
    if (sphere_uv) {
      const float phi = atan2_poly(nz, nx);
      const float sy = fminf(fmaxf(ny, -1.f), 1.f);  // asin(ny)
      const float theta =
          atan2_poly(sy, sqrtf(fmaxf(fmaf(-sy, sy, 1.f), 0.f)));
      u = fmaf(-(phi + kPiUv), kHalfInvPiUv, 1.f);
      v = (theta + kHalfPiUv) * kInvPiUv;
    }
    const int id = (int)img - 1;
    const int h = tx.hw[2 * id], w = tx.hw[2 * id + 1];
    const int i = min(max((int)(u * (float)w), 0), w - 1);
    const int j = min(max((int)fmaf(1.f - v, (float)h, -kTexelBias), 0),
                      h - 1);
    const float* t =
        tx.images + (((size_t)id * tx.img_h + j) * tx.img_w + i) * 3;
    wx = __ldg(t);
    wy = __ldg(t + 1);
    wz = __ldg(t + 2);
    ss.add(kSsImage, t0);
  }
}

// One bounce iteration of one lane in a scene with rects, lights or media,
// or textures: the features of kFeat (kF*) are compiled, the others not.
// Returns the winner code (-1 for a miss or an idle lane). With kSwept the
// closest sphere hit comes from the caller (the culled kernel's sweep:
// swept_bidx, swept_best) and `sm` is not read; the rects and media then
// merge after it as after the dense sweep. Else the dense sweep visits the
// slots up to the last live one (n_live; padding slots never hit). kAxes
// as in `bounce`.
template <int kAxes, bool kUniformTime, int kFeat, bool kSwept = false,
          class SS = NoSplit>
__device__ __forceinline__ int bounce_surfaces(
    const Params& p, const float* sm, const Tables& tb, const TexTables& tx,
    const CamSm& cam, Lane& L, bool active, uint32_t tile, uint32_t lane,
    uint32_t it, float pxi, float pxj, int swept_bidx = 0,
    float swept_best = 0.f, const SS& ss = SS{}, int n_live = 0) {
  constexpr bool kTex = (kFeat & kFTex) != 0;
  constexpr bool kRects = (kFeat & kFRects) != 0;
  constexpr bool kMedia = (kFeat & kFMedia) != 0;
  bool alive = false;
  int code = -1;
  float px = 0.f, py = 0.f, pz = 0.f, ndx = 0.f, ndy = 0.f, ndz = 0.f;
  if (active) {
    L.segs += 1.f;
    float s_best = kBig;
    int bidx = p.S;
    if (kSwept) {
      s_best = swept_best;
      bidx = swept_bidx;
    } else if (tb.has_spheres) {
      const long long t0 = ss.now();
      const float frac_u =
          kUniformTime ? (L.time - p.ut_t0) * p.ut_idt : 0.f;
      bidx = sweep_slots<kAxes, kUniformTime>(sm, p.S, L, frac_u, p.t_min,
                                              s_best, n_live);
      ss.add(kSsSweep, t0);
    }
    long long t0 = ss.now();
    float idx = 0.f, idy = 0.f, idz = 0.f;
    if (kRects || kMedia) {
      idx = 1.f / L.dx;
      idy = 1.f / L.dy;
      idz = 1.f / L.dz;
    }
    float rb_t = kBig, r_u = 0.f, r_v = 0.f;
    int rwin = -1;
    if (kRects) rwin = rect_hit<kTex>(p, tb, L, idx, idy, idz, rb_t, r_u, r_v);
    ss.add(kSsRects, t0);
    const bool use_rect = rb_t < s_best;
    float best = fminf(s_best, rb_t);
    float md_t = kBig;
    int mwin = -1;
    t0 = ss.now();
    if (kMedia) {
      mwin = media_hit<kTex>(p, tb, L, idx, idy, idz,
                             stream_base(p.seed, tile, it, 4u, lane), md_t);
    }
    ss.add(kSsMedia, t0);
    const bool use_med = kMedia && md_t < best;
    best = fminf(best, md_t);
    if (best < kHitCut) {
      code = use_med ? p.S + tb.R + mwin : (use_rect ? p.S + rwin : bidx);
      px = fmaf(best, L.dx, L.ox);
      py = fmaf(best, L.dy, L.oy);
      pz = fmaf(best, L.dz, L.oz);
      const uint32_t b2 = stream_base(p.seed, tile, it, 2u, lane);
      float wx, wy, wz;
      bool scatter_ok = true;
      if (use_med) {
        // ---- isotropic scatter at a medium vertex (material.h:252-265):
        // a point in the unit ball (u2, u3, u4) ----
        t0 = ss.now();
        const float* row = tb.med + mwin * med_lanes<kTex>();
        const float zb = 1.f - 2.f * uniform_row(b2, 2);
        const float rb = sqrtf(fmaxf(fmaf(-zb, zb, 1.f), 0.f));
        float cpb, spb;
        cossin2pi(uniform_row(b2, 3), cpb, spb);
        const float radb =
            expf(logf(fmaxf(uniform_row(b2, 4), 1e-30f)) * 0.333333343f);
        ndx = rb * cpb * radb;
        ndy = rb * spb * radb;
        ndz = zb * radb;
        wx = row[MD_ALBX];
        wy = row[MD_ALBY];
        wz = row[MD_ALBZ];
        ss.add(kSsIsotropic, t0);
        if (kTex) {  // noise or image, no checker; media sample uv (0, 0)
          texture_albedo<kFeat>(tx, row[MD_NOI], row[MD_NSC], 0.f, row, 0,
                         row[MD_IMG], false, 0.f, 0.f, px, py, pz, 0.f, 0.f,
                         0.f, wx, wy, wz, ss);
        }
      } else {
        float nx, ny, nz, mtype, fuzz, ridx;
        if (use_rect) {
          const float* row = tb.rect + rwin * rect_lanes<kTex>();
          nx = row[RT_NX];
          ny = row[RT_NY];
          nz = row[RT_NZ];
          mtype = row[RT_MTYPE];
          wx = row[RT_ALBX];
          wy = row[RT_ALBY];
          wz = row[RT_ALBZ];
          fuzz = row[RT_FUZZ];
          ridx = row[RT_RIDX];
          if (kTex) {
            texture_albedo<kFeat>(tx, row[RT_NOI], row[RT_NSC], row[RT_CHK],
                           row + RT_EVENX, 1, row[RT_IMG], false, r_u, r_v,
                           px, py, pz, nx, ny, nz, wx, wy, wz, ss);
          }
        } else {
          // ---- sphere normal ((p - c(t)) / r) ----
          float scx = attr_at(p, A_CX, bidx);
          float scy = attr_at(p, A_CY, bidx);
          float scz = attr_at(p, A_CZ, bidx);
          if (kAxes != kAxesStatic) {
            const float fr =
                (L.time - attr_at(p, A_T0, bidx)) * attr_at(p, A_IDT, bidx);
            scx = fmaf(fr, attr_at(p, A_DCX, bidx), scx);
            scy = fmaf(fr, attr_at(p, A_DCY, bidx), scy);
            scz = fmaf(fr, attr_at(p, A_DCZ, bidx), scz);
          }
          const float rinv = attr_at(p, A_RINV, bidx);
          nx = (px - scx) * rinv;
          ny = (py - scy) * rinv;
          nz = (pz - scz) * rinv;
          mtype = attr_at(p, A_MTYPE, bidx);
          wx = attr_at(p, A_ALBX, bidx);
          wy = attr_at(p, A_ALBY, bidx);
          wz = attr_at(p, A_ALBZ, bidx);
          fuzz = ridx = attr_at(p, A_MPARAM, bidx);
          if (kTex) {  // checker colours: rows A_EVENX.. A_ODDZ, stride S
            texture_albedo<kFeat>(tx, attr_at(p, A_NOISE, bidx),
                           attr_at(p, A_NSCALE, bidx), attr_at(p, A_CHK, bidx),
                           p.attr + (size_t)A_EVENX * p.S + bidx, p.S,
                           attr_at(p, A_IMG, bidx), true, 0.f, 0.f, px, py, pz,
                           nx, ny, nz, wx, wy, wz, ss);
          }
        }
        const float ddn = fmaf(L.dz, nz, fmaf(L.dx, nx, L.dy * ny));
        const float rfx = fmaf(-2.f * ddn, nx, L.dx);
        const float rfy = fmaf(-2.f * ddn, ny, L.dy);
        const float rfz = fmaf(-2.f * ddn, nz, L.dz);
        t0 = ss.now();
        if (mtype < 0.5f) {
          // ---- lambertian: cosine sample about the normal (u0, u1) ----
          const float r2 = uniform_row(b2, 1);
          const float z = sqrtf(fmaxf(1.f - r2, 0.f));
          const float sq = sqrtf(r2);
          float cphi, sphi;
          cossin2pi(uniform_row(b2, 0), cphi, sphi);
          const float lx = cphi * sq, ly = sphi * sq;
          float ux, uy, uz, vx, vy, vz;
          onb(nx, ny, nz, ux, uy, uz, vx, vy, vz);
          ndx = fmaf(z, nx, fmaf(lx, ux, ly * vx));
          ndy = fmaf(z, ny, fmaf(lx, uy, ly * vy));
          ndz = fmaf(z, nz, fmaf(lx, uz, ly * vz));
          scatter_ok = z > 0.f;
          if ((kFeat & kFLights) && tb.L > 0) {
            // ---- one-sample MIS: the mixture of the cosine pdf and the
            // lights pdf (RayTracingWeekend.cpp:117-124, pdf.h:55-75);
            // salt 3: u0 picks the light, u1 u2 sample it, u3 the coin ----
            const uint32_t b3 = stream_base(p.seed, tile, it, 3u, lane);
            const float pickf = uniform_row(b3, 0) * (float)tb.L;
            const int li = (int)pickf;  // li <= pickf < li + 1
            float ldx = 0.f, ldy = 0.f, ldz = 0.f;
            ss.add(kSsLambertian, t0);
            t0 = ss.now();
            if (li < tb.L) {
              light_dir(tb.light + li * kLightLanes, tb.code[tb.R + li],
                        uniform_row(b3, 1), uniform_row(b3, 2), px, py, pz,
                        ldx, ldy, ldz);
            }
            ss.add(kSsLightDir, t0);
            t0 = ss.now();
            if (!(uniform_row(b3, 3) < 0.5f)) {
              ndx = ldx;
              ndy = ldy;
              ndz = ldz;
            }
            const float minv = rsqrtf(
                fmaxf(fmaf(ndz, ndz, fmaf(ndx, ndx, ndy * ndy)), kTiny30));
            const float mux = ndx * minv, muy = ndy * minv, muz = ndz * minv;
            const float cosi = fmaf(muz, nz, fmaf(mux, nx, muy * ny));
            const float cpdf = cosi <= 0.f ? 0.f : cosi * kInvPi;
            ss.add(kSsLambertian, t0);
            t0 = ss.now();
            const float acc = light_pdf(p, tb, px, py, pz, mux, muy, muz);
            ss.add(kSsLightPdf, t0);
            t0 = ss.now();
            const float pdf_val = fmaf(0.5f, cpdf, 0.5f * acc * tb.inv_L);
            scatter_ok = pdf_val > 0.f;
            // weight = albedo * scattering pdf / mixture pdf
            const float lam_w = scatter_ok ? cpdf / pdf_val : 0.f;
            wx *= lam_w;
            wy *= lam_w;
            wz *= lam_w;
          }
          ss.add(kSsLambertian, t0);
        } else if (mtype < 1.5f) {
          // ---- metal: reflect + fuzz * point in the unit ball (u2-u4) ----
          const float zb = 1.f - 2.f * uniform_row(b2, 2);
          const float rb = sqrtf(fmaxf(fmaf(-zb, zb, 1.f), 0.f));
          float cpb, spb;
          cossin2pi(uniform_row(b2, 3), cpb, spb);
          const float radb =
              expf(logf(fmaxf(uniform_row(b2, 4), 1e-30f)) * 0.333333343f);
          ndx = fmaf(fuzz, rb * cpb * radb, rfx);
          ndy = fmaf(fuzz, rb * spb * radb, rfy);
          ndz = fmaf(fuzz, zb * radb, rfz);
          ss.add(kSsMetal, t0);
        } else if (mtype < 2.5f) {
          // ---- dielectric, corrected exit cosine (material.h; u5) ----
          const bool inside = ddn > 0.f;
          const float sgn = inside ? -1.f : 1.f;
          const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
          const float nint = inside ? ridx : 1.f / fmaxf(ridx, 1e-6f);
          const float cos_exit2 =
              fmaf(-(ridx * ridx), fmaf(-ddn, ddn, 1.f), 1.f);
          const float cos_exit = sqrtf(fmaxf(cos_exit2, 0.f));
          const float cosine = inside ? cos_exit : -ddn;
          const float dt = fmaf(L.dz, onz, fmaf(L.dx, onx, L.dy * ony));
          const float disc_r = fmaf(-(nint * nint), fmaf(-dt, dt, 1.f), 1.f);
          const float sqr = sqrtf(fmaxf(disc_r, 0.f));
          float r0 = (1.f - ridx) / (1.f + ridx);
          r0 = r0 * r0;
          const float omc = 1.f - cosine;
          const float omc2 = omc * omc;
          const float schl = fmaf((1.f - r0) * omc2 * omc2, omc, r0);
          const float rp = disc_r > 0.f ? schl : 1.f;
          if (uniform_row(b2, 5) < rp) {
            ndx = rfx;
            ndy = rfy;
            ndz = rfz;
          } else {
            ndx = fmaf(nint, fmaf(-onx, dt, L.dx), -(onx * sqr));
            ndy = fmaf(nint, fmaf(-ony, dt, L.dy), -(ony * sqr));
            ndz = fmaf(nint, fmaf(-onz, dt, L.dz), -(onz * sqr));
          }
          wx = wy = wz = 1.f;
          ss.add(kSsDielectric, t0);
        } else {
          // ---- diffuse_light: one-sided emission (material.h:238-244)
          // when the ray runs along the normal; the path ends here ----
          if (ddn > 0.f) {
            L.rx += L.tpx * wx;
            L.ry += L.tpy * wy;
            L.rz += L.tpz * wz;
          }
          scatter_ok = false;
          ss.add(kSsEmission, t0);
        }
      }
      const float ninv =
          rsqrtf(fmaf(ndz, ndz, fmaf(ndx, ndx, ndy * ndy)) + 1e-30f);
      ndx *= ninv;
      ndy *= ninv;
      ndz *= ninv;
      // ---- throughput, Russian roulette (u6) ----
      L.tpx *= wx;
      L.tpy *= wy;
      L.tpz *= wz;
      const float tpmax = fmaxf(L.tpx, fmaxf(L.tpy, L.tpz));
      alive = scatter_ok && tpmax > 0.f;
      if (alive && p.rr_depth >= 0.f && L.depth >= p.rr_depth) {
        const float pc = fminf(fmaxf(tpmax, 0.05f), 0.95f);
        if (uniform_row(b2, 6) < pc) {
          const float inv_p = 1.f / pc;
          L.tpx *= inv_p;
          L.tpy *= inv_p;
          L.tpz *= inv_p;
        } else {
          alive = false;
        }
      }
    } else if (p.bg_gradient) {
      // ---- gradient sky on a miss (RayTracingWeekend.cpp:143-158) ----
      const float tbg = 0.5f * (L.dy + 1.f);
      L.rx += L.tpx * fmaf(tbg, 0.5f, 1.f - tbg);
      L.ry += L.tpy * fmaf(tbg, 0.7f, 1.f - tbg);
      L.rz += L.tpz;
    }
    L.depth += 1.f;
    alive = alive && L.depth < p.max_depth;
    if (!alive) {
      L.ax += L.rx;
      L.ay += L.ry;
      L.az += L.rz;
      L.done += 1.f;
    }
  }
  // ---- continue the path, or regenerate the slot's next sample ----
  if (alive) {
    L.ox = px;
    L.oy = py;
    L.oz = pz;
    L.dx = ndx;
    L.dy = ndy;
    L.dz = ndz;
  } else {
    const long long t0 = ss.now();
    gen_ray(p, cam, tile, lane, it, pxi, pxj, L);
    L.tpx = L.tpy = L.tpz = 1.f;
    L.rx = L.ry = L.rz = 0.f;
    L.depth = 0.f;
    ss.add(kSsRegen, t0);
  }
  return code;
}

// The sphere kernel (K1). Its launch bounds hold overdraw tiles to
// kDenseMaxT lanes (sweep.cuh).
template <int kAxes, bool kUniformTime>
__global__ void __launch_bounds__(kDenseMaxT)
    mega_kernel(Params p) {
  extern __shared__ float sm[];  // staged slots (sweep.cuh)
  stage_slots<kAxes, kUniformTime>(sm, p.sph, p.S);
  __syncthreads();

  uint32_t tile, lane;
  if (p.exact) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)p.n_tiles * p.T) return;
    tile = (uint32_t)(g / p.T);
    lane = (uint32_t)(g % p.T);
  } else {
    tile = blockIdx.x;
    lane = threadIdx.x;
  }
  const int T = p.T;
  const float* pix = p.pixf + (size_t)tile * 4 * T;
  const float pxi = pix[lane];
  const float pxj = pix[T + lane];
  const bool valid = pix[2 * T + lane] > 0.f;
  Cam cam;
#pragma unroll
  for (int k = 0; k < kCamLanes; ++k) cam.c[k] = __ldg(p.cam + k);

  Lane L;
  gen_ray(p, cam, tile, lane, 0xFFFFFFFFu, pxi, pxj, L);  // it = -1
  L.tpx = L.tpy = L.tpz = 1.f;
  L.rx = L.ry = L.rz = L.ax = L.ay = L.az = 0.f;
  L.segs = L.depth = L.iters = 0.f;
  L.done = valid ? 0.f : p.spp;

  float* out = p.out + (size_t)tile * (kOutRows + p.n_iters) * T + lane;
  if (p.exact) {
    int it = 0;
    for (; L.done < p.spp && it < p.n_iters; ++it) {
      const int code = bounce<kAxes, kUniformTime>(p, sm, cam, L, true, tile,
                                                   lane, it, pxi, pxj);
      L.iters += 1.f;
      out[(size_t)(kOutRows + it) * T] = (float)code;
    }
    for (; it < p.n_iters; ++it) out[(size_t)(kOutRows + it) * T] = -1.f;
  } else {
    uint32_t it = 0;
    int running = __syncthreads_or(valid);
    while (running) {
      bounce<kAxes, kUniformTime>(p, sm, cam, L, valid, tile, lane, it, pxi,
                                  pxj);
      L.iters += 1.f;
      ++it;
      // the block's check every p.unroll iterations (it is the block's: the
      // test is uniform); running is written every iteration, so it holds
      // no register across the bounce
      running = !checks(p, it) || __syncthreads_or(L.done < p.spp);
    }
  }
  out[0] = L.ax;
  out[(size_t)1 * T] = L.ay;
  out[(size_t)2 * T] = L.az;
  out[(size_t)3 * T] = L.segs;
  out[(size_t)4 * T] = L.iters;
  out[(size_t)5 * T] = L.done;
  out[(size_t)6 * T] = L.iters;  // one dense sweep block per iteration
  out[(size_t)7 * T] = 0.f;
}

// Words of shared memory the surfaces tables take (stage_surfaces), from a
// 16-byte aligned base; the host's twin is ops/megakernel.py
// shared_bytes.
__host__ __device__ constexpr int surface_words(int R, int L, int V,
                                                int n_img, bool tex) {
  return 12 * R + (tex ? 4 * kNoiseSize : 0) + kCamLanes +
         R * (tex ? kRectTexLanes : kRectLanes) + L * kLightLanes +
         V * (tex ? kMedTexLanes : kMedLanes) + R + L + V +
         (tex ? 2 * n_img + kNoiseSize : 0);
}

// Copy a surfaces launch's tables to shared memory from `base` (16-byte
// aligned): the rect runs and their group headers (Tables::runs, grp),
// with kTex the Perlin gradients as float4, the camera vector, the rect,
// light and medium rows (their first rect_lanes / kLightLanes / med_lanes
// lanes), the R + L + V static codes and, with kTex, the image sizes and
// the Perlin permutation. The runs' order comes from the host, after the
// image sizes in `codes` (ops/megakernel.py rect_runs): G, the row of
// each run position, then G headers (the group's first row | rotated <<
// 24 | translated << 25, its rows along axis 0, 1 and 2). The caller
// synchronises the block before reading.
template <bool kTex>
__device__ __forceinline__ void stage_surfaces(float* base, const Surfaces& q,
                                               const Texels& x,
                                               const float* cam_src,
                                               Tables& tb, TexTables& tx,
                                               const float*& cam) {
  constexpr int kRL = rect_lanes<kTex>(), kML = med_lanes<kTex>();
  float4* runs = reinterpret_cast<float4*>(base);
  int4* grp = reinterpret_cast<int4*>(runs + 2 * q.R);
  float4* rv = reinterpret_cast<float4*>(grp + q.R);
  float* cam_sm = reinterpret_cast<float*>(rv + (kTex ? kNoiseSize : 0));
  float* rect = cam_sm + kCamLanes;
  float* light = rect + q.R * kRL;
  float* med = light + q.L * kLightLanes;
  int* codes = reinterpret_cast<int*>(med + q.V * kML);
  const int n_codes = q.R + q.L + q.V + (kTex ? 2 * x.n_img : 0);
  const int* order = q.codes + n_codes + 1;
  const int G = q.R ? __ldg(q.codes + n_codes) : 0;
  for (int i = threadIdx.x; i < q.R; i += blockDim.x) {
    const int r = __ldg(order + i);
    const float* src = q.rect + (size_t)r * kTableLanes;
    runs[2 * i] = make_float4(__ldg(src + RT_K), __ldg(src + RT_A0),
                              __ldg(src + RT_A1), __ldg(src + RT_B0));
    runs[2 * i + 1] =
        make_float4(__ldg(src + RT_B1), __int_as_float(r),
                    kTex ? __ldg(src + RT_IDA) : 0.f,
                    kTex ? __ldg(src + RT_IDB) : 0.f);
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const int* h = order + q.R + 4 * g;
    const int first = __ldg(h);  // the group's first row, then its flags
    grp[g] = make_int4(((first & 0xFFFFFF) * kRL + RT_COS) |
                           (first & ~0xFFFFFF),
                       __ldg(h + 1), __ldg(h + 2), __ldg(h + 3));
  }
  for (int i = threadIdx.x; i < kCamLanes; i += blockDim.x) {
    cam_sm[i] = __ldg(cam_src + i);
  }
  for (int i = threadIdx.x; i < q.R * kRL; i += blockDim.x) {
    rect[i] = __ldg(q.rect + (i / kRL) * kTableLanes + i % kRL);
  }
  for (int i = threadIdx.x; i < q.L * kLightLanes; i += blockDim.x) {
    light[i] =
        __ldg(q.light + (i / kLightLanes) * kTableLanes + i % kLightLanes);
  }
  for (int i = threadIdx.x; i < q.V * kML; i += blockDim.x) {
    med[i] = __ldg(q.med + (i / kML) * kTableLanes + i % kML);
  }
  for (int i = threadIdx.x; i < n_codes; i += blockDim.x) {
    codes[i] = __ldg(q.codes + i);
  }
  tb = Tables{rect, light, med, codes, runs, grp, q.R, q.L, q.V, G,
              q.has_spheres, q.inv_L};
  cam = cam_sm;
  tx = TexTables{};
  if (kTex) {
    int* perm = codes + n_codes;
    for (int i = threadIdx.x; i < kNoiseSize; i += blockDim.x) {
      perm[i] = __ldg(x.perm + i);
      rv[i] = make_float4(__ldg(x.ranvec + 3 * i), __ldg(x.ranvec + 3 * i + 1),
                          __ldg(x.ranvec + 3 * i + 2), 0.f);
    }
    tx = TexTables{perm, rv, codes + q.R + q.L + q.V, x.images, x.img_h,
                   x.img_w};
  }
}

// The kernel of scenes with rects, lights or media, or with textures: the
// features of kFeat compiled, the others not (kF*). Its lane loop is
// mega_kernel's with bounce_surfaces; the two stay separate functions so
// that the sphere-only code does not depend on the surfaces path. The
// camera vector sits in shared memory, and the sweep visits the slots up
// to the last live one. Its launch bounds hold overdraw tiles to
// kDenseMaxT lanes and, asking for one such block an SM, leave a thread
// the registers it needs (72-121 registers: two or three 256-lane blocks
// an SM; with the bound alone ptxas held the parent's static form at 64
// and spilled 148 B, and two 512-lane blocks asked for made the small
// forms spill, PERF.md §6).
template <int kAxes, bool kUniformTime, int kFeat>
__global__ void __launch_bounds__(kDenseMaxT, 1)
    mega_kernel_surfaces(Params p, Surfaces q, Texels x) {
#ifdef RTW_SPLIT
  const unsigned long long t_block = global_ns();
#endif
  constexpr bool kTex = (kFeat & kFTex) != 0;
  // the staged slots (sweep.cuh), then the surfaces tables
  extern __shared__ float sm[];
  __shared__ int n_live;  // 1 + the last slot with a live sphere
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  stage_slots<kAxes, kUniformTime>(sm, p.sph, p.S);
  for (int s = threadIdx.x; s < p.S; s += blockDim.x) {
    // padding slots hold nr2 = +1 (a live sphere's -r^2 <= 0)
    if (__ldg(p.sph + (size_t)L_NR2 * p.S + s) != 1.f) {
      atomicMax(&n_live, s + 1);
    }
  }
  Tables tb;
  TexTables tx;
  const float* cam_sm;
  stage_surfaces<kTex>(sm + slot_words(kAxes, kUniformTime) * p.S, q, x,
                       p.cam, tb, tx, cam_sm);
  __syncthreads();
  const int live = n_live;

  uint32_t tile, lane;
  if (p.exact) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)p.n_tiles * p.T) return;
    tile = (uint32_t)(g / p.T);
    lane = (uint32_t)(g % p.T);
  } else {
    // the tile this block renders: lane 0 of the layout's pad row of entry
    // blockIdx.x holds 1 + the tile (ops/megakernel.py _longest_first), or
    // 0 for tile blockIdx.x (make_plan's layout); any order renders the
    // same tiles bit for bit
    const float order = p.pixf[((size_t)blockIdx.x * 4 + 3) * p.T];
    tile = order >= 1.f && order <= (float)p.n_tiles ? (uint32_t)order - 1u
                                                      : blockIdx.x;
    lane = threadIdx.x;
  }
  const int T = p.T;
  const float* pix = p.pixf + (size_t)tile * 4 * T;
  const float pxi = pix[lane];
  const float pxj = pix[T + lane];
  const bool valid = pix[2 * T + lane] > 0.f;
  const CamSm cam{cam_sm};

  Lane L;
  gen_ray(p, cam, tile, lane, 0xFFFFFFFFu, pxi, pxj, L);  // it = -1
  L.tpx = L.tpy = L.tpz = 1.f;
  L.rx = L.ry = L.rz = L.ax = L.ay = L.az = 0.f;
  L.segs = L.depth = L.iters = 0.f;
  L.done = valid ? 0.f : p.spp;
#ifdef RTW_SPLIT
  __shared__ unsigned split_acc[kSurfParts * kDenseMaxT];
  const SurfSplit ss{split_acc + threadIdx.x};
  for (int i = 0; i < kSurfParts; ++i) ss.acc[i * kDenseMaxT] = 0u;
#else
  const NoSplit ss;
#endif
  const long long t_start = ss.now();

  float* out = p.out + (size_t)tile * (kOutRows + p.n_iters) * T + lane;
  if (p.exact) {
    int it = 0;
    for (; L.done < p.spp && it < p.n_iters; ++it) {
      const int code = bounce_surfaces<kAxes, kUniformTime, kFeat>(
          p, sm, tb, tx, cam, L, true, tile, lane, it, pxi, pxj, 0, 0.f, ss,
          live);
      L.iters += 1.f;
      out[(size_t)(kOutRows + it) * T] = (float)code;
    }
    for (; it < p.n_iters; ++it) out[(size_t)(kOutRows + it) * T] = -1.f;
  } else {
    uint32_t it = 0;
    int running = __syncthreads_or(valid);
    while (running) {
      bounce_surfaces<kAxes, kUniformTime, kFeat>(
          p, sm, tb, tx, cam, L, valid, tile, lane, it, pxi, pxj, 0, 0.f,
          ss, live);
      L.iters += 1.f;
      ++it;
      running = 1;  // written every iteration, as in mega_kernel
      if (checks(p, it)) {  // it is the block's: the branch is uniform
        const long long t0 = ss.now();
        running = __syncthreads_or(L.done < p.spp);
        ss.add(kSsBarrier, t0);
      }
    }
  }
  ss.add(kSsTotal, t_start);
#ifdef RTW_SPLIT
  if (!p.exact && threadIdx.x == 0 && g_block_times != nullptr) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    unsigned long long* rec = g_block_times + 3 * (size_t)blockIdx.x;
    rec[0] = t_block;
    rec[1] = global_ns();
    rec[2] = smid;
  }
  ss.flush();
#endif
  out[0] = L.ax;
  out[(size_t)1 * T] = L.ay;
  out[(size_t)2 * T] = L.az;
  out[(size_t)3 * T] = L.segs;
  out[(size_t)4 * T] = L.iters;
  out[(size_t)5 * T] = L.done;
  out[(size_t)6 * T] = L.iters;
  out[(size_t)7 * T] = 0.f;
}

// ---------------------------------------------------------------------------
// Cluster culling (K5): the sphere kernel for tables of C > 1 clusters
// ---------------------------------------------------------------------------

// The cluster table of a culled launch.
struct Clusters {
  const float* tab;  // (C + Cg, 128): AABB min xyz, max xyz in lanes 0-5
  int C, SB;         // clusters, slots per cluster
  int dord;          // near-to-far buckets of the visit order; 0: ascending id
  int sg, Cg;        // clusters a super-group (0: none), the groups' union
                     // boxes (rows C .. C + Cg - 1: groups of sg clusters)
  int bv;            // batched votes: each warp votes every cluster against
                     // t_min, before its sweeps, with no running best
};

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBoxLanes = 6;
constexpr float kShrink = 0x1.fffff8p-1f;  // float32(1 - 2.4e-7)
constexpr float kSurvCut = 0.5f * kBig;    // past it a cluster cannot win

// A visit that fewer than kBcast lanes need sweeps the cluster once for
// each needing lane, 32 slots at a time (sweep_compact); from kBcast
// needing lanes on, the warp runs the broadcast loop (sweep_cluster). At
// SB = 128 the broadcast loop costs ~27 instructions a slot for the warp,
// ~3400 a visit, the compacted sweep ~130 a needing lane and its latency.
// Chosen on the H100 (PERF.md: flat between 16 and 24).
constexpr int kBcast = 20;
// The culled kernels' blocks hold at most kCulledMaxT threads (overdraw
// T <= 512; exact mode's are kExactBlock): their launch bounds cap a
// thread at 128 registers, so that two 256-lane blocks fit an SM.
constexpr int kCulledMaxT = 512;

// Warp-cycle split of the culled kernels, built only with -DRTW_SPLIT
// (tools/culled_ab.py, chip_smoke.py): clock64 sums of lane 0 of each warp
// over its lane loop (total), the key pass and buckets, the visit loop
// (votes and sweeps), the broadcast and the compacted sweeps; then counts
// of candidate visits, broadcast and compacted sweeps. rtw_split_read
// returns the sums and clears them.
enum { kSpTotal, kSpKeys, kSpVisits, kSpBcast, kSpCompact, kSpNCand,
       kSpNBcast, kSpNCompact, kSplitParts };
#ifdef RTW_SPLIT
__device__ unsigned long long g_split[kSplitParts];
#endif
struct Split {
#ifdef RTW_SPLIT
  long long v[kSplitParts] = {};
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void add(int i, long long t0) {
    v[i] += clock64() - t0;
  }
  __device__ __forceinline__ void count(int i) { v[i] += 1; }
  __device__ __forceinline__ void flush() const {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < kSplitParts; ++i) {
        atomicAdd(&g_split[i], (unsigned long long)v[i]);
      }
    }
  }
#else
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void flush() const {}
#endif
};

// Slab entry (>= t_min) and exit of the lane's ray against box b (min xyz,
// max xyz), NaN-propagating as the JAX kernel's jnp.minimum / maximum.
__device__ __forceinline__ void slab(const float* b, const Lane& L, float idx,
                                     float idy, float idz, float tmin,
                                     float& tlo, float& thi) {
  const float tx0 = (b[0] - L.ox) * idx, tx1 = (b[3] - L.ox) * idx;
  const float ty0 = (b[1] - L.oy) * idy, ty1 = (b[4] - L.oy) * idy;
  const float tz0 = (b[2] - L.oz) * idz, tz1 = (b[5] - L.oz) * idz;
  tlo = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                max_nan(min_nan(tz0, tz1), tmin));
  thi = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                max_nan(tz0, tz1));
}

// n rounded up to a multiple of 4 (a float4 boundary, in words)
__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// Words of shared memory the culled kernels' cluster area takes, rounded up
// to a float4 boundary: the C + Cg boxes, then with near-to-far order or
// batched votes C key / bucket / vote slots a warp (ops/megakernel.py
// shared_bytes).
__host__ __device__ inline int cluster_words(const Clusters& k, int warps) {
  return align4(kBoxLanes * (k.C + k.Cg) + (k.dord || k.bv ? k.C * warps : 0));
}

// Slot quads a slot: (cx, cy, cz, nr2), with motion (dcx, dcy, dcz, 0),
// without a uniform shutter (t0, 1/dt, 0, 0).
template <bool kMoving, bool kUniformTime>
__host__ __device__ constexpr int slot_quads() {
  return kMoving ? (kUniformTime ? 2 : 3) : 1;
}

// Words of shared memory ahead of the culled kernels' boxes: each warp's
// two buffers of a cluster's SB centre quads. A moving slot reads its
// motion quads from device memory in any case, and staging its centre
// quad as well measured slower than reading it through L1 (PERF.md), so
// the moving instantiations stage nothing.
template <bool kMoving>
__host__ __device__ constexpr size_t stage_words(int SB, int warps) {
  return kMoving ? 0 : (size_t)warps * 2 * SB * 4;
}

// t of the ray (o, d, time) against slot j of a cluster: the arithmetic of
// `sweep` (the sign-flipped half-b quadratic, its root slot_root, near
// root else far root past tmin), kBig on a miss (+inf where slot_root
// flushes a subnormal disc, a miss too); never NaN. `qg` is the cluster's
// quads in device memory (Q a slot), `qa` its centre quads staged in
// shared memory one a slot (static slots only: stage_words).
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ float slot_t(const float4* qa, const float4* qg,
                                        int j, float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float time, float frac_u,
                                        float tmin) {
  constexpr int Q = slot_quads<kMoving, kUniformTime>();
  const float4 a = kMoving ? __ldg(qg + j * Q) : qa[j];
  float cx = a.x, cy = a.y, cz = a.z;
  if (kMoving) {
    const float4 m = __ldg(qg + j * Q + 1);
    float fr = frac_u;
    if (!kUniformTime) {
      const float4 tq = __ldg(qg + j * Q + 2);
      fr = (time - tq.x) * tq.y;
    }
    cx = fmaf(fr, m.x, cx);  // exact on static axes (dc = 0)
    cy = fmaf(fr, m.y, cy);
    cz = fmaf(fr, m.z, cz);
  }
  const float cox = cx - ox, coy = cy - oy, coz = cz - oz;
  const float nb = fmaf(coz, dz, fmaf(cox, dx, coy * dy));
  const float cc = fmaf(cox, cox, fmaf(coy, coy, fmaf(coz, coz, a.w)));
  const float disc = fmaf(nb, nb, -cc);
  const float sq = slot_root(disc);
  const float tn = nb - sq, tf = nb + sq;
  return tn > tmin ? tn : (tf > tmin ? tf : kBig);
}

// The broadcast sweep: closest hit over the SB slots of one cluster (first
// slot lo; qa, qg as in slot_t) for every lane of the warp, each slot one
// broadcast read for all 32 lanes. A lane that needs the cluster merges
// into (best, bidx) strictly (the first visitor keeps a tie); the others
// sweep against 0, below every t, and keep theirs, so the loop stays
// warp-uniform and carries no extra predicate.
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ void sweep_cluster(const float4* qa,
                                              const float4* qg, int lo,
                                              int SB, bool need,
                                              const Lane& L, float frac_u,
                                              float tmin, float& best,
                                              int& bidx) {
  float cb = need ? best : 0.f;
  int ci = bidx;
#pragma unroll 4
  for (int j = 0; j < SB; ++j) {
    const float t = slot_t<kMoving, kUniformTime>(
        qa, qg, j, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, L.time, frac_u, tmin);
    if (t < cb) {
      cb = t;
      ci = lo + j;
    }
  }
  if (need) {
    best = cb;
    bidx = ci;
  }
}

// The compacted sweep: for each needing lane r of `need`, in ascending lane
// order, the warp takes lane r's ray, lane l tests slots l, l + 32, ... of
// the cluster, the warp reduces (t, slot) to its lexicographic minimum (the
// first slot with the least t, as the sequential strict loop finds it) by
// two warp minimums, and lane r merges it strictly. 7 shuffles, SB / 32
// slots and two REDUX a needing lane, in place of the broadcast loop's SB
// slots.
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ void sweep_compact(const float4* qa,
                                              const float4* qg, int lo,
                                              int SB, unsigned need,
                                              const Lane& L, float frac_u,
                                              float tmin, float& best,
                                              int& bidx) {
  const int wl = threadIdx.x & 31;
  do {
    const int r = __ffs(need) - 1;
    need &= need - 1;
    const float ox = __shfl_sync(kFull, L.ox, r);
    const float oy = __shfl_sync(kFull, L.oy, r);
    const float oz = __shfl_sync(kFull, L.oz, r);
    const float dx = __shfl_sync(kFull, L.dx, r);
    const float dy = __shfl_sync(kFull, L.dy, r);
    const float dz = __shfl_sync(kFull, L.dz, r);
    const float tm = kMoving && !kUniformTime ? __shfl_sync(kFull, L.time, r)
                                              : 0.f;
    const float fu = kUniformTime ? __shfl_sync(kFull, frac_u, r) : 0.f;
    float tb = kBig;
    int jb = SB;
#pragma unroll 4
    for (int j = wl; j < SB; j += 32) {
      const float t = slot_t<kMoving, kUniformTime>(qa, qg, j, ox, oy, oz, dx,
                                                    dy, dz, tm, fu, tmin);
      if (t < tb) {
        tb = t;
        jb = j;
      }
    }
    // t > t_min > 0, kBig or +inf: its bits order as unsigned ints
    const unsigned tw = __reduce_min_sync(kFull, __float_as_uint(tb));
    const unsigned jw = __reduce_min_sync(
        kFull, __float_as_uint(tb) == tw ? (unsigned)jb : (unsigned)SB);
    if (wl == r && __uint_as_float(tw) < best) {
      best = __uint_as_float(tw);
      bidx = lo + (int)jw;
    }
  } while (need);
}

// Asynchronous copy of a cluster's n centre quads (Q quads a slot in device
// memory, one a slot in shared memory) by the warp's lanes, one commit
// group a lane; stage_wait<N> waits until N groups are in flight and makes
// the warp's copies visible to the warp.
template <int Q>
__device__ __forceinline__ void stage_quads(float4* dst, const float4* src,
                                            int n) {
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + (size_t)i * Q));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
  __syncwarp();
}

// The culled closest hit of a warp's lanes; every lane of the warp calls
// it (an idle lane with active = false). A lane needs a cluster when it is
// active and its ray enters the cluster's box before its running best (the
// entry shrunk by 2.4e-7 so rounding never drops a tie); the warp visits
// the cluster when one lane needs it, and sweeps it for the needing lanes
// only: by broadcast from kBcast needing lanes on, else compacted. Visit
// order: ascending cluster id; or, with q.dord buckets, near to far: each
// cluster's key is the warp's smallest slab entry over its active lanes
// (BIG where none enters), keys past kSurvCut are dropped, the rest are
// bucketed linearly between the smallest key and the largest surviving
// one, and buckets are visited in order, clusters in ascending id within
// one. `wb` holds the warp's C keys, then buckets; `stage` the warp's two
// buffers of centre quads, the next admitted candidate's copied in while
// the current one is re-voted and swept. Each visited cluster adds
// `inc` to `blocks`, and 1 to `needed` on each lane that needed it.
// Two modes of the ascending order (the JAX kernel's cfg.batch_votes and
// cfg.sg): with q.bv the warp first votes every cluster against t_min
// alone and keeps the ballots in `wb`; a lane then needs a cluster when
// its ray enters the box at all, with no running best. With q.sg, ahead of
// each group of sg clusters the warp votes the group's union box (box row
// C + g) as a cluster's, against the running best after every earlier
// cluster's sweep, and visits none of the group when no lane needs it (no
// block counted). Both are compiled only into the kModes instantiations
// (the _modes kernels), so that the kernels of the default plan carry none
// of their code or registers. Returns the winner slot (S on a miss) and its
// t in best.
template <bool kMoving, bool kUniformTime, bool kModes>
__device__ __forceinline__ int sweep_culled(
    const Params& p, const Clusters& q, const float* box, int* wb,
    float4* stage, const Lane& L, bool active, float inc, float& best,
    float& blocks, float& needed, Split& sp) {
  constexpr int Q = slot_quads<kMoving, kUniformTime>();
  const float idx = 1.f / L.dx, idy = 1.f / L.dy, idz = 1.f / L.dz;
  const float frac_u = kUniformTime ? (L.time - p.ut_t0) * p.ut_idt : 0.f;
  const float tmin = p.t_min;
  const int SB = q.SB;
  const float4* quads = reinterpret_cast<const float4*>(p.sph);
  int bidx = p.S;
  best = kBig;
  // the lane needs cluster c: its ray enters the box before its best
  auto needs = [&](int c) {
    float tlo, thi;
    slab(box + kBoxLanes * c, L, idx, idy, idz, tmin, tlo, thi);
    return active && tlo <= thi && tlo * kShrink < best;
  };
  auto sweep_one = [&](int c, const float4* qa) {
    bool nd;
    unsigned need;
    if (kModes && q.bv) {  // the batched vote's ballot
      need = (unsigned)wb[c];
      nd = (need >> (threadIdx.x & 31)) & 1u;
    } else {
      nd = needs(c);
      need = __ballot_sync(kFull, nd);
    }
    if (need == 0) return;
    const float4* qg = quads + (size_t)c * SB * Q;
    const long long t0 = sp.now();
    if (__popc(need) >= kBcast) {
      sweep_cluster<kMoving, kUniformTime>(qa, qg, c * SB, SB, nd, L, frac_u,
                                           tmin, best, bidx);
      sp.add(kSpBcast, t0);
      sp.count(kSpNBcast);
    } else {
      sweep_compact<kMoving, kUniformTime>(qa, qg, c * SB, SB, need, L,
                                           frac_u, tmin, best, bidx);
      sp.add(kSpCompact, t0);
      sp.count(kSpNCompact);
    }
    blocks += inc;
    needed += nd ? 1.f : 0.f;
  };
  // A static candidate is copied into buffer n & 1 while candidate n - 1
  // is re-voted and swept; a copy the re-vote rejects is dropped. In
  // ascending order a candidate is first voted against the lanes' running
  // best (best only falls, so what this vote rejects the re-vote would
  // too), else every cluster would be copied every bounce; in bucket order
  // its key already says one lane's ray enters its box, and that vote
  // measured slower (PERF.md). A moving candidate is voted and swept at
  // once, through L1.
  int pend = -1, n = 0;
  auto visit = [&](int c) {
    sp.count(kSpNCand);
    if (kMoving) {
      sweep_one(c, nullptr);
      return;
    }
    if (q.dord == 0 &&
        (kModes && q.bv ? wb[c] == 0 : !__any_sync(kFull, needs(c)))) {
      return;
    }
    stage_quads<Q>(stage + (n & 1) * SB, quads + (size_t)c * SB * Q, SB);
    if (pend >= 0) {
      stage_wait<1>();
      sweep_one(pend, stage + ((n - 1) & 1) * SB);
      __syncwarp();  // the next copy overwrites this buffer
    }
    pend = c;
    ++n;
  };
  auto finish = [&]() {
    if (!kMoving && pend >= 0) {
      stage_wait<0>();
      sweep_one(pend, stage + ((n - 1) & 1) * SB);
      __syncwarp();
      pend = -1;
    }
  };
  if (q.dord == 0) {
    const long long t0 = sp.now();
    if (kModes && q.bv) {
      for (int c = 0; c < q.C; ++c) {
        float tlo, thi;
        slab(box + kBoxLanes * c, L, idx, idy, idz, tmin, tlo, thi);
        const unsigned m = __ballot_sync(kFull, active && tlo <= thi);
        if ((threadIdx.x & 31) == 0) wb[c] = (int)m;
      }
      __syncwarp();
    }
    if (kModes && q.sg) {
      for (int g = 0; g < q.Cg; ++g) {
        finish();  // the union vote reads the best after every sweep so far
        float tlo, thi;
        slab(box + kBoxLanes * (q.C + g), L, idx, idy, idz, tmin, tlo, thi);
        if (__any_sync(kFull, active && tlo <= thi && tlo * kShrink < best)) {
          const int end = min(q.C, (g + 1) * q.sg);
          for (int c = g * q.sg; c < end; ++c) visit(c);
        }
      }
    } else {
      for (int c = 0; c < q.C; ++c) visit(c);
    }
    finish();
    if (kModes && q.bv) __syncwarp();  // the next bounce rewrites wb
    sp.add(kSpVisits, t0);
    return bidx;
  }
  long long t0 = sp.now();
  const int wl = threadIdx.x & 31;
  float kmin = kBig, kmax = -kBig;
  for (int c = 0; c < q.C; ++c) {
    float tlo, thi;
    slab(box + kBoxLanes * c, L, idx, idy, idz, tmin, tlo, thi);
    // tlo >= t_min > 0 and kBig are positive: their bits order as uints
    const float key = __uint_as_float(__reduce_min_sync(
        kFull, __float_as_uint(active && tlo <= thi ? tlo : kBig)));
    if (wl == 0) wb[c] = __float_as_int(key);
    kmin = fminf(kmin, key);
    if (key < kSurvCut) kmax = fmaxf(kmax, key);
  }
  if (kmax == -kBig) {  // no active lane enters any box
    sp.add(kSpKeys, t0);
    return bidx;
  }
  const float scale = (float)q.dord / fmaxf(kmax - kmin, kTiny20);
  __syncwarp();
  for (int c = wl; c < q.C; c += 32) {
    const float key = __int_as_float(wb[c]);
    wb[c] = key < kSurvCut
                ? (int)fminf(fmaxf((key - kmin) * scale, 0.f),
                             (float)(q.dord - 1))
                : q.dord;
  }
  __syncwarp();
  sp.add(kSpKeys, t0);
  t0 = sp.now();
  for (int b = 0; b < q.dord; ++b) {
    for (int c0 = 0; c0 < q.C; c0 += 32) {
      unsigned bits =
          __ballot_sync(kFull, c0 + wl < q.C && wb[c0 + wl] == b);
      while (bits) {
        visit(c0 + __ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  }
  finish();
  __syncwarp();  // the next bounce rewrites wb
  sp.add(kSpVisits, t0);
  return bidx;
}

// The sphere kernel of culled plans (K5): mega_kernel's lanes with
// sweep_culled as their closest hit. The votes need every lane of a warp
// at one point: in overdraw mode a whole block loops until its slowest lane
// has spp; in exact mode a warp loops until its slowest lane has spp, the
// others idle, so T % 32 == 0 keeps a warp in one tile. kModes: the plan
// modes (super-groups, batched votes, the unroll) compiled in.
template <bool kMoving, bool kUniformTime, bool kModes>
__device__ __forceinline__ void culled_lanes(const Params& p,
                                             const Clusters& q) {
  constexpr int kAx = kMoving ? kAxesAll : kAxesStatic;  // bounce's normal
  // (stage_words), (C + Cg, 6) cluster and union boxes, then with q.dord
  // or q.bv C key / bucket / vote slots per warp (cluster_words)
  extern __shared__ float sm[];
  const int warps = blockDim.x >> 5, wid = threadIdx.x >> 5;
  float4* stage = reinterpret_cast<float4*>(sm) +
                  stage_words<kMoving>(q.SB, 1) / 4 * wid;
  float* box = sm + stage_words<kMoving>(q.SB, warps);
  const int n_box = kModes ? q.C + q.Cg : q.C;
  for (int i = threadIdx.x; i < kBoxLanes * n_box; i += blockDim.x) {
    box[i] = __ldg(q.tab + (i / kBoxLanes) * kTableLanes + i % kBoxLanes);
  }
  int* wb = reinterpret_cast<int*>(box + kBoxLanes * n_box) + wid * q.C;
  __syncthreads();

  uint32_t tile, lane;
  if (p.exact) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)p.n_tiles * p.T) return;  // whole warps
    tile = (uint32_t)(g / p.T);
    lane = (uint32_t)(g % p.T);
  } else {
    tile = blockIdx.x;
    lane = threadIdx.x;
  }
  const int T = p.T;
  const float* pix = p.pixf + (size_t)tile * 4 * T;
  const float pxi = pix[lane];
  const float pxj = pix[T + lane];
  const bool valid = pix[2 * T + lane] > 0.f;
  Cam cam;
#pragma unroll
  for (int k = 0; k < kCamLanes; ++k) cam.c[k] = __ldg(p.cam + k);

  Lane L;
  gen_ray(p, cam, tile, lane, 0xFFFFFFFFu, pxi, pxj, L);  // it = -1
  L.tpx = L.tpy = L.tpz = 1.f;
  L.rx = L.ry = L.rz = L.ax = L.ay = L.az = 0.f;
  L.segs = L.depth = L.iters = 0.f;
  L.done = valid ? 0.f : p.spp;
  float blocks = 0.f, needed = 0.f;
  Split sp;
  const long long t_start = sp.now();

  float* out = p.out + (size_t)tile * (kOutRows + p.n_iters) * T + lane;
  if (p.exact) {
    // a lane's iterations are 0 .. iters - 1; it counts a block only then
    int it = 0;
    for (; it < p.n_iters && __any_sync(kFull, L.done < p.spp); ++it) {
      const bool active = L.done < p.spp;
      float best;
      const int bidx = sweep_culled<kMoving, kUniformTime, kModes>(
          p, q, box, wb, stage, L, active, active ? 1.f : 0.f, best,
          blocks, needed, sp);
      const int code = bounce<kAx, kUniformTime, true>(
          p, nullptr, cam, L, active, tile, lane, it, pxi, pxj, bidx, best);
      if (active) {
        L.iters += 1.f;
        out[(size_t)(kOutRows + it) * T] = (float)code;
      }
    }
    for (it = (int)L.iters; it < p.n_iters; ++it) {
      out[(size_t)(kOutRows + it) * T] = -1.f;
    }
  } else {
    uint32_t it = 0;
    int running = __syncthreads_or(valid);
    while (running) {
      float best;
      const int bidx = sweep_culled<kMoving, kUniformTime, kModes>(
          p, q, box, wb, stage, L, valid, 1.f, best, blocks, needed, sp);
      bounce<kAx, kUniformTime, true>(p, nullptr, cam, L, valid, tile, lane,
                                      it, pxi, pxj, bidx, best);
      L.iters += 1.f;
      ++it;
      // every p.unroll iterations (it is the block's: the test is uniform)
      running = (kModes && !checks(p, it)) || __syncthreads_or(L.done < p.spp);
    }
  }
  out[0] = L.ax;
  out[(size_t)1 * T] = L.ay;
  out[(size_t)2 * T] = L.az;
  out[(size_t)3 * T] = L.segs;
  out[(size_t)4 * T] = L.iters;
  out[(size_t)5 * T] = L.done;
  out[(size_t)6 * T] = blocks;
  out[(size_t)7 * T] = needed;
  sp.add(kSpTotal, t_start);
  sp.flush();
}

template <bool kMoving, bool kUniformTime>
__global__ void __launch_bounds__(kCulledMaxT, 1)
    mega_kernel_culled(Params p, Clusters q) {
  culled_lanes<kMoving, kUniformTime, false>(p, q);
}

template <bool kMoving, bool kUniformTime>
__global__ void __launch_bounds__(kCulledMaxT, 1)
    mega_kernel_culled_modes(Params p, Clusters q) {
  culled_lanes<kMoving, kUniformTime, true>(p, q);
}

// The culled kernel of scenes with rects, lights, media or textures (K5s):
// mega_kernel_culled's lanes and warp votes, with bounce_surfaces after the
// culled sphere sweep (the rects and media merge after it, strictly, as
// after the dense sweep). Every lane of a warp calls sweep_culled; the rest
// of the bounce, the tape rows, L.iters and the medium's stream run on
// active lanes only. kModes as in culled_lanes.
template <bool kMoving, bool kUniformTime, bool kTex, bool kModes>
__device__ __forceinline__ void culled_surface_lanes(const Params& p,
                                                     const Clusters& k,
                                                     const Surfaces& q,
                                                     const Texels& x) {
  constexpr int kAx = kMoving ? kAxesAll : kAxesStatic;  // bounce's normal
  constexpr int kFeat = kTex ? kFAll : kFSurf;  // every feature compiled
  // (stage_words), (C + Cg, 6) cluster and union boxes, with k.dord or
  // k.bv C key / bucket / vote slots per warp (cluster_words), then the
  // surfaces tables (stage_surfaces)
  extern __shared__ float sm[];
  const int warps = blockDim.x >> 5, wid = threadIdx.x >> 5;
  float4* stage = reinterpret_cast<float4*>(sm) +
                  stage_words<kMoving>(k.SB, 1) / 4 * wid;
  float* box = sm + stage_words<kMoving>(k.SB, warps);
  const int n_box = kModes ? k.C + k.Cg : k.C;
  for (int i = threadIdx.x; i < kBoxLanes * n_box; i += blockDim.x) {
    box[i] = __ldg(k.tab + (i / kBoxLanes) * kTableLanes + i % kBoxLanes);
  }
  int* wb = reinterpret_cast<int*>(box + kBoxLanes * n_box) + wid * k.C;
  Tables tb;
  TexTables tx;
  const float* cam_sm;
  stage_surfaces<kTex>(
      box + (kModes ? cluster_words(k, warps)
                    : align4(k.C * (kBoxLanes + (k.dord ? warps : 0)))),
      q, x, p.cam, tb, tx, cam_sm);
  __syncthreads();

  uint32_t tile, lane;
  if (p.exact) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (long long)p.n_tiles * p.T) return;  // whole warps
    tile = (uint32_t)(g / p.T);
    lane = (uint32_t)(g % p.T);
  } else {
    tile = blockIdx.x;
    lane = threadIdx.x;
  }
  const int T = p.T;
  const float* pix = p.pixf + (size_t)tile * 4 * T;
  const float pxi = pix[lane];
  const float pxj = pix[T + lane];
  const bool valid = pix[2 * T + lane] > 0.f;
  const CamSm cam{cam_sm};

  Lane L;
  gen_ray(p, cam, tile, lane, 0xFFFFFFFFu, pxi, pxj, L);  // it = -1
  L.tpx = L.tpy = L.tpz = 1.f;
  L.rx = L.ry = L.rz = L.ax = L.ay = L.az = 0.f;
  L.segs = L.depth = L.iters = 0.f;
  L.done = valid ? 0.f : p.spp;
  float blocks = 0.f, needed = 0.f;
  Split sp;
  const long long t_start = sp.now();

  float* out = p.out + (size_t)tile * (kOutRows + p.n_iters) * T + lane;
  if (p.exact) {
    // a lane's iterations are 0 .. iters - 1; it counts a block only then
    int it = 0;
    for (; it < p.n_iters && __any_sync(kFull, L.done < p.spp); ++it) {
      const bool active = L.done < p.spp;
      float best;
      const int bidx = sweep_culled<kMoving, kUniformTime, kModes>(
          p, k, box, wb, stage, L, active, active ? 1.f : 0.f, best,
          blocks, needed, sp);
      const int code = bounce_surfaces<kAx, kUniformTime, kFeat, true>(
          p, nullptr, tb, tx, cam, L, active, tile, lane, it, pxi, pxj, bidx,
          best);
      if (active) {
        L.iters += 1.f;
        out[(size_t)(kOutRows + it) * T] = (float)code;
      }
    }
    for (it = (int)L.iters; it < p.n_iters; ++it) {
      out[(size_t)(kOutRows + it) * T] = -1.f;
    }
  } else {
    uint32_t it = 0;
    int running = __syncthreads_or(valid);
    while (running) {
      float best;
      const int bidx = sweep_culled<kMoving, kUniformTime, kModes>(
          p, k, box, wb, stage, L, valid, 1.f, best, blocks, needed, sp);
      bounce_surfaces<kAx, kUniformTime, kFeat, true>(
          p, nullptr, tb, tx, cam, L, valid, tile, lane, it, pxi, pxj, bidx,
          best);
      L.iters += 1.f;
      ++it;
      // every p.unroll iterations (it is the block's)
      running = (kModes && !checks(p, it)) || __syncthreads_or(L.done < p.spp);
    }
  }
  out[0] = L.ax;
  out[(size_t)1 * T] = L.ay;
  out[(size_t)2 * T] = L.az;
  out[(size_t)3 * T] = L.segs;
  out[(size_t)4 * T] = L.iters;
  out[(size_t)5 * T] = L.done;
  out[(size_t)6 * T] = blocks;
  out[(size_t)7 * T] = needed;
  sp.add(kSpTotal, t_start);
  sp.flush();
}

template <bool kMoving, bool kUniformTime, bool kTex>
__global__ void __launch_bounds__(kCulledMaxT, 1)
    mega_kernel_culled_surfaces(Params p, Clusters k, Surfaces q, Texels x) {
  culled_surface_lanes<kMoving, kUniformTime, kTex, false>(p, k, q, x);
}

template <bool kMoving, bool kUniformTime, bool kTex>
__global__ void __launch_bounds__(kCulledMaxT, 1)
    mega_kernel_culled_surfaces_modes(Params p, Clusters k, Surfaces q,
                                      Texels x) {
  culled_surface_lanes<kMoving, kUniformTime, kTex, true>(p, k, q, x);
}

// The dense surfaces kernels' exact-mode blocks: their lanes are
// independent (no warp vote), and the gradient path's tape launch holds
// 16,384 lanes, 64 blocks of kExactBlock on 132 SMs; blocks of 128 lanes
// spread it over every SM (64, 128 and 256 measured, PERF.md §6).
constexpr int kSurfExactBlock = 128;

// The culled kernels' plan-mode instantiations (..._modes, in
// megakernel_modes.cu) are built into the kernels' library; a measurement
// build (ops/_build.py defines RTW_MEASURE with any define, -DRTW_SPLIT's
// included) compiles this source without megakernel_modes.cu, times the
// default plan and launches no mode.
#ifdef RTW_MEASURE
constexpr bool kPlanModes = false;
#else
constexpr bool kPlanModes = true;
#endif

// Launch `kern` with `smem` bytes of dynamic shared memory: one block of T
// lanes per tile (overdraw), or blocks of `exact_block` lanes (exact).
template <class Kernel, class... Args>
cudaError_t launch(Kernel kern, size_t smem, const Params& p,
                   cudaStream_t stream, int exact_block, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return e;
    }
  }
  dim3 grid, block;
  if (p.exact) {
    const long long lanes = (long long)p.n_tiles * p.T;
    grid = dim3((unsigned)((lanes + exact_block - 1) / exact_block));
    block = dim3(exact_block);
  } else {
    grid = dim3(p.n_tiles);
    block = dim3(p.T);
  }
  kern<<<grid, block, smem, stream>>>(p, args...);
  return cudaGetLastError();
}

// The surfaces forms (kFeat masks) each dense (axes, uniform shutter) form
// is instantiated for, in the order of rtw_surface_forms and the host's
// SURFACE_FORMS (ops/megakernel.py): the static form, which every surfaces
// scene of the library plans, one a feature set its scenes use (earth,
// earth_rect, two_perlin_spheres, light_sample, checker_spheres,
// cornell_box, then the general ones: cornell_smoke and the rest, and
// texture_mix); the moving forms the general two only. The host plans the
// first form of the plan's (axes, shutter) that holds its features and
// whose textures are its textures'.
template <int kAxes, bool kUniformTime, int... kFeats>
struct SurfaceForms {};
using StaticForms =
    SurfaceForms<kAxesStatic, false, kFImage, kFRects | kFImage, kFNoise,
                 kFRects | kFNoise, kFChecker, kFRects | kFLights, kFSurf,
                 kFAll>;
using AxisYForms = SurfaceForms<kAxisY, true, kFSurf, kFAll>;
using AllAxesForms = SurfaceForms<kAxesAll, true, kFSurf, kFAll>;
using ShutterForms = SurfaceForms<kAxesAll, false, kFSurf, kFAll>;
template <int kAxes, bool kUniformTime>
using FormsOf = std::conditional_t<
    kAxes == kAxesStatic, StaticForms,
    std::conditional_t<kAxes == kAxisY, AxisYForms,
                       std::conditional_t<kUniformTime, AllAxesForms,
                                          ShutterForms>>>;

// Launch the surfaces form `feat` of (kAxes, kUniformTime), one of kFeats;
// cudaErrorInvalidValue when it is not built.
template <int kAxes, bool kUniformTime, int... kFeats>
cudaError_t launch_surfaces(SurfaceForms<kAxes, kUniformTime, kFeats...>,
                            int feat, size_t smem, const Params& p,
                            cudaStream_t stream, const Surfaces& q,
                            const Texels& x) {
  cudaError_t e = cudaErrorInvalidValue;
  (void)((feat == kFeats
              ? (e = launch(mega_kernel_surfaces<kAxes, kUniformTime, kFeats>,
                            smem, p, stream, kSurfExactBlock, q, x),
                 true)
              : false) ||
         ...);
  return e;
}

// The sphere kernel (q == nullptr), the surfaces kernel of form `feat`
// (x != nullptr: with textures), culled (k != nullptr) or dense; with
// their shared memory. The dense kernels' slot loop lerps the axes of
// kAxes; the culled kernels' lerps all three when kAxes moves any.
template <int kAxes, bool kUniformTime>
cudaError_t launch_one(const Params& p, const Surfaces* q, const Texels* x,
                       const Clusters* k, int feat, cudaStream_t stream) {
  constexpr bool kMoving = kAxes != kAxesStatic;
  // the surfaces tables of stage_surfaces, in words
  const size_t ns = q == nullptr ? 0
                                 : (size_t)surface_words(
                                       q->R, q->L, q->V,
                                       x == nullptr ? 0 : x->n_img,
                                       x != nullptr);
  if (k != nullptr) {
    const int warps = (p.exact ? kExactBlock : p.T) / 32;
    const size_t bytes =
        sizeof(float) *
        (stage_words<kMoving>(k->SB, warps) +
         (size_t)cluster_words(*k, warps) + ns);
    // the plan modes' instantiations only where a mode is on; the
    // measurement build has none (kPlanModes)
    if (k->sg || k->bv || p.unroll != 1) {
      if constexpr (!kPlanModes) {
        return cudaErrorInvalidValue;
      } else {
        return (cudaError_t)rtw_culled_modes_launch(
            kMoving, kUniformTime, q == nullptr ? -1 : x != nullptr, bytes,
            &p, k, q, x, stream);
      }
    }
    if (q == nullptr) {
      return launch(mega_kernel_culled<kMoving, kUniformTime>, bytes, p,
                    stream, kExactBlock, *k);
    }
    if (x == nullptr) {
      return launch(mega_kernel_culled_surfaces<kMoving, kUniformTime, false>,
                    bytes, p, stream, kExactBlock, *k, *q, Texels{});
    }
    return launch(mega_kernel_culled_surfaces<kMoving, kUniformTime, true>,
                  bytes, p, stream, kExactBlock, *k, *q, *x);
  }
  const size_t bytes =
      sizeof(float) * ((size_t)slot_words(kAxes, kUniformTime) * p.S + ns);
  if (q == nullptr) {
    return launch(mega_kernel<kAxes, kUniformTime>, bytes, p, stream,
                  kExactBlock);
  }
  return launch_surfaces(FormsOf<kAxes, kUniformTime>{}, feat,
                         bytes, p, stream, *q, x == nullptr ? Texels{} : *x);
}

// The dense kernels' (axes, uniform shutter) forms, as rtw_mega_launch
// dispatches them, and each form's instantiations: the sphere kernel, the
// general surfaces forms without and with textures (rtw_dense_consts).
constexpr int kDenseForm[][2] = {
    {kAxesStatic, 0}, {kAxisY, 1}, {kAxesAll, 1}, {kAxesAll, 0}};
constexpr int kDenseForms = sizeof(kDenseForm) / sizeof(kDenseForm[0]);
#ifndef RTW_MODES_TU
const void* const kDenseKernels[3][kDenseForms] = {{
    (const void*)mega_kernel<kAxesStatic, false>,
    (const void*)mega_kernel<kAxisY, true>,
    (const void*)mega_kernel<kAxesAll, true>,
    (const void*)mega_kernel<kAxesAll, false>}, {
    (const void*)mega_kernel_surfaces<kAxesStatic, false, kFSurf>,
    (const void*)mega_kernel_surfaces<kAxisY, true, kFSurf>,
    (const void*)mega_kernel_surfaces<kAxesAll, true, kFSurf>,
    (const void*)mega_kernel_surfaces<kAxesAll, false, kFSurf>}, {
    (const void*)mega_kernel_surfaces<kAxesStatic, false, kFAll>,
    (const void*)mega_kernel_surfaces<kAxisY, true, kFAll>,
    (const void*)mega_kernel_surfaces<kAxesAll, true, kFAll>,
    (const void*)mega_kernel_surfaces<kAxesAll, false, kFAll>}};
#endif

// One row a surfaces instantiation of the forms' list, in order: (axes,
// uniform shutter, kFeat, then cudaFuncGetAttributes' maxThreadsPerBlock,
// numRegs and localSizeBytes) from row `row` on; rows past n are not
// written. Returns the next row, or minus the CUDA error.
template <int kAxes, bool kUniformTime, int... kFeats>
int surface_rows(SurfaceForms<kAxes, kUniformTime, kFeats...>, int* out,
                 int row, int n) {
  const void* kerns[] = {
      (const void*)mega_kernel_surfaces<kAxes, kUniformTime, kFeats>...};
  const int feats[] = {kFeats...};
  for (int i = 0; i < (int)sizeof...(kFeats); ++i, ++row) {
    if (row >= n) continue;
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kerns[i]);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch reports it
      return -(int)e;
    }
    int* r = out + 6 * row;
    r[0] = kAxes;
    r[1] = kUniformTime;
    r[2] = feats[i];
    r[3] = a.maxThreadsPerBlock;
    r[4] = a.numRegs;
    r[5] = (int)a.localSizeBytes;
  }
  return row;
}

}  // namespace

#ifdef RTW_MODES_TU
// The plan-mode instantiations of mega_kernel_culled and
// mega_kernel_culled_surfaces (see rtw_culled_modes_launch above).
extern "C" int rtw_culled_modes_launch(int moving, int uniform_time,
                                       int surfaces, size_t smem,
                                       const void* pv, const void* kv,
                                       const void* qv, const void* xv,
                                       void* stream) {
  const Params& p = *static_cast<const Params*>(pv);
  const Clusters& k = *static_cast<const Clusters*>(kv);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto mov, auto uni) -> cudaError_t {
    constexpr bool kMov = decltype(mov)::value, kUni = decltype(uni)::value;
    if (surfaces < 0) {
      return launch(mega_kernel_culled_modes<kMov, kUni>, smem, p, s,
                    kExactBlock, k);
    }
    const Surfaces& q = *static_cast<const Surfaces*>(qv);
    if (surfaces == 0) {
      return launch(mega_kernel_culled_surfaces_modes<kMov, kUni, false>,
                    smem, p, s, kExactBlock, k, q, Texels{});
    }
    return launch(mega_kernel_culled_surfaces_modes<kMov, kUni, true>, smem,
                  p, s, kExactBlock, k, q, *static_cast<const Texels*>(xv));
  };
  using T = std::true_type;
  using F = std::false_type;
  if (!moving) return (int)run(F{}, F{});
  return (int)(uniform_time ? run(T{}, T{}) : run(T{}, F{}));
}
#else
extern "C" {

// Launch the megakernel on `stream`. Returns cudaGetLastError() after the
// launch (0 on success): a launch the device refuses (too many threads or
// too much shared memory) reports here and nowhere else. `surfaces`, when
// not 0, selects mega_kernel_surfaces, the kernel with the rect / light /
// medium parts, in its form of that kFeat mask (rtw_surface_forms; a
// culled launch any value but 0); `textures` says whether the form has
// textures (checker, noise or image), whose image sizes follow the row
// codes in `codes`. A form that lacks a feature the rows need (R, L or V
// rows without its rects, lights or media), or whose textures are not
// `textures`, is refused; so is one that is not built. `cull` the culled
// kernels over the (C, 128) cluster table `clus` (sph then holds the slot
// quads of sweep_cluster, not the dense (9, S) SoA): mega_kernel_culled,
// or with `surfaces` mega_kernel_culled_surfaces. `axes` is the slot loop's
// moving-axis mask (ops/megakernel.py sweep_axes): 0 static, 2 y only
// (with uniform_time), 7 all axes; the culled kernels lerp all three axes
// for any other than 0. The plan modes come after the stream, so that a
// build older than them, which reads up to the stream, takes the same call
// at their defaults: `unroll` bounce iterations between an overdraw
// block's checks (1 in exact mode), `sg` clusters a super-group of the
// two-level vote (0: none; clus then holds the ceil(C / sg) union boxes
// after the C clusters' rows) and `batch_votes`, both culled in ascending
// order (dord 0) only.
int rtw_mega_launch(const float* pixf, const float* cam, const float* sph,
                    const float* attr, const float* clus, const float* rect,
                    const float* light, const float* med, const int* codes,
                    const int* perm, const float* ranvec,
                    const float* images, float* out, int n_tiles, int T,
                    int S, int R, int L, int V, int n_iters, int seed,
                    int spp, int max_depth, int rr_depth, int n_img,
                    int img_h, int img_w, int C, int SB, int dord, int exact,
                    int lens, int bg_gradient, int axes, int uniform_time,
                    int surfaces, int has_spheres, int textures, int cull,
                    float inv_nx, float inv_ny, float t_min, float ut_t0,
                    float ut_idt, float inv_L, void* stream, int unroll,
                    int sg, int batch_votes) {
  if (n_tiles <= 0 || T <= 0 || S <= 0 || R < 0 || L < 0 || V < 0 ||
      n_iters < 0 || (exact && n_iters <= 0) ||
      (!exact && T > (cull ? kCulledMaxT : kDenseMaxT)) ||
      (axes != kAxesStatic && axes != kAxesAll &&
       !(axes == kAxisY && uniform_time)) ||
      (!surfaces && (R || L || V || textures)) ||
      (surfaces && !cull &&
       ((R && !(surfaces & kFRects)) || (L && !(surfaces & kFLights)) ||
        (V && !(surfaces & kFMedia)) ||
        (textures != 0) != ((surfaces & kFTex) != 0))) ||
      n_img < 0 ||
      img_h <= 0 || img_w <= 0 ||
      (cull && (T % 32 || C <= 0 ||
                SB <= 0 || (long long)C * SB != S || dord < 0)) ||
      unroll < 1 || (exact && unroll != 1) || sg < 0 ||
      ((sg || batch_votes) && !(cull && dord == 0)) ||
      (sg && C < 2) || (batch_votes != 0 && batch_votes != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.pixf = pixf;
  p.cam = cam;
  p.sph = sph;
  p.attr = attr;
  p.out = out;
  p.n_tiles = n_tiles;
  p.T = T;
  p.S = S;
  p.n_iters = n_iters;
  p.seed = (uint32_t)seed;
  p.spp = (float)spp;
  p.max_depth = (float)max_depth;
  p.rr_depth = (float)rr_depth;
  p.exact = exact;
  p.lens = lens;
  p.bg_gradient = bg_gradient;
  p.uniform_time = uniform_time;
  p.inv_nx = inv_nx;
  p.inv_ny = inv_ny;
  p.t_min = t_min;
  p.ut_t0 = ut_t0;
  p.ut_idt = ut_idt;
  p.unroll = (uint32_t)unroll;
  p.unroll_shift = __builtin_ctz(p.unroll);
  const uint32_t u = p.unroll >> p.unroll_shift;
  uint32_t inv = u;  // Newton's iteration: 5, 10, 20, 40 correct bits
  for (int i = 0; i < 4; ++i) inv *= 2u - u * inv;
  p.unroll_inv = inv;
  p.unroll_lim = 0xFFFFFFFFu / p.unroll;
  Surfaces q{rect, light, med, codes, R, L, V, has_spheres, inv_L};
  const Surfaces* qp = surfaces ? &q : nullptr;
  Texels x{perm, ranvec, images, n_img, img_h, img_w};
  const Texels* xp = textures ? &x : nullptr;
  Clusters k{clus, C, SB, dord, sg, sg ? (C + sg - 1) / sg : 0, batch_votes};
  const Clusters* kp = cull ? &k : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  const int f = surfaces;
  if (axes == kAxesStatic) {
    e = launch_one<kAxesStatic, false>(p, qp, xp, kp, f, s);
  } else if (axes == kAxisY) {  // uniform_time, checked above
    e = launch_one<kAxisY, true>(p, qp, xp, kp, f, s);
  } else {
    e = uniform_time ? launch_one<kAxesAll, true>(p, qp, xp, kp, f, s)
                     : launch_one<kAxesAll, false>(p, qp, xp, kp, f, s);
  }
  return (int)e;
}

// The dense kernels' forms, for the host's plans and checks
// (ops/megakernel.py check_dense_consts): for each of the first n forms
// (kDenseForm), out[6 i ..] = (axes, uniform shutter, slot_words, then
// cudaFuncGetAttributes(...).maxThreadsPerBlock of its sphere, surfaces
// and textured surfaces kernels). Returns kDenseForms, or minus the CUDA
// error.
int rtw_dense_consts(int* out, int n) {
  for (int i = 0; i < n && i < kDenseForms; ++i) {
    int* row = out + 6 * i;
    row[0] = kDenseForm[i][0];
    row[1] = kDenseForm[i][1];
    row[2] = slot_words(kDenseForm[i][0], kDenseForm[i][1] != 0);
    for (int k = 0; k < 3; ++k) {
      cudaFuncAttributes a;
      const cudaError_t e = cudaFuncGetAttributes(&a, kDenseKernels[k][i]);
      if (e != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch reports it
        return -(int)e;
      }
      row[3 + k] = a.maxThreadsPerBlock;
    }
  }
  return kDenseForms;
}

// The surfaces forms, for the host's plans and checks (ops/megakernel.py
// check_surface_forms): one row of 6 ints a surfaces instantiation of the
// dense (axes, shutter) forms, in order (surface_rows: axes, uniform
// shutter, kFeat, block limit, registers, local bytes), the first n rows.
// Returns the number of instantiations, or minus the CUDA error.
int rtw_surface_forms(int* out, int n) {
  int row = surface_rows(StaticForms{}, out, 0, n);
  if (row >= 0) row = surface_rows(AxisYForms{}, out, row, n);
  if (row >= 0) row = surface_rows(AllAxesForms{}, out, row, n);
  if (row >= 0) row = surface_rows(ShutterForms{}, out, row, n);
  return row;
}

// The culled kernels' policy constants, for the host's plain version and
// plans: out[0] = kBcast, out[1] = kCulledMaxT.
void rtw_culled_consts(int* out) {
  out[0] = kBcast;
  out[1] = kCulledMaxT;
}

const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef RTW_SPLIT
// Copy the dense surfaces kernel's split sums (kSurfParts of them:
// SurfSplit) to `host` and clear them. Returns the CUDA error.
int rtw_split_surfaces_read(unsigned long long* host) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, g_surf_split, sizeof(g_surf_split));
  if (e == cudaSuccess) {
    const unsigned long long zero[kSurfParts] = {};
    e = cudaMemcpyToSymbol(g_surf_split, zero, sizeof(zero));
  }
  return (int)e;
}

// Where the dense surfaces kernel's overdraw blocks write (start ns, end
// ns, SM id), 3 words a block in device memory (nullptr: nowhere).
int rtw_split_blocks(unsigned long long* dev) {
  return (int)cudaMemcpyToSymbol(g_block_times, &dev, sizeof(dev));
}

// Copy the culled kernels' split sums (kSplitParts of them: Split) to
// `host` and clear them. Returns the CUDA error (0 on success).
int rtw_split_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_split, sizeof(g_split));
  if (e == cudaSuccess) {
    const unsigned long long zero[kSplitParts] = {};
    e = cudaMemcpyToSymbol(g_split, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

}  // extern "C"
#endif  // RTW_MODES_TU

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
//     lane of the block has spp (__syncthreads_or after each bounce), and
//     the host epilogue renormalises by the per-lane sample count;
//   exact (exact == 1): every lane traces exactly spp samples on its own
//     and writes its winner code per iteration: -1 miss, [0, S) sphere
//     slot, S + r rect row, S + R + v medium row (the JAX tape encoding).
//     Blocks are 256 threads; T is then only the tile width of the RNG key
//     (tile = lane / T, lane % T), so the streams match any logical T.
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
// R-rect plane tests and the light-pdf re-intersection. Every table
// (sphere SoA, then the rect, light and medium rows and their static
// codes) is copied once per block into shared memory and broadcast to the
// threads of a warp; the loops over rects, lights and media run at run
// time, with each row's axis, kind and transform presence read from its
// code. The sphere attribute rows stay in global memory and are read once
// per bounce through the read-only path (__ldg).
//
// Culling (K5): a dense sweep of S slots costs ~34 instructions a slot and
// its (9, S) table stops fitting in shared memory near 6400 slots. The
// culled kernel keeps only the (C, 6) cluster boxes there; each warp votes
// a cluster with one __any_sync (the TPU kernel's whole-tile any() becomes
// a warp's), so a warp sweeps only the clusters one of its rays can reach
// before its running best, in near-to-far order keyed by a
// __reduce_min_sync of the slab entries. The slots it sweeps stream from
// L2 as broadcast 16-byte loads, one slot for all 32 lanes. The culled
// surfaces kernel (K5s) adds the surfaces tables behind the boxes and
// bucket slots in shared memory, and runs the surfaces bounce after the
// sweep on the warp's active lanes.
//
// Textures (K4): a Perlin evaluation makes 6 permutation reads and 8
// gradient reads per octave at data-dependent addresses (marble and turb
// take 7 octaves), so the 256-entry permutation and the 256 x 3 float32
// gradients (4 KB) sit in shared memory, where a warp's scattered reads do
// not serialise as they would in constant memory. The JAX kernel's bf16
// hi/lo one-hot lookups of those tables are a TPU device: this kernel
// indexes the exact float32 values. Texels stay in device memory (the
// earth image is 768 KB, resident in the 50 MB L2) and are read through
// __ldg, one nearest texel per hit. The sphere uv keeps the JAX kernel's
// polynomial atan2 / asin, and sinf / floorf are IEEE (no fast math), so
// the texel index and the noise round as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

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
};

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

// Fresh jittered camera ray for (tile, lane) at iteration `it`, salt 1
// (camera.h:36-50); the first rays of a launch use it = -1.
__device__ __forceinline__ void gen_ray(const Params& p, const Cam& cam,
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

// Closest hit over every slot of the shared-memory table (sweep.cuh).
// Returns the winner slot (S on a miss) and its t in `best`.
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ int sweep(const Params& p, const float* sm,
                                     const Lane& L, float& best) {
  const float frac_u = kUniformTime ? (L.time - p.ut_t0) * p.ut_idt : 0.f;
  return sweep_slots<kMoving, kUniformTime>(sm, p.S, L, frac_u, p.t_min,
                                            best);
}

__device__ __forceinline__ float attr_at(const Params& p, int row, int slot) {
  return __ldg(p.attr + (size_t)row * p.S + slot);
}

// One bounce iteration of one lane. Returns the winner code (-1 for a miss
// or an idle lane, else the sphere slot). With kSwept the closest hit comes
// from the caller (the culled kernel's sweep: swept_bidx, swept_best) and
// `sm` is not read.
template <bool kMoving, bool kUniformTime, bool kSwept = false>
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
        kSwept ? swept_bidx : sweep<kMoving, kUniformTime>(p, sm, L, best);
    if (best < kHitCut) {
      code = bidx;
      px = fmaf(best, L.dx, L.ox);
      py = fmaf(best, L.dy, L.oy);
      pz = fmaf(best, L.dz, L.oz);
      // ---- sphere normal ((p - c(t)) / r; a negative r points inward) ----
      float scx = attr_at(p, A_CX, bidx);
      float scy = attr_at(p, A_CY, bidx);
      float scz = attr_at(p, A_CZ, bidx);
      if (kMoving) {
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

// NaN-propagating min / max, as torch.minimum / maximum and XLA's: the
// slab of a ray that runs in a face's plane gives 0 * inf = NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The shared-memory copy of a surfaces launch's tables.
struct Tables {
  const float* rect;   // (R, rect_lanes)
  const float* light;  // (L, kLightLanes)
  const float* med;    // (V, med_lanes)
  const int* code;     // R rect, L light, V medium codes
  int R, L, V, has_spheres;
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

// Closest rect (hittable.h:142-267): the first rect with the strictly
// smallest t wins. Rects of one transform group (a box's faces) share one
// object-space ray. Returns the winner row (-1: none) and its t in rb_t;
// with kTex, the winner's planar uv (hittable.h:160-172) in r_u, r_v.
template <bool kTex>
__device__ __forceinline__ int rect_hit(const Params& p, const Tables& tb,
                                        const Lane& L, float idx, float idy,
                                        float idz, float& rb_t, float& r_u,
                                        float& r_v) {
  rb_t = kBig;
  int rwin = -1, group = -1;
  float rox = 0.f, roy = 0.f, roz = 0.f, rdx = 0.f, rdy = 0.f, rdz = 0.f;
  float irx = idx, iry = idy, irz = idz;
  for (int r = 0; r < tb.R; ++r) {
    const float* row = tb.rect + r * rect_lanes<kTex>();
    const int code = tb.code[r];
    if ((code >> 4) != group) {
      group = code >> 4;
      const bool rot = code & 4;
      to_object(row + RT_COS, rot, code & 8, L.ox, L.oy, L.oz, L.dx, L.dy,
                L.dz, rox, roy, roz, rdx, rdy, rdz);
      irx = rot ? 1.f / rdx : idx;
      irz = rot ? 1.f / rdz : idz;
    }
    const int ax = code & 3;
    float oa, ob, on, da, db, dn;
    plane_axes(ax, rox, roy, roz, oa, ob, on);
    plane_axes(ax, rdx, rdy, rdz, da, db, dn);
    const float in = ax == 0 ? irz : (ax == 1 ? iry : irx);  // 1 / dn
    // d_n == 0 gives t = +-inf or NaN: every comparison then fails
    const float t = (row[RT_K] - on) * in;
    const float pa = fmaf(t, da, oa);
    const float pb = fmaf(t, db, ob);
    if (t > p.t_min && t < rb_t && pa >= row[RT_A0] && pa <= row[RT_A1] &&
        pb >= row[RT_B0] && pb <= row[RT_B1]) {
      rb_t = t;
      rwin = r;
      if (kTex) {  // uv = planar offset / extent
        r_u = (pa - row[RT_A0]) * row[RT_IDA];
        r_v = (pb - row[RT_B0]) * row[RT_IDB];
      }
    }
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
  const float* rv;      // (256, 3) in shared memory
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
        const float* g = tx.rv + 3 * (pi[di] ^ pj[dj] ^ pk[dk]);
        const float dot = fmaf(g[2], rw, fmaf(g[0], ru, g[1] * rv));
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
__device__ __forceinline__ void texture_albedo(
    const TexTables& tx, float noi, float nsc, float chk, const float* cols,
    int stride, float img, bool sphere_uv, float u, float v, float px,
    float py, float pz, float nx, float ny, float nz, float& wx, float& wy,
    float& wz) {
  if (noi > 0.5f) {
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
  }
  if (chk > 0.5f) {
    const float sines = sinf(10.f * px) * sinf(10.f * py) * sinf(10.f * pz);
    const float* c = cols + (sines < 0.f ? 3 * stride : 0);
    wx = c[0];
    wy = c[stride];
    wz = c[2 * stride];
  }
  if (img > 0.5f) {
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
  }
}

// One bounce iteration of one lane in a scene with rects, lights or media
// (and, with kTex, textures). Returns the winner code (-1 for a miss or an
// idle lane). With kSwept the closest sphere hit comes from the caller
// (the culled kernel's sweep: swept_bidx, swept_best) and `sm` is not
// read; the rects and media then merge after it as after the dense sweep.
template <bool kMoving, bool kUniformTime, bool kTex, bool kSwept = false>
__device__ __forceinline__ int bounce_surfaces(
    const Params& p, const float* sm, const Tables& tb, const TexTables& tx,
    const Cam& cam, Lane& L, bool active, uint32_t tile, uint32_t lane,
    uint32_t it, float pxi, float pxj, int swept_bidx = 0,
    float swept_best = 0.f) {
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
      bidx = sweep<kMoving, kUniformTime>(p, sm, L, s_best);
    }
    const float idx = 1.f / L.dx, idy = 1.f / L.dy, idz = 1.f / L.dz;
    float rb_t, r_u = 0.f, r_v = 0.f;
    const int rwin = rect_hit<kTex>(p, tb, L, idx, idy, idz, rb_t, r_u, r_v);
    const bool use_rect = rb_t < s_best;
    float best = fminf(s_best, rb_t);
    float md_t;
    const int mwin =
        media_hit<kTex>(p, tb, L, idx, idy, idz,
                        stream_base(p.seed, tile, it, 4u, lane), md_t);
    const bool use_med = md_t < best;
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
        if (kTex) {  // noise or image, no checker; media sample uv (0, 0)
          texture_albedo(tx, row[MD_NOI], row[MD_NSC], 0.f, row, 0,
                         row[MD_IMG], false, 0.f, 0.f, px, py, pz, 0.f, 0.f,
                         0.f, wx, wy, wz);
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
            texture_albedo(tx, row[RT_NOI], row[RT_NSC], row[RT_CHK],
                           row + RT_EVENX, 1, row[RT_IMG], false, r_u, r_v,
                           px, py, pz, nx, ny, nz, wx, wy, wz);
          }
        } else {
          // ---- sphere normal ((p - c(t)) / r) ----
          float scx = attr_at(p, A_CX, bidx);
          float scy = attr_at(p, A_CY, bidx);
          float scz = attr_at(p, A_CZ, bidx);
          if (kMoving) {
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
            texture_albedo(tx, attr_at(p, A_NOISE, bidx),
                           attr_at(p, A_NSCALE, bidx), attr_at(p, A_CHK, bidx),
                           p.attr + (size_t)A_EVENX * p.S + bidx, p.S,
                           attr_at(p, A_IMG, bidx), true, 0.f, 0.f, px, py, pz,
                           nx, ny, nz, wx, wy, wz);
          }
        }
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
          float ux, uy, uz, vx, vy, vz;
          onb(nx, ny, nz, ux, uy, uz, vx, vy, vz);
          ndx = fmaf(z, nx, fmaf(lx, ux, ly * vx));
          ndy = fmaf(z, ny, fmaf(lx, uy, ly * vy));
          ndz = fmaf(z, nz, fmaf(lx, uz, ly * vz));
          scatter_ok = z > 0.f;
          if (tb.L > 0) {
            // ---- one-sample MIS: the mixture of the cosine pdf and the
            // lights pdf (RayTracingWeekend.cpp:117-124, pdf.h:55-75);
            // salt 3: u0 picks the light, u1 u2 sample it, u3 the coin ----
            const uint32_t b3 = stream_base(p.seed, tile, it, 3u, lane);
            const float pickf = uniform_row(b3, 0) * (float)tb.L;
            const int li = (int)pickf;  // li <= pickf < li + 1
            float ldx = 0.f, ldy = 0.f, ldz = 0.f;
            if (li < tb.L) {
              light_dir(tb.light + li * kLightLanes, tb.code[tb.R + li],
                        uniform_row(b3, 1), uniform_row(b3, 2), px, py, pz,
                        ldx, ldy, ldz);
            }
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
            const float acc = light_pdf(p, tb, px, py, pz, mux, muy, muz);
            const float pdf_val = fmaf(0.5f, cpdf, 0.5f * acc * tb.inv_L);
            scatter_ok = pdf_val > 0.f;
            // weight = albedo * scattering pdf / mixture pdf
            const float lam_w = scatter_ok ? cpdf / pdf_val : 0.f;
            wx *= lam_w;
            wy *= lam_w;
            wz *= lam_w;
          }
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
        } else {
          // ---- diffuse_light: one-sided emission (material.h:238-244)
          // when the ray runs along the normal; the path ends here ----
          if (ddn > 0.f) {
            L.rx += L.tpx * wx;
            L.ry += L.tpy * wy;
            L.rz += L.tpz * wz;
          }
          scatter_ok = false;
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
    gen_ray(p, cam, tile, lane, it, pxi, pxj, L);
    L.tpx = L.tpy = L.tpz = 1.f;
    L.rx = L.ry = L.rz = 0.f;
    L.depth = 0.f;
  }
  return code;
}

template <bool kMoving, bool kUniformTime>
__global__ void mega_kernel(Params p) {
  extern __shared__ float sm[];  // (9, S) sweep SoA
  for (int i = threadIdx.x; i < kLanes * p.S; i += blockDim.x) {
    sm[i] = __ldg(p.sph + i);
  }
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
      const int code = bounce<kMoving, kUniformTime>(p, sm, cam, L, true,
                                                     tile, lane, it, pxi, pxj);
      L.iters += 1.f;
      out[(size_t)(kOutRows + it) * T] = (float)code;
    }
    for (; it < p.n_iters; ++it) out[(size_t)(kOutRows + it) * T] = -1.f;
  } else {
    uint32_t it = 0;
    int running = __syncthreads_or(valid);
    while (running) {
      bounce<kMoving, kUniformTime>(p, sm, cam, L, valid, tile, lane, it, pxi,
                                    pxj);
      L.iters += 1.f;
      ++it;
      running = __syncthreads_or(L.done < p.spp);
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

// Copy a surfaces launch's tables to shared memory from `base`: the rect,
// light and medium rows (their first rect_lanes / kLightLanes / med_lanes
// lanes), the R + L + V static codes and, with kTex, the image sizes and
// the Perlin tables. The caller synchronises the block before reading.
template <bool kTex>
__device__ __forceinline__ void stage_surfaces(float* base, const Surfaces& q,
                                               const Texels& x, Tables& tb,
                                               TexTables& tx) {
  constexpr int kRL = rect_lanes<kTex>(), kML = med_lanes<kTex>();
  float* rect = base;
  float* light = rect + q.R * kRL;
  float* med = light + q.L * kLightLanes;
  int* codes = reinterpret_cast<int*>(med + q.V * kML);
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
  const int n_codes = q.R + q.L + q.V + (kTex ? 2 * x.n_img : 0);
  for (int i = threadIdx.x; i < n_codes; i += blockDim.x) {
    codes[i] = __ldg(q.codes + i);
  }
  tb = Tables{rect, light, med, codes, q.R, q.L, q.V, q.has_spheres,
              q.inv_L};
  tx = TexTables{};
  if (kTex) {
    int* perm = codes + n_codes;
    float* rv = reinterpret_cast<float*>(perm + kNoiseSize);
    for (int i = threadIdx.x; i < kNoiseSize; i += blockDim.x) {
      perm[i] = __ldg(x.perm + i);
    }
    for (int i = threadIdx.x; i < 3 * kNoiseSize; i += blockDim.x) {
      rv[i] = __ldg(x.ranvec + i);
    }
    tx = TexTables{perm, rv, codes + q.R + q.L + q.V, x.images, x.img_h,
                   x.img_w};
  }
}

// The kernel of scenes with rects, lights or media, or with textures
// (kTex). Its lane loop is mega_kernel's with bounce_surfaces; the two stay
// separate functions so that the sphere-only code (34 SASS instructions per
// sweep slot) does not depend on the surfaces path, and the kTex = false
// instantiations compile to the code they had before textures.
template <bool kMoving, bool kUniformTime, bool kTex>
__global__ void mega_kernel_surfaces(Params p, Surfaces q, Texels x) {
  // (9, S) sweep SoA, then the surfaces tables (stage_surfaces)
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < kLanes * p.S; i += blockDim.x) {
    sm[i] = __ldg(p.sph + i);
  }
  Tables tb;
  TexTables tx;
  stage_surfaces<kTex>(sm + kLanes * p.S, q, x, tb, tx);
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
      const int code = bounce_surfaces<kMoving, kUniformTime, kTex>(
          p, sm, tb, tx, cam, L, true, tile, lane, it, pxi, pxj);
      L.iters += 1.f;
      out[(size_t)(kOutRows + it) * T] = (float)code;
    }
    for (; it < p.n_iters; ++it) out[(size_t)(kOutRows + it) * T] = -1.f;
  } else {
    uint32_t it = 0;
    int running = __syncthreads_or(valid);
    while (running) {
      bounce_surfaces<kMoving, kUniformTime, kTex>(
          p, sm, tb, tx, cam, L, valid, tile, lane, it, pxi, pxj);
      L.iters += 1.f;
      ++it;
      running = __syncthreads_or(L.done < p.spp);
    }
  }
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
  const float* tab;  // (C, 128): AABB min xyz, max xyz in lanes 0-5
  int C, SB;         // clusters, slots per cluster
  int dord;          // near-to-far buckets of the visit order; 0: ascending id
};

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBoxLanes = 6;
constexpr float kShrink = 0x1.fffff8p-1f;  // float32(1 - 2.4e-7)
constexpr float kSurvCut = 0.5f * kBig;    // past it a cluster cannot win

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

// Closest hit over the SB slots of one cluster from `lo`, merged into
// (best, bidx) strictly (the first visitor keeps a tie): the arithmetic of
// `sweep`. The slots are 16-byte quads in device memory, Q a slot: (cx, cy,
// cz, nr2), with motion (dcx, dcy, dcz, 0), without a uniform shutter (t0,
// 1/dt, 0, 0). Every lane of a warp reads the same slot, a broadcast load
// through the read-only path; a cluster is 2-6 KB, resident in L1 / L2.
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ void sweep_cluster(const Params& p, int lo, int SB,
                                              const Lane& L, float frac_u,
                                              float& best, int& bidx) {
  constexpr int Q = kMoving ? (kUniformTime ? 2 : 3) : 1;
  const float4* q = reinterpret_cast<const float4*>(p.sph) + (size_t)lo * Q;
  const float tmin = p.t_min;
#pragma unroll 4
  for (int j = 0; j < SB; ++j) {
    const float4 a = __ldg(q + j * Q);
    float cx = a.x, cy = a.y, cz = a.z;
    if (kMoving) {
      const float4 m = __ldg(q + j * Q + 1);
      float fr = frac_u;
      if (!kUniformTime) {
        const float4 tq = __ldg(q + j * Q + 2);
        fr = (L.time - tq.x) * tq.y;
      }
      cx = fmaf(fr, m.x, cx);  // exact on static axes (dc = 0)
      cy = fmaf(fr, m.y, cy);
      cz = fmaf(fr, m.z, cz);
    }
    const float cox = cx - L.ox, coy = cy - L.oy, coz = cz - L.oz;
    const float nb = fmaf(coz, L.dz, fmaf(cox, L.dx, coy * L.dy));
    const float cc = fmaf(cox, cox, fmaf(coy, coy, fmaf(coz, coz, a.w)));
    const float disc = fmaf(nb, nb, -cc);
    const float sq = disc * rsqrtf(disc);
    const float tn = nb - sq, tf = nb + sq;
    const float t = tn > tmin ? tn : (tf > tmin ? tf : kBig);
    if (t < best) {
      best = t;
      bidx = lo + j;
    }
  }
}

// The culled closest hit of a warp's lanes; every lane of the warp calls
// it (an idle lane with active = false). A cluster is visited as one vote
// of the warp: it is swept, for all 32 lanes, when one active lane's ray
// enters its box before that lane's running best (the entry shrunk by
// 2.4e-7 so rounding never drops a tie). Visit order: ascending cluster
// id; or, with q.dord buckets, near to far: each cluster's key is the
// warp's smallest slab entry over its active lanes (BIG where none
// enters), keys past kSurvCut are dropped, the rest are bucketed linearly
// between the smallest key and the largest surviving one, and buckets are
// visited in order, clusters in ascending id within one. `wb` holds the
// warp's C keys, then buckets. Each visited cluster adds `inc` to
// `blocks`. Returns the winner slot (S on a miss) and its t in best.
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ int sweep_culled(const Params& p,
                                            const Clusters& q,
                                            const float* box, int* wb,
                                            const Lane& L, bool active,
                                            float inc, float& best,
                                            float& blocks) {
  const float idx = 1.f / L.dx, idy = 1.f / L.dy, idz = 1.f / L.dz;
  const float frac_u = kUniformTime ? (L.time - p.ut_t0) * p.ut_idt : 0.f;
  const float tmin = p.t_min;
  int bidx = p.S;
  best = kBig;
  auto visit = [&](int c) {
    float tlo, thi;
    slab(box + kBoxLanes * c, L, idx, idy, idz, tmin, tlo, thi);
    if (__any_sync(kFull, active && tlo <= thi && tlo * kShrink < best)) {
      sweep_cluster<kMoving, kUniformTime>(p, c * q.SB, q.SB, L, frac_u,
                                           best, bidx);
      blocks += inc;
    }
  };
  if (q.dord == 0) {
    for (int c = 0; c < q.C; ++c) visit(c);
    return bidx;
  }
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
  if (kmax == -kBig) return bidx;  // no active lane enters any box
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
  __syncwarp();  // the next bounce rewrites wb
  return bidx;
}

// The sphere kernel of culled plans (K5): mega_kernel's lanes with
// sweep_culled as their closest hit. The votes need every lane of a warp
// at one point: in overdraw mode a whole block loops until its slowest lane
// has spp; in exact mode a warp loops until its slowest lane has spp, the
// others idle, so T % 32 == 0 keeps a warp in one tile.
template <bool kMoving, bool kUniformTime>
__global__ void mega_kernel_culled(Params p, Clusters q) {
  // (C, 6) cluster boxes, then with q.dord C key / bucket slots per warp
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < kBoxLanes * q.C; i += blockDim.x) {
    sm[i] = __ldg(q.tab + (i / kBoxLanes) * kTableLanes + i % kBoxLanes);
  }
  int* wb = reinterpret_cast<int*>(sm + kBoxLanes * q.C) +
            (threadIdx.x >> 5) * q.C;
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
  float blocks = 0.f;

  float* out = p.out + (size_t)tile * (kOutRows + p.n_iters) * T + lane;
  if (p.exact) {
    // a lane's iterations are 0 .. iters - 1; it counts a block only then
    int it = 0;
    for (; it < p.n_iters && __any_sync(kFull, L.done < p.spp); ++it) {
      const bool active = L.done < p.spp;
      float best;
      const int bidx = sweep_culled<kMoving, kUniformTime>(
          p, q, sm, wb, L, active, active ? 1.f : 0.f, best, blocks);
      const int code = bounce<kMoving, kUniformTime, true>(
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
      const int bidx = sweep_culled<kMoving, kUniformTime>(
          p, q, sm, wb, L, valid, 1.f, best, blocks);
      bounce<kMoving, kUniformTime, true>(p, nullptr, cam, L, valid, tile,
                                          lane, it, pxi, pxj, bidx, best);
      L.iters += 1.f;
      ++it;
      running = __syncthreads_or(L.done < p.spp);
    }
  }
  out[0] = L.ax;
  out[(size_t)1 * T] = L.ay;
  out[(size_t)2 * T] = L.az;
  out[(size_t)3 * T] = L.segs;
  out[(size_t)4 * T] = L.iters;
  out[(size_t)5 * T] = L.done;
  out[(size_t)6 * T] = blocks;
  out[(size_t)7 * T] = 0.f;
}

// The culled kernel of scenes with rects, lights, media or textures (K5s):
// mega_kernel_culled's lanes and warp votes, with bounce_surfaces after the
// culled sphere sweep (the rects and media merge after it, strictly, as
// after the dense sweep). Every lane of a warp calls sweep_culled; the rest
// of the bounce, the tape rows, L.iters and the medium's stream run on
// active lanes only.
template <bool kMoving, bool kUniformTime, bool kTex>
__global__ void mega_kernel_culled_surfaces(Params p, Clusters k, Surfaces q,
                                            Texels x) {
  // (C, 6) cluster boxes, with k.dord C key / bucket slots per warp, then
  // the surfaces tables (stage_surfaces)
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < kBoxLanes * k.C; i += blockDim.x) {
    sm[i] = __ldg(k.tab + (i / kBoxLanes) * kTableLanes + i % kBoxLanes);
  }
  const int warps = blockDim.x >> 5;
  int* wb = reinterpret_cast<int*>(sm + kBoxLanes * k.C) +
            (threadIdx.x >> 5) * k.C;
  Tables tb;
  TexTables tx;
  stage_surfaces<kTex>(sm + k.C * (kBoxLanes + (k.dord ? warps : 0)), q, x,
                       tb, tx);
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
  for (int c = 0; c < kCamLanes; ++c) cam.c[c] = __ldg(p.cam + c);

  Lane L;
  gen_ray(p, cam, tile, lane, 0xFFFFFFFFu, pxi, pxj, L);  // it = -1
  L.tpx = L.tpy = L.tpz = 1.f;
  L.rx = L.ry = L.rz = L.ax = L.ay = L.az = 0.f;
  L.segs = L.depth = L.iters = 0.f;
  L.done = valid ? 0.f : p.spp;
  float blocks = 0.f;

  float* out = p.out + (size_t)tile * (kOutRows + p.n_iters) * T + lane;
  if (p.exact) {
    // a lane's iterations are 0 .. iters - 1; it counts a block only then
    int it = 0;
    for (; it < p.n_iters && __any_sync(kFull, L.done < p.spp); ++it) {
      const bool active = L.done < p.spp;
      float best;
      const int bidx = sweep_culled<kMoving, kUniformTime>(
          p, k, sm, wb, L, active, active ? 1.f : 0.f, best, blocks);
      const int code = bounce_surfaces<kMoving, kUniformTime, kTex, true>(
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
      const int bidx = sweep_culled<kMoving, kUniformTime>(
          p, k, sm, wb, L, valid, 1.f, best, blocks);
      bounce_surfaces<kMoving, kUniformTime, kTex, true>(
          p, nullptr, tb, tx, cam, L, valid, tile, lane, it, pxi, pxj, bidx,
          best);
      L.iters += 1.f;
      ++it;
      running = __syncthreads_or(L.done < p.spp);
    }
  }
  out[0] = L.ax;
  out[(size_t)1 * T] = L.ay;
  out[(size_t)2 * T] = L.az;
  out[(size_t)3 * T] = L.segs;
  out[(size_t)4 * T] = L.iters;
  out[(size_t)5 * T] = L.done;
  out[(size_t)6 * T] = blocks;
  out[(size_t)7 * T] = 0.f;
}

// Launch `kern` with `smem` bytes of dynamic shared memory: one block of T
// lanes per tile (overdraw), or blocks of kExactBlock lanes (exact).
template <class Kernel, class... Args>
cudaError_t launch(Kernel kern, size_t smem, const Params& p,
                   cudaStream_t stream, Args... args) {
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
    grid = dim3((unsigned)((lanes + kExactBlock - 1) / kExactBlock));
    block = dim3(kExactBlock);
  } else {
    grid = dim3(p.n_tiles);
    block = dim3(p.T);
  }
  kern<<<grid, block, smem, stream>>>(p, args...);
  return cudaGetLastError();
}

// The sphere kernel (q == nullptr), the surfaces kernel, or the surfaces
// kernel with textures (x != nullptr); culled (k != nullptr) or dense; with
// their shared memory.
template <bool kMoving, bool kUniformTime>
cudaError_t launch_one(const Params& p, const Surfaces* q, const Texels* x,
                       const Clusters* k, cudaStream_t stream) {
  // the surfaces tables of stage_surfaces, in words
  size_t ns = 0;
  if (q != nullptr) {
    ns = (size_t)q->L * kLightLanes + q->R + q->L + q->V;
    ns += x == nullptr
              ? (size_t)q->R * kRectLanes + (size_t)q->V * kMedLanes
              : (size_t)q->R * kRectTexLanes + (size_t)q->V * kMedTexLanes +
                    2 * x->n_img + 4 * kNoiseSize;
  }
  if (k != nullptr) {
    const int warps = (p.exact ? kExactBlock : p.T) / 32;
    const size_t bytes =
        sizeof(float) *
        ((size_t)k->C * (kBoxLanes + (k->dord ? warps : 0)) + ns);
    if (q == nullptr) {
      return launch(mega_kernel_culled<kMoving, kUniformTime>, bytes, p,
                    stream, *k);
    }
    if (x == nullptr) {
      return launch(mega_kernel_culled_surfaces<kMoving, kUniformTime, false>,
                    bytes, p, stream, *k, *q, Texels{});
    }
    return launch(mega_kernel_culled_surfaces<kMoving, kUniformTime, true>,
                  bytes, p, stream, *k, *q, *x);
  }
  const size_t bytes = sizeof(float) * ((size_t)kLanes * p.S + ns);
  if (q == nullptr) {
    return launch(mega_kernel<kMoving, kUniformTime>, bytes, p, stream);
  }
  if (x == nullptr) {
    return launch(mega_kernel_surfaces<kMoving, kUniformTime, false>, bytes,
                  p, stream, *q, Texels{});
  }
  return launch(mega_kernel_surfaces<kMoving, kUniformTime, true>, bytes, p,
                stream, *q, *x);
}

}  // namespace

extern "C" {

// Launch the megakernel on `stream`. Returns cudaGetLastError() after the
// launch (0 on success): a launch the device refuses (too many threads or
// too much shared memory) reports here and nowhere else. `surfaces` selects
// mega_kernel_surfaces, the kernel with the rect / light / medium parts;
// `textures` its instantiations with checker, noise and image textures,
// whose image sizes follow the row codes in `codes`; `cull` the culled
// kernels over the (C, 128) cluster table `clus` (sph then holds the slot
// quads of sweep_cluster, not the dense (9, S) SoA): mega_kernel_culled,
// or with `surfaces` mega_kernel_culled_surfaces.
int rtw_mega_launch(const float* pixf, const float* cam, const float* sph,
                    const float* attr, const float* clus, const float* rect,
                    const float* light, const float* med, const int* codes,
                    const int* perm, const float* ranvec,
                    const float* images, float* out, int n_tiles, int T,
                    int S, int R, int L, int V, int n_iters, int seed,
                    int spp, int max_depth, int rr_depth, int n_img,
                    int img_h, int img_w, int C, int SB, int dord, int exact,
                    int lens, int bg_gradient, int moving, int uniform_time,
                    int surfaces, int has_spheres, int textures, int cull,
                    float inv_nx, float inv_ny, float t_min, float ut_t0,
                    float ut_idt, float inv_L, void* stream) {
  if (n_tiles <= 0 || T <= 0 || S <= 0 || R < 0 || L < 0 || V < 0 ||
      n_iters < 0 || (!exact && T > 1024) || (exact && n_iters <= 0) ||
      (!surfaces && (R || L || V || textures)) || n_img < 0 ||
      img_h <= 0 || img_w <= 0 ||
      (cull && (T % 32 || C <= 0 || SB <= 0 || (long long)C * SB != S ||
                dord < 0))) {
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
  Surfaces q{rect, light, med, codes, R, L, V, has_spheres, inv_L};
  const Surfaces* qp = surfaces ? &q : nullptr;
  Texels x{perm, ranvec, images, n_img, img_h, img_w};
  const Texels* xp = textures ? &x : nullptr;
  Clusters k{clus, C, SB, dord};
  const Clusters* kp = cull ? &k : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (moving) {
    e = uniform_time ? launch_one<true, true>(p, qp, xp, kp, s)
                     : launch_one<true, false>(p, qp, xp, kp, s);
  } else {
    e = launch_one<false, false>(p, qp, xp, kp, s);
  }
  return (int)e;
}

const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Megakernel for sphere scenes: the whole path-trace loop in one launch.
//
// Replaces raytracingweekend_tpu/ops/megakernel.py::_kernel in its C=1
// configuration (one dense sphere cluster, no culling, no rects, lights,
// media or textures; ROADMAP kernel K1). Plain version beside it:
// raytracingweekend_tpu_torch/ops/megakernel.py::trace_mega_reference.
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
//     and writes its winner code per iteration (-1 miss, else the slot).
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
// What bounds it: FP32 issue in the S-slot quadratic, about 20 flops per
// (sphere, segment), with the sphere table (nine lanes, 36 bytes a slot)
// broadcast from shared memory to every thread of a warp. The attribute
// rows stay in global memory and are read once per bounce through the
// read-only path (__ldg).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e37f;
constexpr float kHitCut = 1.0e30f;
constexpr int kOutRows = 8;
constexpr int kExactBlock = 256;

// attribute table rows (24, S), as ops/megakernel.py A_*
enum { A_CX, A_CY, A_CZ, A_DCX, A_DCY, A_DCZ, A_T0, A_IDT, A_RINV, A_MTYPE,
       A_ALBX, A_ALBY, A_ALBZ, A_MPARAM };
// sweep SoA lanes (9, S), as ops/megakernel.py SWEEP_LANES
enum { L_CX, L_CY, L_CZ, L_DCX, L_DCY, L_DCZ, L_T0, L_IDT, L_NR2, kLanes };
// camera vector lanes, as ops/megakernel.py CAM_*
enum { CAM_OX, CAM_OY, CAM_OZ, CAM_LLX, CAM_LLY, CAM_LLZ, CAM_HX, CAM_HY,
       CAM_HZ, CAM_VX, CAM_VY, CAM_VZ, CAM_UX, CAM_UY, CAM_UZ, CAM_WX, CAM_WY,
       CAM_WZ, CAM_LENS, CAM_T0, CAM_T1, kCamLanes };

struct Params {
  const float* pixf;   // (n_tiles, 4, T): pixel i, pixel j, valid, pad
  const float* cam;    // (1, 128) camera vector
  const float* sph;    // (9, S) sweep SoA
  const float* attr;   // (24, S) attribute rows
  float* out;          // (n_tiles, 8 + n_iters, T)
  int n_tiles, T, S, n_iters;
  uint32_t seed;
  float spp, max_depth, rr_depth;  // rr_depth < 0: no roulette
  int exact, lens, bg_gradient, uniform_time;
  float inv_nx, inv_ny, t_min, ut_t0, ut_idt;
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

// Closest hit over every slot of the shared-memory table. Returns the
// winner slot (S on a miss) and its t in `best`.
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ int sweep(const Params& p, const float* sm,
                                     const Lane& L, float& best) {
  const int S = p.S;
  const float tmin = p.t_min;
  const float frac_u = kUniformTime ? (L.time - p.ut_t0) * p.ut_idt : 0.f;
  int bidx = S;
  best = kBig;
  for (int s = 0; s < S; ++s) {
    float cx = sm[L_CX * S + s];
    float cy = sm[L_CY * S + s];
    float cz = sm[L_CZ * S + s];
    if (kMoving) {
      const float fr = kUniformTime
                           ? frac_u
                           : (L.time - sm[L_T0 * S + s]) * sm[L_IDT * S + s];
      cx = fmaf(fr, sm[L_DCX * S + s], cx);  // exact on static axes (dc = 0)
      cy = fmaf(fr, sm[L_DCY * S + s], cy);
      cz = fmaf(fr, sm[L_DCZ * S + s], cz);
    }
    // sign-flipped half-b form with a = 1: co = c - o, nb = dot(co, d) = -b;
    // nr2 = -r^2 (+1 on padding rows, which then never hit) seeds cc
    const float cox = cx - L.ox, coy = cy - L.oy, coz = cz - L.oz;
    const float nb = fmaf(coz, L.dz, fmaf(cox, L.dx, coy * L.dy));
    const float cc =
        fmaf(cox, cox, fmaf(coy, coy, fmaf(coz, coz, sm[L_NR2 * S + s])));
    const float disc = fmaf(nb, nb, -cc);
    // disc < 0 and disc == 0 (0 * inf) both give NaN, and NaN is a miss
    const float sq = disc * rsqrtf(disc);
    const float tn = nb - sq, tf = nb + sq;
    const float t = tn > tmin ? tn : (tf > tmin ? tf : kBig);
    if (t < best) {  // strict: the first slot with the smallest t wins
      best = t;
      bidx = s;
    }
  }
  return bidx;
}

__device__ __forceinline__ float attr_at(const Params& p, int row, int slot) {
  return __ldg(p.attr + (size_t)row * p.S + slot);
}

// One bounce iteration of one lane. Returns the winner code (-1 for a miss
// or an idle lane, else the sphere slot).
template <bool kMoving, bool kUniformTime>
__device__ __forceinline__ int bounce(const Params& p, const float* sm,
                                      const Cam& cam, Lane& L, bool active,
                                      uint32_t tile, uint32_t lane,
                                      uint32_t it, float pxi, float pxj) {
  bool alive = false;
  int code = -1;
  float px = 0.f, py = 0.f, pz = 0.f, ndx = 0.f, ndy = 0.f, ndz = 0.f;
  if (active) {
    L.segs += 1.f;
    float best;
    const int bidx = sweep<kMoving, kUniformTime>(p, sm, L, best);
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

template <bool kMoving, bool kUniformTime>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kLanes * (size_t)p.S;
  auto kern = mega_kernel<kMoving, kUniformTime>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
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
  kern<<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the megakernel on `stream`. Returns cudaGetLastError() after the
// launch (0 on success): a launch the device refuses (too many threads or
// too much shared memory) reports here and nowhere else.
int rtw_mega_launch(const float* pixf, const float* cam, const float* sph,
                    const float* attr, float* out, int n_tiles, int T, int S,
                    int n_iters, int seed, int spp, int max_depth,
                    int rr_depth, int exact, int lens, int bg_gradient,
                    int moving, int uniform_time, float inv_nx, float inv_ny,
                    float t_min, float ut_t0, float ut_idt, void* stream) {
  if (n_tiles <= 0 || T <= 0 || S <= 0 || n_iters < 0 ||
      (!exact && T > 1024) || (exact && n_iters <= 0)) {
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
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (moving) {
    e = uniform_time ? launch<true, true>(p, s) : launch<true, false>(p, s);
  } else {
    e = launch<false, false>(p, s);
  }
  return (int)e;
}

const char* rtw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

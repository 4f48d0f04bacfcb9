// Forward megakernel for NVIDIA Hopper (sm_90a): the whole regenerating
// path-trace loop of a scene, one ray lane per thread at a time.
//
// Replaces: another_raytracer_tpu/ops/pallas/mega_kernel.py::_kernel,
// reached through trace_regenerative_mega, in both its modes and both its
// instances: sweep mode (K1 forward, K2 record: record_iters > 0, the primal
// of the fused differentiable path, ops/pallas/mega_diff.py) and accel mode
// (K3, forward and record: the scene's spheres in one BVH, walked in-kernel,
// mega_kernel.py:377-511 there).  Same inputs and outputs, same per-lane
// algorithm: camera ray (lens and shutter draws gated), threefry-2x32 draws
// keyed on (seed, bounce<<8|dim) x (pixel, sample), the closest hit with the
// strict `t < best_t` tie rule (the earlier row keeps a tie),
// branchless-equivalent lambertian / metal / dielectric / diffuse-light
// shading with solid / checker textures, and per-lane regeneration until the
// lane's sample budget is spent.  The closest hit is, per mode:
//   sweep: every world-baked row, sphere rows then rect rows;
//   accel: a stackless walk of the sphere tree over its escape indices.
//
// Sweep mode reads compact tables (the wrapper's pack_sweep_tables): a
// sphere as 3 float4 (c0.xyz, r | c1 - c0, t0 | 1/dt, 0, 0, 0), a rect as 4
// (n.xyz, n.q0 | q0.xyz, |eu|^2 | eu.xyz, |ev|^2 | ev.xyz, 0), spheres
// first: at most 64 rows, 4 KB, which each block copies into shared memory
// once.  Every thread of a warp reads the same row in the same step, so each
// 16-byte load is a broadcast: a rect test takes 4 shared loads where the
// 32-float rows took 15.  The tests are the plain version's operation for
// operation on the same float values; the winner's normal is computed once
// after the sweep, and its material columns are read from the widened rows
// in device memory, as in accel mode.
//
// Lane fetch (K1, the sweep's forward instance, and its counting instance):
// the grid is persistent (as many blocks as the card holds at once) and each
// thread takes lanes from a counter in device memory that the launch zeroes,
// one warp-aggregated atomicAdd per group of threads that fetch together.  A
// thread fetches its next lane in the same loop step in which its lane has
// spent its samples, so no thread waits for its warp's slowest pixel and no
// SM slot for its block's slowest warp; only the last lanes leave a tail.
// Each lane still runs the per-lane algorithm below and writes its own
// outputs, so the outputs are those of one lane per thread bit for bit (the
// wrapper can launch either).  The record instance (K2) keeps one lane per
// thread: its rows are coalesced because a warp's lanes write the same row
// together, and at the bench size its lanes fit the card in one wave.  K3
// keeps it too: its walk wants Morton-neighbour lanes to enter together.
//
// Accel mode (template argument WALK; everything else is the same code).
// The TPU kernel walks a block of lanes with ONE cursor (packet DFS): at node
// j every lane runs the slab test, the block enters the subtree if any lane
// hit the box, and a lane's leaf tests are masked by its own box test.
// Child boxes nest inside their parents and a lane's best t only shrinks, so
// a lane that missed a box misses every box below it: the leaves a lane
// tests, and their order, are those of its own walk.  Here each thread walks
// on its own (the BVH kernel's design, csrc/bvh_kernel.cu): on a box hit it
// goes to j + 1 and tests a leaf's rows in leaf order, on a miss it jumps to
// the escape index.  The TPU kernel folds the winner's material columns at
// every improvement (it has no gathers); here the walk keeps the winner's row
// index and the shading reads its columns once, which is the same result.
// The sphere test, the slab test from [t_min, best_t] and 1/r = 1/(r != 0 ?
// r : 1) are K3's arithmetic.  The winner's hit point and normal are not
// K3's o + t d and (o + t d - c) / r: in every instance a sphere winner is
// re-projected onto its sphere (onto_sphere), as the port's wavefront
// re-projects it (ops/intersect.py _onto_sphere).
//
// The walk reads compact tables (the wrapper's pack_accel_tables): a node
// as 2 float4 (lo.xyz, escape | hi.xyz, meta), a sphere as 3 (c0.xyz, r |
// c1 - c0, t0 | 1/dt, 0, 0, 0), nodes first.  Where they fit in a block's
// shared memory (the random scene: 55 x 32 + 903 x 48 = 45,104 B) each block
// copies them there once with 16-byte loads and the walk reads them with
// 16-byte shared loads (WALK = ACCEL_SHARED); larger trees (up to
// ACCEL_MAX_ROWS = 8192 rows, ~393 KB) are read by the same walk from device
// memory through 16-byte read-only loads (ACCEL_GLOBAL).  The wrapper picks
// by size.  The material columns stay in the widened rows ([N+pad][32]) in
// device memory: shading reads the winner's columns 16-27 once per segment
// as 3 float4.
//
// Postponed leaves (the while-while traversal of Aila & Laine, HPG 2009):
// a lane advances over inner nodes on its own until it stands on a leaf
// whose box it hit, or its walk has ended; the warp tests leaves only when
// every lane that entered the walk together holds a leaf or has finished
// (__any_sync), and then every leaf-holding lane tests its leaf at once.  A
// lane's slab test after a leaf depends on the best t that leaf left, so it
// cannot run ahead: each lane visits the same nodes and tests the same rows
// in the same order as a plain per-lane walk, which keeps winners, t bits
// and counts; what goes is the divergence between slab steps and 32-row
// leaf loops inside a warp.
//
// The counting build (-DART_COUNT -fmad=false: the record build's
// arithmetic, so its paths are the plain version's) tallies per launch the
// slab and sphere tests, the active-lane share of the warp's slab and leaf
// steps (sum of popc(__activemask()) over warp steps / 32 x warp steps), the
// sphere tests in the leaf that holds one given sphere (the ground), in
// sweep mode its sphere and rect row tests, in both modes the warp steps of
// the lane loop with their active lanes and the most of one warp, and each
// block's start and end %globaltimer (the wrapper's tail_share reads how
// much SM-slot time the launch's tail left idle).
//
// What bounds it on this card: instruction issue, not memory.  A lane reads
// 8 bytes and writes 16; everything else (ray state, the 13-round threefry,
// an ~25-flop test per row per segment, the shading math) lives in registers,
// and the sweep's tables (at most 4 KB) in shared memory.
// The costs are ALU work per segment, warp divergence (a warp runs until its
// slowest lane has spent its samples, and lanes of a warp take different
// material branches), and registers per thread, which set how many warps an
// SM keeps in flight to hide latency.
//
// In accel mode add the walk's latency: each node visit is a dependent
// chain (load the node, test the box, pick the next node) and the lanes of a
// warp diverge to other nodes; shared memory shortens each link of that
// chain, and postponed leaves keep a warp's lanes together in the leaf
// loops, where most of the walk's arithmetic is.
//
// What the design does about it: state never leaves registers; every thread
// of a warp reads the same row in the same sweep step, so shared-memory reads
// are broadcasts (in accel mode the renders trace in Morton order, so a
// warp's lanes are neighbouring pixels whose walks mostly coincide); a lane
// whose path ends re-arms with its next sample at once
// (the TPU kernel's per-lane regeneration), and in K1 a thread whose lane is
// spent takes the next lane at once (lane fetch), so divergence is confined
// to the tail of the launch; random draws and shading branches that a lane
// does not need are skipped, which is exact because each draw is a pure
// function of its key and counter, and the lens and the scatter take sin and
// cos of one angle with one range reduction.  The block is 128 threads for
// every instance, measured for K1 and K3 against 64-512 (chip_smoke.py,
// PERF.md); at 128 K3's 45 KB of shared tables, not its registers, cap an
// SM's blocks.
//
// Record mode (K2, and K3's record instance) is the same kernel compiled with
// the compile-time constant RECORD set, so the forward instances keep their
// registers and their time and only the record instances pay for the
// residual writes.  The file is built three times (ops/kernels/_build.py):
// as is, for the forward instances (art_mega_forward, art_threefry_words,
// and art_uniform2: the tensor paths' draws, ops/kernels/threefry_kernel.py),
// with -DART_RECORD -fmad=false for the record instances (art_mega_record),
// and with -DART_COUNT -fmad=false for the counting instances
// (art_mega_count, a measurement: the port's paths never launch it).  The
// record build contracts no a*b+c into an FMA and takes sin and cos in double
// (correctly rounded float results) and rsqrt as 1/sqrt: those are the plain
// version's ops, so its recorded paths are the plain version's bit for bit
// (the accel walk's tests are the plain walk's, ops/bvh.py, operation for
// operation), where FMA contraction alone flipped
// the path of ~5% of the lanes at the bench size (measured on the H100,
// against ~17% more K2 time).  Per lane and loop iteration it writes one
// int32 code tid*16 + checker_odd*8 + chain_end*4 + event (event 0 idle or
// metal absorption, 1 scatter, 2 light hit, 3 miss; tid the winner's texture
// id, n_textures for a dielectric scatter) and the three channels of the
// iteration-entry throughput.  Row i is the lane's own i-th loop iteration,
// which is the TPU kernel's block-level iteration i (a lane steps once per
// block iteration from iteration 0 until it is dead).  Layout [iters, B]
// row-major, so a warp's writes for one iteration are contiguous; rows past
// the lane's end are written as zeros.  At the bench size (97,200 lanes x 128
// iterations x 16 B) that is 199 MB of device memory, written once: the
// TPU's 4 MB VMEM block cap does not apply here.
//
// Numerics: IEEE division and sqrt and full-range sinf/cosf (no fast math).
// In the forward build nvcc contracts a*b+c into FMA, so results agree with
// the plain PyTorch version (trace_regenerative_mega_reference) to a
// tolerance, not bit for bit; the threefry words agree bit for bit
// (art_threefry_words).  The record build: see above.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (another_raytracer_tpu_torch/ops/kernels/_build.py)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROW_W = 32;
constexpr int MAX_ROWS = 64;
constexpr int META_SCALE = 64;  // node meta = first * 64 + count
constexpr float BIG = 3e37f;
constexpr float NEAR_ZERO_EPS = 1e-8f;
// A component whose square sums without overflow (intersect.SQUARE_MAX).
constexpr float SQUARE_MAX = 1e18f;
constexpr float TWO_PI = 6.2831853071795864769f;
constexpr int ROUNDS = 13;

// Row columns shared by both primitive kinds (mega_kernel.py:75-77).
constexpr int C_MKIND = 16, C_FUZZ = 17, C_IR = 18, C_TKIND = 19;
constexpr int C_CA = 20, C_CB = 23;
constexpr int C_TID = 26;  // texture id (exact in f32)

constexpr float MAT_METAL = 1.0f, MAT_DIELECTRIC = 2.0f, MAT_DIFFUSE_LIGHT = 3.0f;
constexpr float TEX_CHECKER = 1.0f;

constexpr uint32_t CAMERA_BOUNCE = 0xFF00u;
constexpr uint32_t DIM_PIXEL_JITTER = 0, DIM_LENS = 2, DIM_TIME = 4;
constexpr uint32_t DIM_SCATTER_A = 0, DIM_SCATTER_B = 2;

#ifdef ART_RECORD
constexpr bool RECORD = true;
#else
constexpr bool RECORD = false;
#endif
#ifdef ART_COUNT
constexpr bool COUNT = true;
#else
constexpr bool COUNT = false;
#endif
// The record and counting builds take the plain version's transcendentals.
constexpr bool EXACT = RECORD || COUNT;

enum Flags : int {
  HAS_LENS = 1, HAS_TIME = 2, HAS_METAL = 4, HAS_DIEL = 8, HAS_LIGHT = 16,
  HAS_CHECKER = 32,
};

// The closest hit of each kernel instance: the sweep (K1, K2), or K3's walk
// with its compact tables in shared memory or in device memory.
enum Walk : int { SWEEP = 0, ACCEL_SHARED = 1, ACCEL_GLOBAL = 2 };

// Float4s per node and per sphere of the compact tables (both modes), and
// per rect of the sweep's tables.
constexpr int NODE_F4 = 2, SPHERE_F4 = 3, RECT_F4 = 4;
// Shared memory one block may take on sm_90 after opting in.
constexpr int MAX_SMEM = 232448;

// Camera constants, the layout of the wrapper's 24-float pack
// (mega_kernel.py:794-799): o, lower_left - o, horizontal, vertical, u, v,
// lens_radius, time0, time1 - time0, background.
struct CamConst {
  float o[3], base[3], h[3], v[3], u[3], w[3];
  float lens_radius, time0, time_del;
  float bg[3];
};

struct Params {
  CamConst cam;
  float inv_w1, inv_h1, h1, t_min;
  uint32_t seed, limit, stride;
  int width, n, n_spheres, n_rects, max_depth, flags;
  // The compact tables in device memory.  Accel mode: n_nodes nodes, then
  // n_spheres leaf-order spheres, and the bytes of shared memory a block
  // copies them into (0: the walk reads them from device memory).  Sweep:
  // n_spheres spheres, then n_rects rects, copied into shared memory.
  const float4* tab;
  int n_nodes, leaf_size, smem_bytes;
  // Sweep forward and counting instances: the lane counter of lane fetch
  // (null: one lane per thread, lane = global thread index).
  int* next;
  // Forward instances: the sphere hits of the launch, added to (null: not
  // counted, as on a scene without spheres).
  unsigned long long* sphere_hits;
};

// Residual outputs of the record instance: codes [iters][n] int32 and
// tprev [3][iters][n] f32, both device memory.
struct Record {
  int* codes;
  float* tprev;
  int iters, n_textures;
};

// Output of the counting instance: TALLIES u64 totals (device memory, added
// to), the node of the leaf whose sphere tests are tallied apart, and per
// block its start and end %globaltimer (ns; null: not recorded).
struct Tallies {
  unsigned long long* out;
  int ground_node;
  unsigned long long* times;
};
// Per-thread tallies, summed into Tallies::out in this order (then the
// largest loop-step count of one warp, TALLY_WARP_MAX).  A warp step is
// tallied by the lowest active lane only.  spheres counts sphere tests in
// either mode (the walk's leaves, or the sweep's sphere rows), rects the
// sweep's rect rows, loop_steps / loop_active the warp's steps of the lane
// loop (one closest hit and its shading each) and their active lanes.
struct Tally {
  unsigned long long slabs, spheres, slab_steps, slab_active, leaf_steps,
      leaf_active, ground, rects, loop_steps, loop_active;
};
constexpr int TALLIES = 10, TALLY_WARP_MAX = 10;

#include "threefry.cuh"

// The transcendentals of each build (see the header).
__device__ __forceinline__ float sin_(float x) {
  if constexpr (EXACT) return (float)sin((double)x);
  else return sinf(x);
}
// sin and cos of one angle with one range reduction (the same values as
// sin_ and cos_).
__device__ __forceinline__ void sincos_(float x, float& s, float& c) {
  if constexpr (EXACT) {
    double sd, cd;
    sincos((double)x, &sd, &cd);
    s = (float)sd;
    c = (float)cd;
  } else {
    sincosf(x, &s, &c);
  }
}
__device__ __forceinline__ float rsqrt_(float x) {
  if constexpr (EXACT) return 1.0f / sqrtf(x);
  else return rsqrtf(x);
}

// camera.generate_rays as the TPU kernel inlines it (mega_kernel.py:310-335).
__device__ __forceinline__ void cam_rays(const Params& p, uint32_t pix,
                                         uint32_t sample, float fi, float fj,
                                         float o[3], float d[3], float& tm) {
  const CamConst& c = p.cam;
  float ju, jv;
  uniform2(p.seed, pix, sample, CAMERA_BOUNCE, DIM_PIXEL_JITTER, ju, jv);
  const float s = (fi + ju) * p.inv_w1;
  const float t = (p.h1 - fj + jv) * p.inv_h1;
  if (p.flags & HAS_LENS) {
    float lu, lv;
    uniform2(p.seed, pix, sample, CAMERA_BOUNCE, DIM_LENS, lu, lv);
    const float rr = sqrtf(lu);
    const float phi = TWO_PI * lv;
    float sp, cp;
    sincos_(phi, sp, cp);
    const float rdx = c.lens_radius * (rr * cp);
    const float rdy = c.lens_radius * (rr * sp);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float offs = c.u[k] * rdx + c.w[k] * rdy;
      o[k] = offs + c.o[k];
      d[k] = c.base[k] + c.h[k] * s + c.v[k] * t - offs;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = c.o[k];
      d[k] = c.base[k] + c.h[k] * s + c.v[k] * t;
    }
  }
  if (p.flags & HAS_TIME) {
    float tu, unused;
    uniform2(p.seed, pix, sample, CAMERA_BOUNCE, DIM_TIME, tu, unused);
    tm = c.time0 + tu * c.time_del;
  } else {
    tm = c.time0;
  }
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Products and sums rounded one at a time (__fmul_rn, __fadd_rn), which
// nvcc may not contract into FMA.  K3's walk (its sphere tests, the winner's normal and |d|^2) uses
// them in every build: FMA contraction there moved the forward build beyond
// the test_mega bar on a dense grid of touching spheres on the radius-1000
// ground (on its surface |o - c|^2 - r^2 cancels ~6 digits, and where it
// rounds decides whether a scattered ray hits its own sphere again), while
// the record build, which contracts nothing, matched its plain version.
// a.b in the plain version's order, ((ax bx + ay by) + az bz).
__device__ __forceinline__ float dot3_rn(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// Table reads of the accel walk: shared memory, or device memory through
// the read-only cache.
template <bool SHARED>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (SHARED) return *p;
  else return __ldg(p);
}
template <bool SHARED>
__device__ __forceinline__ float ld1(const float4* p) {
  if constexpr (SHARED) return p->x;
  else return __ldg(reinterpret_cast<const float*>(p));
}

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = c < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(c) < 1e-20f ? tiny : c);
}

// The moving sphere's centre at time tm from its compact rows (c0.xyz, r |
// c1 - c0, t0 | 1/dt, ...).
__device__ __forceinline__ void sphere_center(const float4& g0,
                                              const float4& g1, float inv_dt,
                                              float tm, float c[3]) {
  const float frac = (tm - g1.w) * inv_dt;
  c[0] = g0.x + frac * g1.x;
  c[1] = g0.y + frac * g1.y;
  c[2] = g0.z + frac * g1.z;
}

// The sphere winner's normal and hit point (intersect._onto_sphere): the
// offset off = o + t d - c of o + t d from the centre c at the ray's time,
// rescaled to |r| (off * |r| / |off|) unless it is zero or too long to
// square; the normal on * inv_r and the point (o + t d) + (on - off), the
// form of intersect's records, which is o + t d itself wherever on is off.
// Rounded one operation at a time in every build, as the plain version
// rounds them, so the record and counting builds equal it bit for bit.
__device__ __forceinline__ void onto_sphere(const float o[3], const float d[3],
                                            float t, const float c[3],
                                            float r, float inv_r, float bn[3],
                                            float hp[3]) {
  float p[3], off[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = __fadd_rn(o[k], __fmul_rn(t, d[k]));
    off[k] = __fsub_rn(p[k], c[k]);
  }
  const bool fits = fabsf(off[0]) < SQUARE_MAX &&
                    fabsf(off[1]) < SQUARE_MAX && fabsf(off[2]) < SQUARE_MAX;
  const float len2 = dot3_rn(off[0], off[1], off[2], off[0], off[1], off[2]);
  const bool ok = fits && len2 > 0.0f;
  const float scale = __fdiv_rn(fabsf(r), __fsqrt_rn(ok ? len2 : 1.0f));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float on = ok ? __fmul_rn(off[k], scale) : off[k];
    bn[k] = __fmul_rn(on, inv_r);
    hp[k] = __fadd_rn(p[k], __fsub_rn(on, off[k]));
  }
}

// Sweep mode: every row of the shared-memory tables (pack_sweep_tables),
// spheres then rects, each read with 16-byte broadcast loads.  Returns the
// winner's row (-1 on a miss), its t in best_t, its normal and its hit
// point, computed once for the winner.
__device__ __forceinline__ int sweep_hit(const Params& p,
                                         const float4* __restrict__ tab,
                                         const float o[3], const float d[3],
                                         float tm, float a_len, float& best_t,
                                         float bn[3], float hp[3], Tally& tl) {
  int best = -1;
  if constexpr (COUNT) {
    tl.spheres += p.n_spheres;
    tl.rects += p.n_rects;
  }
  if (p.n_spheres) {
    const float inv_a = 1.0f / (a_len > 0.0f ? a_len : 1.0f);
    for (int j = 0; j < p.n_spheres; ++j) {
      const float4* s = tab + SPHERE_F4 * j;
      const float4 g0 = s[0], g1 = s[1];
      float c3[3];
      sphere_center(g0, g1, s[2].x, tm, c3);
      const float ocx = o[0] - c3[0], ocy = o[1] - c3[1], ocz = o[2] - c3[2];
      const float half_b = ocx * d[0] + ocy * d[1] + ocz * d[2];
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - g0.w * g0.w;
      const float disc = half_b * half_b - a_len * c;
      if (!(disc > 0.0f)) continue;
      const float sq = sqrtf(disc);
      const float root1 = (-half_b - sq) * inv_a;
      const float t = (root1 > p.t_min && root1 < best_t)
                          ? root1 : (-half_b + sq) * inv_a;
      if (t > p.t_min && t < best_t) {
        best_t = t;
        best = j;
      }
    }
  }
  const float4* rects = tab + SPHERE_F4 * p.n_spheres;
  for (int j = 0; j < p.n_rects; ++j) {
    // World parallelogram == aarect.cpp plane + inclusive bounds:
    // (n.xyz, n.q0 | q0.xyz, |eu|^2 | eu.xyz, |ev|^2 | ev.xyz, 0).
    const float4* q = rects + RECT_F4 * j;
    const float4 g0 = q[0];
    const float ndotd = g0.x * d[0] + g0.y * d[1] + g0.z * d[2];
    if (ndotd == 0.0f) continue;
    const float ndoto = g0.x * o[0] + g0.y * o[1] + g0.z * o[2];
    const float t = (g0.w - ndoto) / ndotd;
    const float4 g1 = q[1], g2 = q[2], g3 = q[3];
    const float rx = o[0] + t * d[0] - g1.x;
    const float ry = o[1] + t * d[1] - g1.y;
    const float rz = o[2] + t * d[2] - g1.z;
    const float a = rx * g2.x + ry * g2.y + rz * g2.z;
    const float b = rx * g3.x + ry * g3.y + rz * g3.z;
    if (a >= 0.0f && a <= g1.w && b >= 0.0f && b <= g2.w &&
        t > p.t_min && t < best_t) {
      best_t = t;
      best = p.n_spheres + j;
    }
  }
  if (best >= p.n_spheres) {
    const float4 g0 = rects[RECT_F4 * (best - p.n_spheres)];
    bn[0] = g0.x;
    bn[1] = g0.y;
    bn[2] = g0.z;
#pragma unroll
    for (int k = 0; k < 3; ++k) hp[k] = o[k] + best_t * d[k];
  } else if (best >= 0) {
    // Sphere winner: re-projected onto its sphere at the ray's time.
    const float4* s = tab + SPHERE_F4 * best;
    const float4 g0 = s[0];
    float c3[3];
    sphere_center(g0, s[1], s[2].x, tm, c3);
    onto_sphere(o, d, best_t, c3, g0.w, 1.0f / g0.w, bn, hp);
  }
  return best;
}

// The lowest active lane tallies one warp step of `active` lanes; returns
// whether this thread tallied it.
__device__ __forceinline__ bool warp_step(unsigned long long& steps,
                                          unsigned long long& active) {
  const unsigned m = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
    ++steps;
    active += __popc(m);
    return true;
  }
  return false;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Lane fetch: the next lane of the launch's counter for each thread that
// calls it, one atomicAdd per group of threads that call it together (the
// group's base index shared by __shfl_sync, each thread's offset its rank in
// the group).
__device__ __forceinline__ int fetch_lane(int* next) {
  const unsigned m = __activemask();
  const int me = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (me == leader) base = atomicAdd(next, __popc(m));
  base = __shfl_sync(m, base, leader);
  return base + __popc(m & ((1u << me) - 1u));
}

// Slab test of a node (a: lo.xyz, escape | b: hi.xyz, meta) from
// [t_min, best_t].
__device__ __forceinline__ bool slab_hit(const float4& a, const float4& b,
                                         const float o[3], float ix, float iy,
                                         float iz, float t_min, float best_t) {
  float tn = t_min, tf = best_t;
  {
    const float u = (a.x - o[0]) * ix, v = (b.x - o[0]) * ix;
    tn = fmaxf(tn, fminf(u, v));
    tf = fminf(tf, fmaxf(u, v));
  }
  {
    const float u = (a.y - o[1]) * iy, v = (b.y - o[1]) * iy;
    tn = fmaxf(tn, fminf(u, v));
    tf = fminf(tf, fmaxf(u, v));
  }
  {
    const float u = (a.z - o[2]) * iz, v = (b.z - o[2]) * iz;
    tn = fmaxf(tn, fminf(u, v));
    tf = fminf(tf, fmaxf(u, v));
  }
  return tn < tf;
}

// A leaf's spheres (meta = first * 64 + count) in leaf order, the strict
// `t < best_t` rule keeping the earlier row on a tie.
template <bool SHARED>
__device__ __forceinline__ void leaf_test(const Params& p,
                                          const float4* __restrict__ geo,
                                          int meta, const float o[3],
                                          const float d[3], float tm,
                                          float a_len, float inv_a,
                                          float& best_t, int& best,
                                          Tally& tl) {
  const int count = min(meta % META_SCALE, p.leaf_size);
  const int first = meta / META_SCALE;
  if constexpr (COUNT) tl.spheres += count;
  for (int k = 0; k < count; ++k) {
    if constexpr (COUNT) warp_step(tl.leaf_steps, tl.leaf_active);
    const int row = min(first + k, p.n_spheres - 1);
    const float4* s = geo + SPHERE_F4 * row;
    const float4 g0 = ld4<SHARED>(s), g1 = ld4<SHARED>(s + 1);
    const float frac = (tm - g1.w) * ld1<SHARED>(s + 2);
    const float ocx = o[0] - __fadd_rn(g0.x, __fmul_rn(frac, g1.x));
    const float ocy = o[1] - __fadd_rn(g0.y, __fmul_rn(frac, g1.y));
    const float ocz = o[2] - __fadd_rn(g0.z, __fmul_rn(frac, g1.z));
    const float rad = g0.w;
    const float half_b = dot3_rn(ocx, ocy, ocz, d[0], d[1], d[2]);
    const float c = __fsub_rn(dot3_rn(ocx, ocy, ocz, ocx, ocy, ocz),
                              __fmul_rn(rad, rad));
    const float disc =
        __fsub_rn(__fmul_rn(half_b, half_b), __fmul_rn(a_len, c));
    if (!(disc > 0.0f)) continue;
    const float sq = sqrtf(disc);
    const float root1 = (-half_b - sq) * inv_a;
    const float t = (root1 > p.t_min && root1 < best_t)
                        ? root1 : (-half_b + sq) * inv_a;
    if (t > p.t_min && t < best_t) {
      best_t = t;
      best = row;
    }
  }
}

// Accel mode: the stackless walk of the sphere tree over the compact tables
// (mega_kernel.py:384-500 there), with leaves postponed warp-wide.  Returns
// the winner's leaf-order row (-1 on a miss), its t in best_t, its normal
// and its hit point.
template <int WALK>
__device__ __forceinline__ int accel_hit(const Params& p,
                                         const float4* __restrict__ tab,
                                         const float o[3], const float d[3],
                                         float tm, float a_len, float& best_t,
                                         float bn[3], float hp[3], Tally& tl,
                                         int ground_node) {
  constexpr bool SH = WALK == ACCEL_SHARED;
  const float4* nodes = tab;
  const float4* geo = tab + NODE_F4 * p.n_nodes;
  const float ix = safe_inv(d[0]), iy = safe_inv(d[1]), iz = safe_inv(d[2]);
  const float inv_a = 1.0f / (a_len > 0.0f ? a_len : 1.0f);
  int best = -1;
  int j = 0;
  // The lanes that entered the walk together; each goes round the outer loop
  // until none of them holds a leaf, so all of them meet at every __any_sync.
  const unsigned warp = __activemask();
  while (true) {
    int leaf = -1, meta = 0;
    while (j < p.n_nodes) {
      if constexpr (COUNT) {
        ++tl.slabs;
        warp_step(tl.slab_steps, tl.slab_active);
      }
      const float4 a = ld4<SH>(nodes + NODE_F4 * j);
      const float4 b = ld4<SH>(nodes + NODE_F4 * j + 1);
      if (!slab_hit(a, b, o, ix, iy, iz, p.t_min, best_t)) {
        j = (int)a.w;
        continue;
      }
      const int m = (int)b.w;
      if (m % META_SCALE) {
        leaf = j++;
        meta = m;
        break;
      }
      ++j;
    }
    if (!__any_sync(warp, leaf >= 0)) break;
    if (leaf >= 0) {
      if constexpr (COUNT) {
        if (leaf == ground_node) tl.ground += min(meta % META_SCALE,
                                                  p.leaf_size);
      }
      leaf_test<SH>(p, geo, meta, o, d, tm, a_len, inv_a, best_t, best, tl);
    }
  }
  if (best >= 0) {
    // The winner re-projected onto its sphere; 1/r as K3 takes it
    // (mega_kernel.py:462-465 there).
    const float4* s = geo + SPHERE_F4 * best;
    const float4 g0 = ld4<SH>(s), g1 = ld4<SH>(s + 1);
    const float frac = (tm - g1.w) * ld1<SH>(s + 2);
    const float inv_r = 1.0f / (g0.w != 0.0f ? g0.w : 1.0f);
    const float c[3] = {__fadd_rn(g0.x, __fmul_rn(frac, g1.x)),
                        __fadd_rn(g0.y, __fmul_rn(frac, g1.y)),
                        __fadd_rn(g0.z, __fmul_rn(frac, g1.z))};
    onto_sphere(o, d, best_t, c, g0.w, inv_r, bn, hp);
  }
  return best;
}

// The winner's material columns 16-27 of the widened rows, read from device
// memory once as 3 float4.  Indexed by compile-time column numbers.
struct Mat {
  float4 q[3];
  __device__ __forceinline__ Mat(const float* rows, int best) {
    const float4* r =
        reinterpret_cast<const float4*>(rows + (size_t)best * ROW_W + C_MKIND);
    q[0] = __ldg(r);
    q[1] = __ldg(r + 1);
    q[2] = __ldg(r + 2);
  }
  __device__ __forceinline__ float operator[](int c) const {
    const float4& v = q[(c - C_MKIND) >> 2];
    switch (c & 3) {
      case 0: return v.x;
      case 1: return v.y;
      case 2: return v.z;
      default: return v.w;
    }
  }
};

template <int WALK>
__global__ void mega_forward_kernel(const float* __restrict__ rows_g,
                                    const uint32_t* __restrict__ pixel_ids,
                                    const uint32_t* __restrict__ sample_ids0,
                                    const Params p,
                                    float* __restrict__ out_x,
                                    float* __restrict__ out_y,
                                    float* __restrict__ out_z,
                                    int* __restrict__ out_seg,
                                    const Record rec, const Tallies tly) {
  constexpr bool ACCEL = WALK != SWEEP;
  // Lane fetch: only the sweep's forward and counting instances take it.
  constexpr bool CAN_FETCH = WALK == SWEEP && !RECORD;
  // The compact tables, copied into shared memory (the sweep and
  // ACCEL_SHARED) or read from device memory (ACCEL_GLOBAL); rows_g holds
  // the widened rows' material columns.
  const float4* tab;
  if constexpr (WALK == ACCEL_SHARED) {
    extern __shared__ float4 tab_s[];
    const int n4 = NODE_F4 * p.n_nodes + SPHERE_F4 * p.n_spheres;
    for (int k = threadIdx.x; k < n4; k += blockDim.x) tab_s[k] = p.tab[k];
    tab = tab_s;
  } else if constexpr (WALK == SWEEP) {
    __shared__ float4 sweep_s[MAX_ROWS * RECT_F4];
    const int n4 = SPHERE_F4 * p.n_spheres + RECT_F4 * p.n_rects;
    for (int k = threadIdx.x; k < n4; k += blockDim.x) sweep_s[k] = p.tab[k];
    tab = sweep_s;
  } else {
    tab = p.tab;
  }
  // Counting instance: each warp's loop steps and the block's start time.
  __shared__ unsigned long long warp_loops[COUNT ? 32 : 1];
  unsigned long long t_start = 0;
  if constexpr (COUNT) {
    if (threadIdx.x < 32) warp_loops[threadIdx.x] = 0;
    t_start = global_ns();
  }
  if constexpr (WALK != ACCEL_GLOBAL || COUNT) __syncthreads();
  Tally tl{};

  const bool has_metal = p.flags & HAS_METAL;
  const bool has_diel = p.flags & HAS_DIEL;
  const bool has_light = p.flags & HAS_LIGHT;
  const bool has_checker = p.flags & HAS_CHECKER;
  const bool need_b_draw = has_metal || has_diel;
  const bool fetch = CAN_FETCH && p.next != nullptr;

  // The next fetched lane whose first sample is alive; lanes born dead on
  // the way get their outputs (zeros) here.
  auto next_live_lane = [&]() {
    int l = fetch_lane(p.next);
    while (l < p.n && !(sample_ids0[l] < p.limit)) {
      out_x[l] = out_y[l] = out_z[l] = 0.0f;
      out_seg[l] = 0;
      l = fetch_lane(p.next);
    }
    return l;
  };
  int lane = fetch ? next_live_lane() : blockIdx.x * blockDim.x + threadIdx.x;
  // Forward instances: this thread's sphere hits (every lane it ran).
  uint32_t n_sphere_hits = 0;

  if (lane < p.n) {
    uint32_t pix, sample;
    float fi, fj, o[3], d[3], tm, tp[3], path[3], acc[3];
    uint32_t bounce;
    int seg, it;  // it: this lane's loop iteration (record row)
    bool alive;
    // A lane's first camera ray and carry.
    auto start = [&](int l) {
      pix = pixel_ids[l];
      sample = sample_ids0[l];
      fi = (float)(pix % (uint32_t)p.width);
      fj = (float)(pix / (uint32_t)p.width);
      cam_rays(p, pix, sample, fi, fj, o, d, tm);
      alive = sample < p.limit;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        tp[k] = 1.0f;
        path[k] = acc[k] = 0.0f;
      }
      bounce = 0;
      seg = alive ? 1 : 0;
      it = 0;
    };
    // A lane's outputs once its samples are spent.
    auto finish = [&](int l) {
      out_x[l] = acc[0];
      out_y[l] = acc[1];
      out_z[l] = acc[2];
      out_seg[l] = seg;
      if constexpr (RECORD) {
        // Rows past this lane's end are zero (idle rows: the replay skips
        // them).
        const size_t plane = (size_t)rec.iters * p.n;
        for (; it < rec.iters; ++it) {
          const size_t row = (size_t)it * p.n + l;
          rec.codes[row] = 0;
          rec.tprev[row] = 0.0f;
          rec.tprev[plane + row] = 0.0f;
          rec.tprev[2 * plane + row] = 0.0f;
        }
      }
    };
    start(lane);

    while (alive) {
      if constexpr (COUNT) {
        if (warp_step(tl.loop_steps, tl.loop_active)) {
          atomicAdd(&warp_loops[threadIdx.x >> 5], 1ull);
        }
      }
      // K3's walk rounds like the plain version in every build (see
      // dot3_rn); the sweep's forward build may contract FMA.
      const float a_len = ACCEL ? dot3_rn(d[0], d[1], d[2], d[0], d[1], d[2])
                                : dot3(d, d);
      // Record instance only: entry throughput and the row's code parts.
      float tp_entry[3];
      int ev = 0, tid = 0;
      bool odd = false;
      if constexpr (RECORD) {
        tp_entry[0] = tp[0];
        tp_entry[1] = tp[1];
        tp_entry[2] = tp[2];
      }

      // ---- closest hit (strict improvement keeps the earlier row on ties)
      float best_t = BIG;
      float bn[3] = {0.0f, 0.0f, 0.0f}, hp[3];
      int best;
      if constexpr (ACCEL) {
        best = accel_hit<WALK>(p, tab, o, d, tm, a_len, best_t, bn, hp, tl,
                               tly.ground_node);
      } else {
        best = sweep_hit(p, tab, o, d, tm, a_len, best_t, bn, hp, tl);
      }
      if constexpr (!RECORD && !COUNT) {
        if (best >= 0 && (ACCEL || best < p.n_spheres)) ++n_sphere_hits;
      }

      bool scattered = false;
      if (best < 0) {
        // Miss: the background, weighted by the throughput.
#pragma unroll
        for (int k = 0; k < 3; ++k) path[k] = path[k] + tp[k] * p.cam.bg[k];
        if constexpr (RECORD) ev = 3;
      } else {
        // ---- shade + scatter (shade.emit_and_scatter) ----------------------
        const Mat r(rows_g, best);
        const bool front = dot3(bn, d) < 0.0f;
        float n[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) n[k] = front ? bn[k] : -bn[k];
        const float mk = r[C_MKIND];
        float alb[3] = {r[C_CA], r[C_CA + 1], r[C_CA + 2]};
        if constexpr (RECORD) tid = (int)r[C_TID];
        if (has_checker && r[C_TKIND] == TEX_CHECKER) {
          const float sines = sin_(10.0f * hp[0]) * sin_(10.0f * hp[1]) *
                              sin_(10.0f * hp[2]);
          if (sines < 0.0f) {
            alb[0] = r[C_CB];
            alb[1] = r[C_CB + 1];
            alb[2] = r[C_CB + 2];
            if constexpr (RECORD) odd = true;
          }
        }

        if (has_light && mk == MAT_DIFFUSE_LIGHT) {
          // Emits and absorbs: the path ends here.
#pragma unroll
          for (int k = 0; k < 3; ++k) path[k] = path[k] + tp[k] * alb[k];
          if constexpr (RECORD) ev = 2;
        } else {
          float u1, u2, u3 = 0.0f, u4 = 0.0f;
          uniform2(p.seed, pix, sample, bounce, DIM_SCATTER_A, u1, u2);
          if (need_b_draw) uniform2(p.seed, pix, sample, bounce, DIM_SCATTER_B, u3, u4);
          const float zz = 1.0f - 2.0f * u1;
          const float rr = sqrtf(fmaxf(0.0f, 1.0f - zz * zz));
          const float phi = TWO_PI * u2;
          float sp, cp;
          sincos_(phi, sp, cp);
          const float ru[3] = {rr * cp, rr * sp, zz};

          float new_d[3];
          float att[3] = {alb[0], alb[1], alb[2]};
          bool ok = true;
          if (has_metal && mk == MAT_METAL) {
            // material.h:49-56 with a fuzzed mirror direction.
            const float inv_len = rsqrt_(a_len > 0.0f ? a_len : 1.0f);
            const float ud[3] = {d[0] * inv_len, d[1] * inv_len, d[2] * inv_len};
            const float cr = u3 > 0.0f
                ? expf(logf(fmaxf(u3, 1e-38f)) * (1.0f / 3.0f)) : 0.0f;
            const float fuzz = r[C_FUZZ];
            const float uddn = dot3(ud, n);
#pragma unroll
            for (int k = 0; k < 3; ++k)
              new_d[k] = ud[k] - n[k] * (2.0f * uddn) + (ru[k] * cr) * fuzz;
            ok = dot3(new_d, n) > 0.0f;
          } else if (has_diel && mk == MAT_DIELECTRIC) {
            // material.h:66-90: refract or reflect (Schlick), vec3.refract
            // with the 1e-12 floors.
            const float inv_len = rsqrt_(a_len > 0.0f ? a_len : 1.0f);
            const float ud[3] = {d[0] * inv_len, d[1] * inv_len, d[2] * inv_len};
            const float ir = r[C_IR];
            const float ratio = front ? 1.0f / ir : ir;
            const float uddn = dot3(ud, n);
            const float cos_t = fminf(-uddn, 1.0f);
            const float sin_t = sqrtf(fmaxf(1e-12f, 1.0f - cos_t * cos_t));
            const bool cannot = ratio * sin_t > 1.0f;
            float r0 = (1.0f - ratio) / (1.0f + ratio);
            r0 = r0 * r0;
            const float x = 1.0f - cos_t;
            const float refl = r0 + (1.0f - r0) * (x * ((x * x) * (x * x)));
            if (cannot || refl > u4) {
#pragma unroll
              for (int k = 0; k < 3; ++k) new_d[k] = ud[k] - n[k] * (2.0f * uddn);
            } else {
              float perp[3];
#pragma unroll
              for (int k = 0; k < 3; ++k) perp[k] = (ud[k] + n[k] * cos_t) * ratio;
              const float p2 = dot3(perp, perp);
              const float par = -sqrtf(fmaxf(fabsf(1.0f - p2), 1e-12f));
#pragma unroll
              for (int k = 0; k < 3; ++k) new_d[k] = perp[k] + n[k] * par;
            }
            att[0] = att[1] = att[2] = 1.0f;
            // Attenuation 1: the sentinel id routes no albedo gradient.
            if constexpr (RECORD) tid = rec.n_textures;
          } else {
            // lambertian (material.h:29-36)
            const float lam[3] = {n[0] + ru[0], n[1] + ru[1], n[2] + ru[2]};
            const bool degenerate = fabsf(lam[0]) < NEAR_ZERO_EPS &&
                                    fabsf(lam[1]) < NEAR_ZERO_EPS &&
                                    fabsf(lam[2]) < NEAR_ZERO_EPS;
#pragma unroll
            for (int k = 0; k < 3; ++k) new_d[k] = degenerate ? n[k] : lam[k];
          }
          if (ok) {
            scattered = true;
            if constexpr (RECORD) ev = 1;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              tp[k] = tp[k] * att[k];
              o[k] = hp[k];
              d[k] = new_d[k];
            }
          }
        }
      }

      // ---- carry update + regeneration (integrator._advance + regen body)
      bounce += 1u;
      seg += scattered ? 1 : 0;
      const bool ended = !(scattered && bounce < (uint32_t)p.max_depth);
      if constexpr (RECORD) {
        if (it < rec.iters) {
          const size_t row = (size_t)it * p.n + lane;
          rec.codes[row] = (ev > 0 ? tid * 16 : 0) + (odd ? 8 : 0) +
                           (ended ? 4 : 0) + ev;
          const size_t plane = (size_t)rec.iters * p.n;
          rec.tprev[row] = tp_entry[0];
          rec.tprev[plane + row] = tp_entry[1];
          rec.tprev[2 * plane + row] = tp_entry[2];
        }
        ++it;
      }
      if (ended) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc[k] = acc[k] + path[k];
          path[k] = 0.0f;
        }
        sample += p.stride;
        alive = sample < p.limit;
        if (alive) {
          cam_rays(p, pix, sample, fi, fj, o, d, tm);
          tp[0] = tp[1] = tp[2] = 1.0f;
          bounce = 0;
          seg += 1;
        } else if (fetch) {
          // Lane fetch: this thread's lane is spent; it takes the next one in
          // this same loop step, so it never waits for its warp's other
          // lanes.
          finish(lane);
          lane = next_live_lane();
          if (lane < p.n) start(lane);
        }
      }
    }
    // Without lane fetch the loop ends with the lane; with it, only when no
    // lane is left (each spent lane was finished above).
    if (lane < p.n) finish(lane);
  }
  if constexpr (!RECORD && !COUNT) {
    // One add per group of threads that get here together.
    if (p.sphere_hits != nullptr) {
      const unsigned m = __activemask();
      const uint32_t sum = __reduce_add_sync(m, n_sphere_hits);
      if ((int)(threadIdx.x & 31) == __ffs(m) - 1 && sum) {
        atomicAdd(p.sphere_hits, (unsigned long long)sum);
      }
    }
  }

  if constexpr (COUNT) {
    const unsigned long long v[TALLIES] = {
        tl.slabs, tl.spheres, tl.slab_steps, tl.slab_active, tl.leaf_steps,
        tl.leaf_active, tl.ground, tl.rects, tl.loop_steps, tl.loop_active};
#pragma unroll
    for (int k = 0; k < TALLIES; ++k) {
      if (v[k]) atomicAdd(tly.out + k, v[k]);
    }
    __syncthreads();
    if (threadIdx.x < (blockDim.x + 31) / 32) {
      atomicMax(tly.out + TALLY_WARP_MAX, warp_loops[threadIdx.x]);
    }
    if (threadIdx.x == 0 && tly.times != nullptr) {
      tly.times[2 * blockIdx.x] = t_start;
      tly.times[2 * blockIdx.x + 1] = global_ns();
    }
  }
}

__global__ void threefry_words_kernel(uint32_t seed, uint32_t key1,
                                      const uint32_t* __restrict__ pixel,
                                      const uint32_t* __restrict__ sample, int n,
                                      uint32_t* __restrict__ w0,
                                      uint32_t* __restrict__ w1,
                                      float* __restrict__ u0,
                                      float* __restrict__ u1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = pixel[i], x1 = sample[i];
  threefry2x32(seed, key1, x0, x1);
  w0[i] = x0;
  w1[i] = x1;
  u0[i] = uniform_from_bits(x0);
  u1[i] = uniform_from_bits(x1);
}

// ops/rng.py's uniform2 over n lanes, one thread a lane: the draws of the
// port's tensor paths (camera, scatter, media), which take the key (seed,
// bounce << 8 | dim) on the counters (pixel[i], sample[i]).  The counters
// and a per-lane bounce are int64 holding uint32 values: their low 32 bits
// are the words.  A null seed_at or bounce_at takes the scalar beside it;
// else the value is read from device memory (a 0-d seed that a CUDA graph's
// replay reads anew, a [n] bounce).  u0 and u1 get the two words' uniforms.
// It replaces no TPU kernel (XLA fuses the JAX package's int64 draws into
// one loop) and is bound by bytes: 24 B a lane in with a [n] bounce, 8 out.
__global__ void __launch_bounds__(256) uniform2_draws_kernel(
    const int64_t* __restrict__ seed_at, uint32_t seed,
    const int64_t* __restrict__ pixel, const int64_t* __restrict__ sample,
    const int64_t* __restrict__ bounce_at, uint32_t bounce, uint32_t dim,
    int n, float* __restrict__ u0, float* __restrict__ u1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = seed_at ? (uint32_t)*seed_at : seed;
  const uint32_t b = bounce_at ? (uint32_t)bounce_at[i] : bounce;
  uint32_t x0 = (uint32_t)pixel[i], x1 = (uint32_t)sample[i];
  threefry2x32(k0, (b << 8) | dim, x0, x1);
  u0[i] = uniform_from_bits(x0);
  u1[i] = uniform_from_bits(x1);
}

// Checks the launch arguments and fills the kernel's Params; returns
// cudaSuccess or cudaErrorInvalidValue.  n_nodes > 0 selects accel mode:
// `tab` the compact tables of n_nodes nodes and n_spheres leaf-order spheres,
// n_spheres widened rows, no rect rows, and smem_bytes either 0 (the walk
// reads device memory) or the tables' size (each block copies them into
// shared memory).  Sweep mode: `tab` the sweep's tables, smem_bytes 0 and
// `next` the lane counter of lane fetch (or null).
cudaError_t make_params(int n_spheres, int n_rects, const float* tab,
                        int n_nodes, int leaf_size, int smem_bytes,
                        const float* camc, int n, uint32_t seed,
                        uint32_t limit, uint32_t stride, int width, int height,
                        int max_depth, float t_min, int flags, int block,
                        int* next, Params& p) {
  if (n_spheres < 0 || n_rects < 0 || n_nodes < 0 || n < 0 || width < 2 ||
      height < 2 || stride == 0 || block <= 0 || tab == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long tab_bytes =
      16LL * (NODE_F4 * (long long)n_nodes + SPHERE_F4 * (long long)n_spheres);
  if (n_nodes > 0 ? (n_rects != 0 || n_spheres < 1 || leaf_size < 1 ||
                     leaf_size >= META_SCALE || next != nullptr ||
                     (smem_bytes != 0 && (smem_bytes != tab_bytes ||
                                          smem_bytes > MAX_SMEM)))
                  : (n_spheres + n_rects > MAX_ROWS ||
                     n_spheres + n_rects == 0 || smem_bytes != 0)) {
    return cudaErrorInvalidValue;
  }
  float* cam = reinterpret_cast<float*>(&p.cam);
  for (int k = 0; k < 24; ++k) cam[k] = camc[k];
  p.inv_w1 = (float)(1.0 / (width - 1));
  p.inv_h1 = (float)(1.0 / (height - 1));
  p.h1 = (float)(height - 1);
  p.t_min = t_min;
  p.seed = seed;
  p.limit = limit;
  p.stride = stride;
  p.width = width;
  p.n = n;
  p.n_spheres = n_spheres;
  p.n_rects = n_rects;
  p.max_depth = max_depth;
  p.flags = flags;
  p.tab = reinterpret_cast<const float4*>(tab);
  p.n_nodes = n_nodes;
  p.leaf_size = leaf_size;
  p.smem_bytes = smem_bytes;
  p.next = next;
  p.sphere_hits = nullptr;
  return cudaSuccess;
}

// Blocks of a lane-fetch launch: as many as the card holds at once (the
// occupancy of the sweep instance at `block` x the SM count), at most one
// per `block` lanes.
cudaError_t fetch_grid(int block, int n, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mega_forward_kernel<SWEEP>, block, 0);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (n + block - 1) / block;
  grid = need < per_sm * sms ? need : per_sm * sms;
  return cudaSuccess;
}

template <int WALK>
cudaError_t launch_walk(const float* rows, const uint32_t* pixel_ids,
                        const uint32_t* sample_ids0, const Params& p,
                        int block, float* out_x, float* out_y, float* out_z,
                        int* out_seg, const Record& rec, const Tallies& tly,
                        cudaStream_t s) {
  const int smem = WALK == ACCEL_SHARED ? p.smem_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_forward_kernel<WALK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  int grid = (p.n + block - 1) / block;
  if (WALK == SWEEP && p.next != nullptr) {
    // Lane fetch: a persistent grid, and the counter from lane 0.
    cudaError_t e = fetch_grid(block, p.n, grid);
    if (e == cudaSuccess) e = cudaMemsetAsync(p.next, 0, sizeof(int), s);
    if (e != cudaSuccess) return e;
  }
  mega_forward_kernel<WALK><<<grid, block, smem, s>>>(
      rows, pixel_ids, sample_ids0, p, out_x, out_y, out_z, out_seg, rec, tly);
  return cudaGetLastError();
}

// Launches this build's instance for `p`: the sweep, or the accel walk on
// the tables in shared memory (smem_bytes > 0) or in device memory.
cudaError_t launch(const float* rows, const uint32_t* pixel_ids,
                   const uint32_t* sample_ids0, const Params& p, int block,
                   float* out_x, float* out_y, float* out_z, int* out_seg,
                   const Record& rec, const Tallies& tly, void* stream) {
  if (p.n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ART_LAUNCH(WALK)                                                    \
  launch_walk<WALK>(rows, pixel_ids, sample_ids0, p, block, out_x, out_y,    \
                    out_z, out_seg, rec, tly, s)
  if (p.n_nodes == 0) return ART_LAUNCH(SWEEP);
  return p.smem_bytes ? ART_LAUNCH(ACCEL_SHARED) : ART_LAUNCH(ACCEL_GLOBAL);
#undef ART_LAUNCH
}

}  // namespace

// The launch arguments of every build: the rows (sweep: n_spheres sphere
// rows then n_rects rect rows, at most 64; accel: n_spheres widened leaf
// rows [N+pad][32] and n_rects 0; both read for the winner's material
// columns), the compact tables (sweep: pack_sweep_tables; accel: the walk's
// nodes and spheres), node count and leaf size (accel mode when n_nodes >
// 0) and the shared-memory bytes of the accel tables (0: device memory),
// then the camera, the lanes and the render constants.  `camc` is a HOST
// array of 24 floats (copied into the kernel's arguments); every other
// pointer is device memory.  `lane_counter` (forward and counting builds):
// one int of device memory, zeroed by the launch, that selects lane fetch
// in sweep mode (null: one lane per thread).

#if defined(ART_RECORD)
// Launches the record instance (K2, or K3's in accel mode) on `stream`:
// art_mega_forward's arguments (without the lane counter) plus the residual
// outputs codes [record_iters][n] int32 and tprev [3][record_iters][n] f32
// (device memory, every element written) and the texture count (the
// dielectric sentinel id).  Returns cudaGetLastError() (0 on success).
extern "C" int art_mega_record(const float* rows, int n_spheres, int n_rects,
                               const float* tab, int n_nodes, int leaf_size,
                               int smem_bytes, const float* camc,
                               const uint32_t* pixel_ids,
                               const uint32_t* sample_ids0, int n,
                               uint32_t seed, uint32_t limit, uint32_t stride,
                               int width, int height, int max_depth,
                               float t_min, int flags, int block,
                               float* out_x, float* out_y, float* out_z,
                               int* out_seg, int record_iters, int n_textures,
                               int* codes, float* tprev, void* stream) {
  Params p;
  const cudaError_t bad = make_params(
      n_spheres, n_rects, tab, n_nodes, leaf_size, smem_bytes, camc, n, seed,
      limit, stride, width, height, max_depth, t_min, flags, block, nullptr,
      p);
  if (bad != cudaSuccess) return (int)bad;
  if (record_iters < 1 || codes == nullptr || tprev == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch(rows, pixel_ids, sample_ids0, p, block, out_x, out_y,
                     out_z, out_seg,
                     Record{codes, tprev, record_iters, n_textures},
                     Tallies{nullptr, -1, nullptr}, stream);
}
#elif defined(ART_COUNT)
// Launches the counting instance on `stream` (the sweep, with or without
// lane fetch, or K3's walk): art_mega_forward's arguments plus the node of
// the leaf tallied apart (accel mode), `tallies`, TALLIES + 1 u64 totals in
// device memory that the launch adds to (Tally's fields in order, then the
// largest loop-step count of one warp, kept by atomicMax), and `times`
// (null, or 2 u64 per block of the grid: the block's start and end
// %globaltimer in ns).  Returns cudaGetLastError() (0 on success).
extern "C" int art_mega_count(const float* rows, int n_spheres, int n_rects,
                              const float* tab, int n_nodes, int leaf_size,
                              int smem_bytes, const float* camc,
                              const uint32_t* pixel_ids,
                              const uint32_t* sample_ids0, int n,
                              uint32_t seed, uint32_t limit, uint32_t stride,
                              int width, int height, int max_depth,
                              float t_min, int flags, int block, float* out_x,
                              float* out_y, float* out_z, int* out_seg,
                              int* lane_counter, int ground_node,
                              unsigned long long* tallies,
                              unsigned long long* times, void* stream) {
  Params p;
  const cudaError_t bad = make_params(
      n_spheres, n_rects, tab, n_nodes, leaf_size, smem_bytes, camc, n, seed,
      limit, stride, width, height, max_depth, t_min, flags, block,
      lane_counter, p);
  if (bad != cudaSuccess) return (int)bad;
  if (tallies == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(rows, pixel_ids, sample_ids0, p, block, out_x, out_y,
                     out_z, out_seg, Record{},
                     Tallies{tallies, ground_node, times}, stream);
}
#else
// Launches the forward instance (K1, or K3's in accel mode) on `stream`,
// adding the launch's sphere hits (the loop iterations whose closest hit is
// a sphere) into `sphere_hits`, one u64 of device memory (null: not
// counted).  Returns cudaGetLastError() (0 on success).
extern "C" int art_mega_forward(const float* rows, int n_spheres, int n_rects,
                                const float* tab, int n_nodes, int leaf_size,
                                int smem_bytes, const float* camc,
                                const uint32_t* pixel_ids,
                                const uint32_t* sample_ids0, int n,
                                uint32_t seed, uint32_t limit, uint32_t stride,
                                int width, int height, int max_depth,
                                float t_min, int flags, int block,
                                float* out_x, float* out_y, float* out_z,
                                int* out_seg, int* lane_counter,
                                unsigned long long* sphere_hits,
                                void* stream) {
  Params p;
  const cudaError_t bad = make_params(
      n_spheres, n_rects, tab, n_nodes, leaf_size, smem_bytes, camc, n, seed,
      limit, stride, width, height, max_depth, t_min, flags, block,
      lane_counter, p);
  if (bad != cudaSuccess) return (int)bad;
  p.sphere_hits = sphere_hits;
  return (int)launch(rows, pixel_ids, sample_ids0, p, block, out_x, out_y,
                     out_z, out_seg, Record{}, Tallies{nullptr, -1, nullptr},
                     stream);
}

// threefry-2x32 (13 rounds) words and their uniforms for key (seed, key1) and
// counters (pixel[i], sample[i]): the card-side check that the kernel's
// generator is bit-exact.  Returns cudaGetLastError().
extern "C" int art_threefry_words(uint32_t seed, uint32_t key1,
                                  const uint32_t* pixel, const uint32_t* sample,
                                  int n, uint32_t* w0, uint32_t* w1, float* u0,
                                  float* u1, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int block = 256;
  threefry_words_kernel<<<(n + block - 1) / block, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      seed, key1, pixel, sample, n, w0, w1, u0, u1);
  return (int)cudaGetLastError();
}

// ops/rng.py's uniform2 on `stream` (uniform2_draws_kernel's arguments; every
// pointer is device memory).  Returns cudaGetLastError().
extern "C" int art_uniform2(const int64_t* seed_at, uint32_t seed,
                            const int64_t* pixel, const int64_t* sample,
                            const int64_t* bounce_at, uint32_t bounce,
                            uint32_t dim, int n, float* u0, float* u1,
                            void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int block = 256;
  uniform2_draws_kernel<<<(n + block - 1) / block, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      seed_at, seed, pixel, sample, bounce_at, bounce, dim, n, u0, u1);
  return (int)cudaGetLastError();
}
#endif

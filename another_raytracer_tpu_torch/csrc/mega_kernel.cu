// Forward megakernel for NVIDIA Hopper (sm_90a): the whole regenerating
// path-trace loop of a scene, one thread per ray lane.
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
// Accel mode (template argument ACCEL; everything else is the same code).
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
// The sphere test, the slab test from [t_min, best_t] and the hit normal
// (o + t d - c) / r with 1/r = 1/(r != 0 ? r : 1) are K3's arithmetic.
// The widened rows ([N+pad][32]: the tree's 16 columns, then the material
// columns) and the nodes ([M][8]) stay in device memory, read through the
// read-only cache: the random scene's rows are 903 x 128 B = 116 KB, more
// than the sweep's shared-memory table is sized for, and up to 1 MB
// (ACCEL_MAX_ROWS).
//
// What bounds it on this card: instruction issue, not memory.  A lane reads
// 8 bytes and writes 16; everything else (ray state, the 13-round threefry,
// an ~25-flop test per row per segment, the shading math) lives in registers,
// and the row table (at most 64 rows x 32 floats = 8 KB) in shared memory.
// The costs are ALU work per segment, warp divergence (a warp runs until its
// slowest lane has spent its samples, and lanes of a warp take different
// material branches), and registers per thread, which set how many warps an
// SM keeps in flight to hide latency.
//
// In accel mode add the walk's latency: each node visit is a dependent
// chain (load the node, test the box, pick the next node) and the lanes of a
// warp diverge to other nodes.
//
// What the design does about it: state never leaves registers; every thread
// of a warp reads the same row in the same sweep step, so shared-memory reads
// are broadcasts (in accel mode the renders trace in Morton order, so a
// warp's lanes are neighbouring pixels whose walks mostly coincide); a lane
// whose path ends re-arms with its next sample at once
// (the TPU kernel's per-lane regeneration), so divergence is confined to the
// tail of each lane's budget; random draws and shading branches that a lane
// does not need are skipped, which is exact because each draw is a pure
// function of its key and counter.  Tuning (block size, occupancy, draw
// batching) is later work.
//
// Record mode (K2, and K3's record instance) is the same kernel compiled with
// the compile-time constant RECORD set, so the forward instances keep their
// registers and their time and only the record instances pay for the
// residual writes.  The file is built twice (ops/kernels/_build.py): as is,
// for the forward instances (art_mega_forward, art_threefry_words), and with
// -DART_RECORD -fmad=false for the record instances (art_mega_record).  The
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

enum Flags : int {
  HAS_LENS = 1, HAS_TIME = 2, HAS_METAL = 4, HAS_DIEL = 8, HAS_LIGHT = 16,
  HAS_CHECKER = 32,
};

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
  // Accel mode: nodes [n_nodes][8] (device memory), leaf rows n_spheres.
  const float* nodes;
  int n_nodes, leaf_size;
};

// Residual outputs of the record instance: codes [iters][n] int32 and
// tprev [3][iters][n] f32, both device memory.
struct Record {
  int* codes;
  float* tprev;
  int iters, n_textures;
};

__host__ __device__ constexpr int rot_of(int r) {
  return r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : r == 3 ? 6
       : r == 4 ? 17 : r == 5 ? 29 : r == 6 ? 16 : 24;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32, Random123 semantics (ops/rng.py:40-69): key injection after
// each complete 4-round group only.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    x0 += x1;
    x1 = rotl(x1, rot_of(r % 8));
    x1 ^= x0;
    if ((r + 1) % 4 == 0) {
      const int inj = (r + 1) / 4;
      x0 += ks[inj % 3];
      x1 += ks[(inj + 1) % 3] + (uint32_t)inj;
    }
  }
}

// The transcendentals of each build (see the header).
__device__ __forceinline__ float sin_(float x) {
  if constexpr (RECORD) return (float)sin((double)x);
  else return sinf(x);
}
__device__ __forceinline__ float cos_(float x) {
  if constexpr (RECORD) return (float)cos((double)x);
  else return cosf(x);
}
__device__ __forceinline__ float rsqrt_(float x) {
  if constexpr (RECORD) return 1.0f / sqrtf(x);
  else return rsqrtf(x);
}

// Top 24 bits x 2^-24: exact, in [0, 1).
__device__ __forceinline__ float uniform_from_bits(uint32_t b) {
  return (float)(b >> 8) * 5.9604644775390625e-8f;
}

__device__ __forceinline__ void uniform2(uint32_t seed, uint32_t pix,
                                         uint32_t sample, uint32_t bounce,
                                         uint32_t dim, float& a, float& b) {
  uint32_t x0 = pix, x1 = sample;
  threefry2x32(seed, (bounce << 8) | dim, x0, x1);
  a = uniform_from_bits(x0);
  b = uniform_from_bits(x1);
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
    const float rdx = c.lens_radius * (rr * cos_(phi));
    const float rdy = c.lens_radius * (rr * sin_(phi));
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

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = c < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(c) < 1e-20f ? tiny : c);
}

// Sweep mode: every row of the shared-memory table, spheres then rects.
// Returns the winner's row (-1 on a miss), its t in best_t and its normal.
__device__ __forceinline__ int sweep_hit(const Params& p,
                                         const float* __restrict__ rows,
                                         const float o[3], const float d[3],
                                         float tm, float a_len, float& best_t,
                                         float bn[3]) {
  const int n_rows = p.n_spheres + p.n_rects;
  int best = -1;
  if (p.n_spheres) {
    const float inv_a = 1.0f / (a_len > 0.0f ? a_len : 1.0f);
    for (int j = 0; j < p.n_spheres; ++j) {
      const float* r = rows + j * ROW_W;
      const float frac = (tm - r[7]) * r[8];
      const float cx = r[1] + frac * r[4];
      const float cy = r[2] + frac * r[5];
      const float cz = r[3] + frac * r[6];
      const float ocx = o[0] - cx, ocy = o[1] - cy, ocz = o[2] - cz;
      const float half_b = ocx * d[0] + ocy * d[1] + ocz * d[2];
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - r[9] * r[9];
      const float disc = half_b * half_b - a_len * c;
      if (!(disc > 0.0f)) continue;
      const float sq = sqrtf(disc);
      const float root1 = (-half_b - sq) * inv_a;
      const float t = (root1 > p.t_min && root1 < best_t)
                          ? root1 : (-half_b + sq) * inv_a;
      if (t > p.t_min && t < best_t) {
        best_t = t;
        best = j;
        const float inv_r = 1.0f / r[9];
        bn[0] = (o[0] + t * d[0] - cx) * inv_r;
        bn[1] = (o[1] + t * d[1] - cy) * inv_r;
        bn[2] = (o[2] + t * d[2] - cz) * inv_r;
      }
    }
  }
  for (int j = p.n_spheres; j < n_rows; ++j) {
    // World parallelogram == aarect.cpp plane + inclusive bounds.
    const float* r = rows + j * ROW_W;
    const float ndotd = r[10] * d[0] + r[11] * d[1] + r[12] * d[2];
    if (ndotd == 0.0f) continue;
    const float ndoto = r[10] * o[0] + r[11] * o[1] + r[12] * o[2];
    const float t = (r[13] - ndoto) / ndotd;
    const float rx = o[0] + t * d[0] - r[1];
    const float ry = o[1] + t * d[1] - r[2];
    const float rz = o[2] + t * d[2] - r[3];
    const float a = rx * r[4] + ry * r[5] + rz * r[6];
    const float b = rx * r[7] + ry * r[8] + rz * r[9];
    if (a >= 0.0f && a <= r[14] && b >= 0.0f && b <= r[15] &&
        t > p.t_min && t < best_t) {
      best_t = t;
      best = j;
      bn[0] = r[10];
      bn[1] = r[11];
      bn[2] = r[12];
    }
  }
  return best;
}

// Accel mode: the stackless walk of the sphere tree over the widened leaf
// rows in device memory (mega_kernel.py:384-500).  Same returns.
__device__ __forceinline__ int accel_hit(const Params& p,
                                         const float* __restrict__ rows,
                                         const float o[3], const float d[3],
                                         float tm, float a_len, float& best_t,
                                         float bn[3]) {
  const float ix = safe_inv(d[0]), iy = safe_inv(d[1]), iz = safe_inv(d[2]);
  const float inv_a = 1.0f / (a_len > 0.0f ? a_len : 1.0f);
  int best = -1;
  int j = 0;
  while (j < p.n_nodes) {
    const float* nd = p.nodes + 8 * (size_t)j;
    float tn = p.t_min, tf = best_t;
    {
      const float a = (ldg(nd + 0) - o[0]) * ix, b = (ldg(nd + 3) - o[0]) * ix;
      tn = fmaxf(tn, fminf(a, b));
      tf = fminf(tf, fmaxf(a, b));
    }
    {
      const float a = (ldg(nd + 1) - o[1]) * iy, b = (ldg(nd + 4) - o[1]) * iy;
      tn = fmaxf(tn, fminf(a, b));
      tf = fminf(tf, fmaxf(a, b));
    }
    {
      const float a = (ldg(nd + 2) - o[2]) * iz, b = (ldg(nd + 5) - o[2]) * iz;
      tn = fmaxf(tn, fminf(a, b));
      tf = fminf(tf, fmaxf(a, b));
    }
    if (!(tn < tf)) {
      j = (int)ldg(nd + 6);
      continue;
    }
    const int meta = (int)ldg(nd + 7);
    const int count = min(meta % META_SCALE, p.leaf_size);
    const int first = meta / META_SCALE;
    for (int k = 0; k < count; ++k) {
      const int row = min(first + k, p.n_spheres - 1);
      const float* r = rows + (size_t)row * ROW_W;
      const float frac = (tm - ldg(r + 6)) * ldg(r + 7);
      const float ocx = o[0] - (ldg(r + 0) + frac * ldg(r + 3));
      const float ocy = o[1] - (ldg(r + 1) + frac * ldg(r + 4));
      const float ocz = o[2] - (ldg(r + 2) + frac * ldg(r + 5));
      const float rad = ldg(r + 8);
      const float half_b = ocx * d[0] + ocy * d[1] + ocz * d[2];
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
      const float disc = half_b * half_b - a_len * c;
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
    ++j;
  }
  if (best >= 0) {
    // The winner's outward normal, K3's formula (mega_kernel.py:462-465).
    const float* r = rows + (size_t)best * ROW_W;
    const float frac = (tm - ldg(r + 6)) * ldg(r + 7);
    const float rad = ldg(r + 8);
    const float inv_r = 1.0f / (rad != 0.0f ? rad : 1.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ck = ldg(r + k) + frac * ldg(r + 3 + k);
      bn[k] = (o[k] + best_t * d[k] - ck) * inv_r;
    }
  }
  return best;
}

template <bool ACCEL>
__global__ void mega_forward_kernel(const float* __restrict__ rows_g,
                                    const uint32_t* __restrict__ pixel_ids,
                                    const uint32_t* __restrict__ sample_ids0,
                                    const Params p,
                                    float* __restrict__ out_x,
                                    float* __restrict__ out_y,
                                    float* __restrict__ out_z,
                                    int* __restrict__ out_seg,
                                    const Record rec) {
  const float* rows;  // sweep: the shared-memory table; accel: rows_g
  if constexpr (ACCEL) {
    rows = rows_g;
  } else {
    __shared__ float rows_s[MAX_ROWS * ROW_W];
    const int n_rows = p.n_spheres + p.n_rects;
    for (int k = threadIdx.x; k < n_rows * ROW_W; k += blockDim.x) {
      rows_s[k] = rows_g[k];
    }
    __syncthreads();
    rows = rows_s;
  }

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n) return;

  const bool has_metal = p.flags & HAS_METAL;
  const bool has_diel = p.flags & HAS_DIEL;
  const bool has_light = p.flags & HAS_LIGHT;
  const bool has_checker = p.flags & HAS_CHECKER;
  const bool need_b_draw = has_metal || has_diel;

  const uint32_t pix = pixel_ids[lane];
  uint32_t sample = sample_ids0[lane];
  const float fi = (float)(pix % (uint32_t)p.width);
  const float fj = (float)(pix / (uint32_t)p.width);

  float o[3], d[3], tm;
  cam_rays(p, pix, sample, fi, fj, o, d, tm);
  bool alive = sample < p.limit;
  float tp[3] = {1.0f, 1.0f, 1.0f};
  float path[3] = {0.0f, 0.0f, 0.0f};
  float acc[3] = {0.0f, 0.0f, 0.0f};
  uint32_t bounce = 0;
  int seg = alive ? 1 : 0;
  int it = 0;  // this lane's loop iteration (record row)

  while (alive) {
    const float a_len = dot3(d, d);
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
    float bn[3] = {0.0f, 0.0f, 0.0f};
    int best;
    if constexpr (ACCEL) {
      best = accel_hit(p, rows, o, d, tm, a_len, best_t, bn);
    } else {
      best = sweep_hit(p, rows, o, d, tm, a_len, best_t, bn);
    }

    bool scattered = false;
    if (best < 0) {
      // Miss: the background, weighted by the throughput.
#pragma unroll
      for (int k = 0; k < 3; ++k) path[k] = path[k] + tp[k] * p.cam.bg[k];
      if constexpr (RECORD) ev = 3;
    } else {
      // ---- shade + scatter (shade.emit_and_scatter) ----------------------
      const float* r = rows + (size_t)best * ROW_W;
      const bool front = dot3(bn, d) < 0.0f;
      float n[3], hp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        n[k] = front ? bn[k] : -bn[k];
        hp[k] = o[k] + best_t * d[k];
      }
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
        const float ru[3] = {rr * cos_(phi), rr * sin_(phi), zz};

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
      }
    }
  }

  out_x[lane] = acc[0];
  out_y[lane] = acc[1];
  out_z[lane] = acc[2];
  out_seg[lane] = seg;
  if constexpr (RECORD) {
    // Rows past this lane's end are zero (idle rows: the replay skips them).
    const size_t plane = (size_t)rec.iters * p.n;
    for (; it < rec.iters; ++it) {
      const size_t row = (size_t)it * p.n + lane;
      rec.codes[row] = 0;
      rec.tprev[row] = 0.0f;
      rec.tprev[plane + row] = 0.0f;
      rec.tprev[2 * plane + row] = 0.0f;
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

// Checks the launch arguments and fills the kernel's Params; returns
// cudaSuccess or cudaErrorInvalidValue.  n_nodes > 0 selects accel mode:
// `nodes` [n_nodes][8] and n_spheres widened leaf rows, no rect rows.
cudaError_t make_params(int n_spheres, int n_rects, const float* nodes,
                        int n_nodes, int leaf_size, const float* camc, int n,
                        uint32_t seed, uint32_t limit, uint32_t stride,
                        int width, int height, int max_depth, float t_min,
                        int flags, int block, Params& p) {
  if (n_spheres < 0 || n_rects < 0 || n_nodes < 0 || n < 0 || width < 2 ||
      height < 2 || stride == 0 || block <= 0) {
    return cudaErrorInvalidValue;
  }
  if (n_nodes > 0 ? (nodes == nullptr || n_rects != 0 || n_spheres < 1 ||
                     leaf_size < 1 || leaf_size >= META_SCALE)
                  : (n_spheres + n_rects > MAX_ROWS ||
                     n_spheres + n_rects == 0)) {
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
  p.nodes = nodes;
  p.n_nodes = n_nodes;
  p.leaf_size = leaf_size;
  return cudaSuccess;
}

// Launches the sweep or the accel instance of this build.
cudaError_t launch(const float* rows, const uint32_t* pixel_ids,
                   const uint32_t* sample_ids0, const Params& p, int block,
                   float* out_x, float* out_y, float* out_z, int* out_seg,
                   const Record& rec, void* stream) {
  if (p.n == 0) return cudaSuccess;
  const int grid = (p.n + block - 1) / block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.n_nodes > 0) {
    mega_forward_kernel<true><<<grid, block, 0, s>>>(
        rows, pixel_ids, sample_ids0, p, out_x, out_y, out_z, out_seg, rec);
  } else {
    mega_forward_kernel<false><<<grid, block, 0, s>>>(
        rows, pixel_ids, sample_ids0, p, out_x, out_y, out_z, out_seg, rec);
  }
  return cudaGetLastError();
}

}  // namespace

// The launch arguments of both builds: the rows (sweep: n_spheres sphere
// rows then n_rects rect rows, at most 64; accel: n_spheres widened leaf
// rows [N+pad][32] and n_rects 0), the sphere tree's nodes [n_nodes][8] and
// leaf size (accel mode when n_nodes > 0; nodes may be null in sweep mode),
// then the camera, the lanes and the render constants.  `camc` is a HOST
// array of 24 floats (copied into the kernel's arguments); every other
// pointer is device memory.

#ifndef ART_RECORD
// Launches the forward instance (K1, or K3's in accel mode) on `stream`.
// Returns cudaGetLastError() (0 on success).
extern "C" int art_mega_forward(const float* rows, int n_spheres, int n_rects,
                                const float* nodes, int n_nodes,
                                int leaf_size, const float* camc,
                                const uint32_t* pixel_ids,
                                const uint32_t* sample_ids0, int n,
                                uint32_t seed, uint32_t limit, uint32_t stride,
                                int width, int height, int max_depth,
                                float t_min, int flags, int block,
                                float* out_x, float* out_y, float* out_z,
                                int* out_seg, void* stream) {
  Params p;
  const cudaError_t bad = make_params(n_spheres, n_rects, nodes, n_nodes,
                                      leaf_size, camc, n, seed, limit, stride,
                                      width, height, max_depth, t_min, flags,
                                      block, p);
  if (bad != cudaSuccess) return (int)bad;
  return (int)launch(rows, pixel_ids, sample_ids0, p, block, out_x, out_y,
                     out_z, out_seg, Record{}, stream);
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
#else
// Launches the record instance (K2, or K3's in accel mode) on `stream`:
// art_mega_forward's arguments plus the residual outputs codes
// [record_iters][n] int32 and tprev [3][record_iters][n] f32 (device memory,
// every element written) and the texture count (the dielectric sentinel
// id).  Returns cudaGetLastError() (0 on success).
extern "C" int art_mega_record(const float* rows, int n_spheres, int n_rects,
                               const float* nodes, int n_nodes, int leaf_size,
                               const float* camc, const uint32_t* pixel_ids,
                               const uint32_t* sample_ids0, int n,
                               uint32_t seed, uint32_t limit, uint32_t stride,
                               int width, int height, int max_depth,
                               float t_min, int flags, int block,
                               float* out_x, float* out_y, float* out_z,
                               int* out_seg, int record_iters, int n_textures,
                               int* codes, float* tprev, void* stream) {
  Params p;
  const cudaError_t bad = make_params(n_spheres, n_rects, nodes, n_nodes,
                                      leaf_size, camc, n, seed, limit, stride,
                                      width, height, max_depth, t_min, flags,
                                      block, p);
  if (bad != cudaSuccess) return (int)bad;
  if (record_iters < 1 || codes == nullptr || tprev == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch(rows, pixel_ids, sample_ids0, p, block, out_x, out_y,
                     out_z, out_seg,
                     Record{codes, tprev, record_iters, n_textures}, stream);
}
#endif

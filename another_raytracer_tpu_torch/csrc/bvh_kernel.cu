// BVH closest-hit kernel for NVIDIA Hopper (sm_90a): a stackless walk of the
// flat escape-index tree per ray, over compact 16-byte tables, with leaves
// postponed warp-wide.
//
// Replaces: another_raytracer_tpu/ops/pallas/bvh_kernel.py::bvh_closest_hit
// (body _kernel), reached from ops/intersect.py::_fold_bvh for every BVH'd
// primitive kind: prim 'planar' (triangles and quad-split transformed
// rects; 16- or 35-column rows, optional winner-record folds and
// precomputed leaf geometry), 'sphere' (world-baked, moving; optional
// fold of the centre at the ray's time, radius, material and has_uv) and
// 'rect' (identity axis rects).  Same inputs and outputs: per ray the
// closest t, the winning row's code (id * 4 + kind; init_idx copied through
// where not improved), the improved flag and the fold outputs (zeros where
// not improved).  The sphere fold is the port's own: the Pallas kernel
// folds the outward normal, and the port's record re-projects the hit
// point onto its sphere from the centre and radius (ops/intersect.py).
//
// The TPU kernel walks the tree with ONE cursor per block of rays (packet
// DFS): at node j every lane runs the slab test, the block enters the
// subtree if any lane hit the box, and a lane's leaf tests are masked by its
// own box test.  Child boxes nest inside their parents and a lane's best t
// only shrinks, so a lane that missed a box misses every box below it: the
// leaves a lane tests, and their order, are those of its own walk.  Here
// each ray walks on its own: on a box hit it goes to j + 1 (and tests a
// leaf's rows in leaf order with the strict t < best_t rule, so the earlier
// row keeps a tie), on a miss it jumps to the escape index.  Same
// primitives, same order, same winner (tests/test_torch_bvh.py holds the
// plain version of this walk against the Pallas kernel in interpret mode).
//
// What bounds it on this card: the walk's latency, not bandwidth or ALU
// peak.  Each node visit is a dependent chain (load the node, test the box,
// pick the next node), the rays of a warp diverge to other nodes, and a
// leaf visit streams up to leaf_size rows.  What the design does about it
// (the redesign of K3's walk, csrc/mega_kernel.cu, carried over):
//
// * Compact tables (the wrapper's pack_tables, packed once per tree): a node
//   is 2 float4 (lo.xyz, escape | hi.xyz, meta); a row, per kind, sphere 3
//   (c0.xyz, r | c1 - c0, t0 | 1/dt, 0, 0, 0), rect 2 (axis, k, lo_u, lo_v |
//   hi_u, hi_v, 0, 0), triangle 3 (v0 | v1 | v2, w unused) or, with
//   precomputed geometry, 4 (n, n.v0 | m0, c0 | m1, c1 | m2, c2).  Every
//   float a box or leaf test reads comes from a 16-byte load.  Nodes first,
//   then the rows in leaf order.  Where they fit a block's shared memory
//   (MAX_SMEM: scene 1's sphere tree, 45,104 B) each block copies them there
//   once (SHARED); larger tables (a 10,240-triangle soup, ~490 KB) are read
//   by the same walk from device memory through 16-byte read-only loads.
//   The wrapper picks by size.  What only the winner needs (its code, the
//   fold's material, has_uv, texcoords, 1/|n|^2, 1/|n|) stays in the wide
//   rows in device memory and is read once per ray.
// * Postponed leaves (the while-while traversal of Aila & Laine, HPG 2009):
//   a ray advances over inner nodes on its own until it stands on a leaf
//   whose box it hit, or its walk has ended; the warp tests leaves only when
//   every ray that is still walking holds a leaf (__any_sync), and then
//   every leaf-holding ray tests its leaf at once.  A ray's slab test after
//   a leaf depends on the best t that leaf left, so it cannot run ahead:
//   each ray visits the same nodes and tests the same rows in the same
//   order as the per-ray walk, which keeps winners, t bits and counts.
// * The fold outputs are computed once, for the winner, after the walk,
//   with the leaf test's operations in the same order (the same bits as
//   computing them at every improvement).
// * One ray per thread, the grid covering the rays: a warp's neighbouring
//   camera rays walk together.  (A persistent grid whose threads fetch the
//   next ray as theirs ends measured slower on shared-memory tables, which
//   are the ones the port's paths launch; PERF.md.)
//
// Variants are template instances of one kernel: PRIM (planar / sphere /
// rect), FOLD (winner-record fold), FULL (planar: also texcoords and
// material), PRECOMP (planar: the precomputed leaf geometry), SHARED (the
// tables in shared memory).  leaf_size is a runtime loop bound; t_min is a
// launch argument, fixed per call (the wrapper refuses a tensor).
//
// The counting build (-DART_COUNT -fmad=false, art_bvh_count; a measurement,
// the port's paths never launch it) tallies per launch the slab and leaf
// row tests, the active lanes of the warp's slab and leaf-row steps (sum of
// popc(__activemask()) over warp steps, tallied by the lowest active lane)
// and each block's start and end %globaltimer.
//
// Numerics: built with -fmad=false (ops/kernels/_build.py) and IEEE division
// and sqrt, with 1/|n| as 1.0f / sqrtf: each operation rounds as the plain
// version's (ops/bvh.py::traverse_packed), which runs the same operations in
// the same order, so the two agree bit for bit on the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false  (ops/kernels/_build.py)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

#ifdef ART_COUNT
constexpr bool COUNT = true;
#else
constexpr bool COUNT = false;
#endif

constexpr float BIG = 3e37f;
constexpr int META_SCALE = 64;
constexpr int PRIM_PLANAR = 0, PRIM_SPHERE = 1, PRIM_RECT = 2;
constexpr int NODE_F4 = 2;
// Shared memory one block may take on sm_90 after opting in.
constexpr int MAX_SMEM = 232448;
constexpr int MAX_BLOCK = 512;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Float4s per leaf row of the compact tables.
__host__ __device__ constexpr int row_f4(int prim, bool precomp) {
  return prim == PRIM_PLANAR ? (precomp ? 4 : 3)
                             : (prim == PRIM_SPHERE ? 3 : 2);
}

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *time, *init_t;
  const int* init_idx;
};

struct Out {
  float* t;
  int* code;
  uint8_t* hit;
  float* aux;  // [n_aux][n]
};

struct Params {
  const float4* tab;  // compact tables in device memory: nodes, then rows
  const float* rows;  // the wide rows [n_rows][row_w] (winner's columns)
  int n_nodes, n_rows, row_w, n, leaf_size;
  float t_min;
};

// Counting build: TALLIES u64 totals (added to) and per block its start and
// end %globaltimer (ns).
struct Tallies {
  unsigned long long* out;
  unsigned long long* times;
};
struct Tally {
  unsigned long long slabs, slab_steps, slab_active, tests, leaf_steps,
      leaf_active;
};
constexpr int TALLIES = 6;

__device__ __forceinline__ void warp_step(unsigned long long& steps,
                                          unsigned long long& active) {
  const unsigned m = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
    ++steps;
    active += __popc(m);
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool SHARED>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (SHARED) return *p;
  else return __ldg(p);
}

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = c < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(c) < 1e-20f ? tiny : c);
}

// One ray's state.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, time, a_vec, inv_a, best_t;
  int best;  // leaf-order row of the winner, -1 until one improves
  int j;     // the walk's cursor
};

// Slab test of a node (a: lo.xyz, escape | b: hi.xyz, meta) from
// [t_min, best_t].
__device__ __forceinline__ bool slab_hit(const float4& a, const float4& b,
                                         const Ray& r, float t_min) {
  float tn = t_min, tf = r.best_t;
  {
    const float u = (a.x - r.ox) * r.ix, v = (b.x - r.ox) * r.ix;
    tn = fmaxf(tn, fminf(u, v));
    tf = fminf(tf, fmaxf(u, v));
  }
  {
    const float u = (a.y - r.oy) * r.iy, v = (b.y - r.oy) * r.iy;
    tn = fmaxf(tn, fminf(u, v));
    tf = fminf(tf, fmaxf(u, v));
  }
  {
    const float u = (a.z - r.oz) * r.iz, v = (b.z - r.oz) * r.iz;
    tn = fmaxf(tn, fminf(u, v));
    tf = fminf(tf, fmaxf(u, v));
  }
  return tn < tf;
}

// A triangle's leaf-test geometry: read (precomp) or computed from its
// vertices, with the plain version's operations.
struct Tri {
  float nx, ny, nz, ndotv0, m0x, m0y, m0z, m1x, m1y, m1z, m2x, m2y, m2z, c0,
      c1, c2;
};

template <bool PRECOMP, bool SHARED>
__device__ __forceinline__ Tri tri_geom(const float4* r) {
  Tri g;
  if constexpr (PRECOMP) {
    const float4 a = ld4<SHARED>(r), b = ld4<SHARED>(r + 1),
                 c = ld4<SHARED>(r + 2), e = ld4<SHARED>(r + 3);
    g.nx = a.x; g.ny = a.y; g.nz = a.z; g.ndotv0 = a.w;
    g.m0x = b.x; g.m0y = b.y; g.m0z = b.z; g.c0 = b.w;
    g.m1x = c.x; g.m1y = c.y; g.m1z = c.z; g.c1 = c.w;
    g.m2x = e.x; g.m2y = e.y; g.m2z = e.z; g.c2 = e.w;
  } else {
    const float4 v0 = ld4<SHARED>(r), v1 = ld4<SHARED>(r + 1),
                 v2 = ld4<SHARED>(r + 2);
    const float e1x = v1.x - v0.x, e1y = v1.y - v0.y, e1z = v1.z - v0.z;
    const float e2x = v2.x - v0.x, e2y = v2.y - v0.y, e2z = v2.z - v0.z;
    g.nx = e1y * e2z - e1z * e2y;
    g.ny = e1z * e2x - e1x * e2z;
    g.nz = e1x * e2y - e1y * e2x;
    g.ndotv0 = g.nx * v0.x + g.ny * v0.y + g.nz * v0.z;
    // m = n x edge for the edges v1-v0, v2-v1, v0-v2.
    const float g1x = v2.x - v1.x, g1y = v2.y - v1.y, g1z = v2.z - v1.z;
    const float g2x = v0.x - v2.x, g2y = v0.y - v2.y, g2z = v0.z - v2.z;
    g.m0x = g.ny * e1z - g.nz * e1y;
    g.m0y = g.nz * e1x - g.nx * e1z;
    g.m0z = g.nx * e1y - g.ny * e1x;
    g.m1x = g.ny * g1z - g.nz * g1y;
    g.m1y = g.nz * g1x - g.nx * g1z;
    g.m1z = g.nx * g1y - g.ny * g1x;
    g.m2x = g.ny * g2z - g.nz * g2y;
    g.m2y = g.nz * g2x - g.nx * g2z;
    g.m2z = g.nx * g2y - g.ny * g2x;
    g.c0 = g.m0x * v0.x + g.m0y * v0.y + g.m0z * v0.z;
    g.c1 = g.m1x * v1.x + g.m1y * v1.y + g.m1z * v1.z;
    g.c2 = g.m2x * v2.x + g.m2y * v2.y + g.m2z * v2.z;
  }
  return g;
}

// The triangle test's t and edge values (a hit: ok and w0..w2 >= 0).
__device__ __forceinline__ float tri_t(const Tri& g, const Ray& r, bool& ok,
                                       float& w0, float& w1, float& w2) {
  const float ndotd = g.nx * r.dx + g.ny * r.dy + g.nz * r.dz;
  const float ndoto = g.nx * r.ox + g.ny * r.oy + g.nz * r.oz;
  ok = ndotd != 0.0f;
  const float t = ok ? (g.ndotv0 - ndoto) / ndotd : BIG;
  const float px = r.ox + r.dx * t, py = r.oy + r.dy * t, pz = r.oz + r.dz * t;
  w0 = px * g.m0x + py * g.m0y + pz * g.m0z - g.c0;
  w1 = px * g.m1x + py * g.m1y + pz * g.m1z - g.c1;
  w2 = px * g.m2x + py * g.m2y + pz * g.m2z - g.c2;
  return t;
}

// A moving sphere's offset o - center(time) (s0: c0.xyz, r | s1: c1 - c0,
// t0 | inv_dt).
__device__ __forceinline__ void sphere_oc(const float4& s0, const float4& s1,
                                          float inv_dt, const Ray& r,
                                          float& ocx, float& ocy, float& ocz) {
  const float frac = (r.time - s1.w) * inv_dt;
  ocx = r.ox - (s0.x + frac * s1.x);
  ocy = r.oy - (s0.y + frac * s1.y);
  ocz = r.oz - (s0.z + frac * s1.z);
}

// A leaf's rows (meta = first * 64 + count) in leaf order, the strict
// t < best_t rule keeping the earlier row on a tie.
template <int PRIM, bool PRECOMP, bool SHARED>
__device__ __forceinline__ void leaf_test(const Params& p,
                                          const float4* __restrict__ geo,
                                          int meta, Ray& r, Tally& tl) {
  constexpr int RF4 = row_f4(PRIM, PRECOMP);
  const int count = min(meta % META_SCALE, p.leaf_size);
  const int first = meta / META_SCALE;
  if constexpr (COUNT) tl.tests += count;
  for (int k = 0; k < count; ++k) {
    if constexpr (COUNT) warp_step(tl.leaf_steps, tl.leaf_active);
    const int row = min(first + k, p.n_rows - 1);
    const float4* s = geo + RF4 * row;
    float t;
    if constexpr (PRIM == PRIM_PLANAR) {
      const Tri g = tri_geom<PRECOMP, SHARED>(s);
      bool ok;
      float w0, w1, w2;
      t = tri_t(g, r, ok, w0, w1, w2);
      if (!(ok && w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f)) continue;
    } else if constexpr (PRIM == PRIM_SPHERE) {
      const float4 s0 = ld4<SHARED>(s), s1 = ld4<SHARED>(s + 1);
      float ocx, ocy, ocz;
      sphere_oc(s0, s1, ld4<SHARED>(s + 2).x, r, ocx, ocy, ocz);
      const float rad = s0.w;
      const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
      const float disc = half_b * half_b - r.a_vec * c;
      if (!(disc > 0.0f)) continue;
      const float sq = sqrtf(disc);
      const float root1 = (-half_b - sq) * r.inv_a;
      const float root2 = (-half_b + sq) * r.inv_a;
      t = (root1 > p.t_min && root1 < r.best_t) ? root1 : root2;
    } else {
      const float4 a = ld4<SHARED>(s), b = ld4<SHARED>(s + 1);
      const bool is0 = a.x == 0.0f, is2 = a.x == 2.0f;
      const float o_ax = is0 ? r.ox : (is2 ? r.oz : r.oy);
      const float d_ax = is0 ? r.dx : (is2 ? r.dz : r.dy);
      if (d_ax == 0.0f) continue;  // parallel
      t = (a.y - o_ax) / d_ax;
      const float pu = (is0 ? r.oy : r.ox) + t * (is0 ? r.dy : r.dx);
      const float pv = (is2 ? r.oy : r.oz) + t * (is2 ? r.dy : r.dz);
      if (!(pu >= a.z && pu <= b.x && pv >= a.w && pv <= b.y)) continue;
    }
    if (t > p.t_min && t < r.best_t) {
      r.best_t = t;
      r.best = row;
    }
  }
}

template <int PRIM, bool FOLD, bool FULL, bool PRECOMP, bool SHARED>
__global__ void __launch_bounds__(MAX_BLOCK)
bvh_kernel(const Params p, const Rays rays, const Out out,
           const Tallies tly) {
  constexpr int RF4 = row_f4(PRIM, PRECOMP);
  const unsigned long long t_start = COUNT ? global_ns() : 0;
  const float4* tab = p.tab;
  if constexpr (SHARED) {
    extern __shared__ float4 tab_s[];
    const int n4 = NODE_F4 * p.n_nodes + RF4 * p.n_rows;
    for (int k = threadIdx.x; k < n4; k += blockDim.x) {
      tab_s[k] = __ldg(p.tab + k);
    }
    __syncthreads();
    tab = tab_s;
  }
  const float4* nodes = tab;
  const float4* geo = tab + NODE_F4 * p.n_nodes;
  Tally tl{};

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = i < p.n;  // this thread's ray is still walking
  Ray r;
  if (live) {
    r.ox = rays.ox[i]; r.oy = rays.oy[i]; r.oz = rays.oz[i];
    r.dx = rays.dx[i]; r.dy = rays.dy[i]; r.dz = rays.dz[i];
    r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
    r.time = rays.time[i];
    if (PRIM == PRIM_SPHERE) {
      r.a_vec = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
      r.inv_a = 1.0f / (r.a_vec > 0.0f ? r.a_vec : 1.0f);
    }
    r.best_t = rays.init_t[i];
    r.best = -1;
    r.j = 0;
  }
  // Every thread of the warp goes round this loop until no ray of the warp
  // holds a leaf, so all of them meet at every __any_sync.
  while (true) {
    int meta = 0;  // the hit leaf this ray holds (0: none)
    while (live && r.j < p.n_nodes) {
      if constexpr (COUNT) {
        ++tl.slabs;
        warp_step(tl.slab_steps, tl.slab_active);
      }
      const float4 a = ld4<SHARED>(nodes + NODE_F4 * r.j);
      const float4 b = ld4<SHARED>(nodes + NODE_F4 * r.j + 1);
      if (!slab_hit(a, b, r, p.t_min)) {
        r.j = (int)a.w;
        continue;
      }
      ++r.j;
      const int m = (int)b.w;
      if (m % META_SCALE) {
        meta = m;
        break;
      }
    }
    live = meta != 0;  // a ray that holds no leaf has ended its walk
    if (!__any_sync(FULL_MASK, live)) break;
    if (live) leaf_test<PRIM, PRECOMP, SHARED>(p, geo, meta, r, tl);
  }

  // The ray's outputs: the winner's code from the wide rows and its fold
  // outputs, computed once with the leaf test's operations (planar: unit
  // normal, u, v[, tu, tv, mat]; sphere: centre at the ray's time, radius,
  // mat, has_uv), zeros where the tree did not improve the ray.
  if (i < p.n) {
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int code = rays.init_idx[i];
    if (r.best >= 0) {
      const float* wide = p.rows + (size_t)r.best * p.row_w;
      code = (int)__ldg(wide + 9);
      const float4* s = p.tab + NODE_F4 * p.n_nodes + RF4 * r.best;
      if constexpr (FOLD && PRIM == PRIM_PLANAR) {
        const Tri g = tri_geom<PRECOMP, false>(s);
        bool ok;
        float w0, w1, w2;
        tri_t(g, r, ok, w0, w1, w2);
        float inv_n2, inv_len;
        if constexpr (PRECOMP) {
          inv_n2 = __ldg(wide + 33);
          inv_len = __ldg(wide + 34);
        } else {
          const float n2 = fmaxf(g.nx * g.nx + g.ny * g.ny + g.nz * g.nz,
                                 1e-37f);
          inv_n2 = 1.0f / n2;
          inv_len = 1.0f / sqrtf(n2);
        }
        const float uu = w1 * inv_n2, vv = w2 * inv_n2;
        f[0] = g.nx * inv_len; f[1] = g.ny * inv_len; f[2] = g.nz * inv_len;
        f[3] = uu; f[4] = vv;
        if constexpr (FULL) {
          const float uv0u = __ldg(wide + 10), uv0v = __ldg(wide + 11);
          const float uv1u = __ldg(wide + 12), uv1v = __ldg(wide + 13);
          const float uv2u = __ldg(wide + 14), uv2v = __ldg(wide + 15);
          f[5] = uv2u + uu * (uv0u - uv2u) + vv * (uv1u - uv2u);
          f[6] = uv2v + uu * (uv0v - uv2v) + vv * (uv1v - uv2v);
          f[7] = __ldg(wide + 16);
        }
      } else if constexpr (FOLD && PRIM == PRIM_SPHERE) {
        const float4 s0 = __ldg(s), s1 = __ldg(s + 1);
        const float frac = (r.time - s1.w) * __ldg(s + 2).x;
        f[0] = s0.x + frac * s1.x;
        f[1] = s0.y + frac * s1.y;
        f[2] = s0.z + frac * s1.z;
        f[3] = s0.w;
        f[4] = __ldg(wide + 10);
        f[5] = __ldg(wide + 11);
      }
    }
    out.t[i] = r.best_t;
    out.code[i] = code;
    out.hit[i] = r.best >= 0 ? 1 : 0;
    if constexpr (FOLD) {
      constexpr int N_AUX = FULL ? 8 : (PRIM == PRIM_SPHERE ? 6 : 5);
#pragma unroll
      for (int k = 0; k < N_AUX; ++k) out.aux[k * (size_t)p.n + i] = f[k];
    }
  }

  if constexpr (COUNT) {
    const unsigned long long v[TALLIES] = {tl.slabs, tl.slab_steps,
                                           tl.slab_active, tl.tests,
                                           tl.leaf_steps, tl.leaf_active};
#pragma unroll
    for (int k = 0; k < TALLIES; ++k) {
      if (v[k]) atomicAdd(tly.out + k, v[k]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      tly.times[2 * blockIdx.x] = t_start;
      tly.times[2 * blockIdx.x + 1] = global_ns();
    }
  }
}

template <int PRIM, bool FOLD, bool FULL, bool PRECOMP, bool SHARED>
cudaError_t launch(const Params& p, const Rays& r, const Out& out,
                   const Tallies& tly, int block, cudaStream_t s) {
  const auto kernel = bvh_kernel<PRIM, FOLD, FULL, PRECOMP, SHARED>;
  const int smem =
      SHARED ? 16 * (NODE_F4 * p.n_nodes + row_f4(PRIM, PRECOMP) * p.n_rows)
             : 0;
  if (smem > 48 * 1024) {
    // Per instance and device, the shared memory opted into: set once, so
    // that a launch captured in a CUDA graph makes no such call.
    static std::mutex mu;
    static int opted[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    const std::lock_guard<std::mutex> lock(mu);
    if (smem > opted[dev]) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      opted[dev] = smem;
    }
  }
  kernel<<<(p.n + block - 1) / block, block, smem, s>>>(p, r, out, tly);
  return cudaGetLastError();
}

// Checks a launch's arguments and runs the variant's instance; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a variant
// or shape the kernel does not take.
int launch_any(const float* tab, int shared, const float* rows, int n_nodes,
               int n_rows, int row_w, const Rays& r, int n, int leaf_size,
               float t_min, int prim, int fold, int full, int precomp,
               int block, const Out& out, const Tallies& tly,
               void* stream_ptr) {
  if (n < 0 || n_nodes < 0 || n_rows < 0 || leaf_size < 1 ||
      leaf_size >= META_SCALE || block < 32 || block > MAX_BLOCK ||
      block % 32 != 0 || prim < PRIM_PLANAR || prim > PRIM_RECT) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_nodes > 0 && (n_rows < 1 || tab == nullptr || rows == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int need_w = prim == PRIM_PLANAR ? (precomp ? 35 : (full ? 17 : 10))
                                         : (prim == PRIM_SPHERE && fold ? 12
                                                                        : 10);
  if (row_w < need_w) return (int)cudaErrorInvalidValue;
  const long long smem =
      16LL * (NODE_F4 * (long long)n_nodes +
              row_f4(prim, precomp != 0) * (long long)n_rows);
  if (shared && smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // No rays: nothing to launch (an empty output may have a null pointer).
  if (n == 0) return (int)cudaSuccess;
  if (fold && out.aux == nullptr) return (int)cudaErrorInvalidValue;
  const Params p{reinterpret_cast<const float4*>(tab), rows, n_nodes, n_rows,
                 row_w, n, leaf_size, t_min};
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define ART_LAUNCH(P, F, U, C)                                              \
  return (int)(shared ? launch<P, F, U, C, true>(p, r, out, tly, block, s)  \
                      : launch<P, F, U, C, false>(p, r, out, tly, block, s))
  if (prim == PRIM_PLANAR) {
    if (!fold) {
      if (full) return (int)cudaErrorInvalidValue;
      if (precomp) ART_LAUNCH(PRIM_PLANAR, false, false, true);
      ART_LAUNCH(PRIM_PLANAR, false, false, false);
    }
    if (full) {
      if (precomp) ART_LAUNCH(PRIM_PLANAR, true, true, true);
      ART_LAUNCH(PRIM_PLANAR, true, true, false);
    }
    if (precomp) ART_LAUNCH(PRIM_PLANAR, true, false, true);
    ART_LAUNCH(PRIM_PLANAR, true, false, false);
  }
  if (full || precomp) return (int)cudaErrorInvalidValue;
  if (prim == PRIM_SPHERE) {
    if (fold) ART_LAUNCH(PRIM_SPHERE, true, false, false);
    ART_LAUNCH(PRIM_SPHERE, false, false, false);
  }
  if (!fold) ART_LAUNCH(PRIM_RECT, false, false, false);
#undef ART_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The closest hit of n rays on `stream`: tab the compact tables (n_nodes
// nodes, then n_rows leaf-order rows of the layout of prim and precomp), in
// shared memory per block (shared = 1) or read from device memory; rows the
// wide rows [n_rows][row_w] (the winner's code and fold columns); ray
// components and times [n], init_t [n], init_idx [n]; outputs t [n], code
// [n], hit [n] (0/1 bytes) and, with fold, aux [5, 6 or 8][n]; block threads a
// block, one ray per thread.  prim 0 planar, 1 sphere, 2 rect.
#define ART_ARGS                                                              \
  const float *tab, int shared, const float *rows, int n_nodes, int n_rows,  \
      int row_w, const float *ox, const float *oy, const float *oz,           \
      const float *dx, const float *dy, const float *dz, const float *time,   \
      const float *init_t, const int *init_idx, int n, int leaf_size,         \
      float t_min, int prim, int fold, int full, int precomp, int block,      \
      float *out_t, int *out_code, uint8_t *out_hit, float *out_aux
#define ART_PASS                                                            \
  tab, shared, rows, n_nodes, n_rows, row_w,                                \
      Rays{ox, oy, oz, dx, dy, dz, time, init_t, init_idx}, n, leaf_size,   \
      t_min, prim, fold, full, precomp, block,                              \
      Out{out_t, out_code, out_hit, out_aux}

#ifdef ART_COUNT
// The counting instance (see the header): also adds the TALLIES totals
// (slab tests, slab warp steps, their active lanes, leaf row tests, leaf
// warp steps, their active lanes) into totals and writes each block's start
// and end %globaltimer into times [grid][2].
extern "C" int art_bvh_count(ART_ARGS, unsigned long long* totals,
                             unsigned long long* times, void* stream_ptr) {
  if (totals == nullptr || times == nullptr) return (int)cudaErrorInvalidValue;
  return launch_any(ART_PASS, Tallies{totals, times}, stream_ptr);
}
#else
extern "C" int art_bvh_closest_hit(ART_ARGS, void* stream_ptr) {
  return launch_any(ART_PASS, Tallies{nullptr, nullptr}, stream_ptr);
}
#endif

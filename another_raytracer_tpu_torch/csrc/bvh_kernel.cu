// BVH closest-hit kernel for NVIDIA Hopper (sm_90a): one thread per ray,
// a stackless walk of the flat escape-index tree.
//
// Replaces: another_raytracer_tpu/ops/pallas/bvh_kernel.py::bvh_closest_hit
// (body _kernel), reached from ops/intersect.py::_fold_bvh for every BVH'd
// primitive kind: prim 'planar' (triangles and quad-split transformed
// rects; 16- or 35-column rows, optional winner-record folds and
// precomputed leaf geometry), 'sphere' (world-baked, moving; optional
// fold of the outward normal, material and has_uv) and 'rect' (identity
// axis rects).  Same inputs and outputs: per ray the closest t, the winning
// row's code (id * 4 + kind; init_idx copied through where not improved),
// the improved flag and the fold outputs (zeros where not improved).
//
// The TPU kernel walks the tree with ONE cursor per block of rays (packet
// DFS): at node j every lane runs the slab test, the block enters the
// subtree if any lane hit the box, and a lane's leaf tests are masked by its
// own box test.  Child boxes nest inside their parents and a lane's best t
// only shrinks, so a lane that missed a box misses every box below it: the
// leaves a lane tests, and their order, are those of its own walk.  Here
// each thread walks on its own: on a box hit it goes to j + 1 (and tests a
// leaf's rows in leaf order with the strict t < best_t rule, so the earlier
// row keeps a tie), on a miss it jumps to the escape index.  Same
// primitives, same order, same winner (tests/test_torch_bvh.py holds this
// against the Pallas kernel in interpret mode).
//
// What bounds it on this card: the walk is latency-bound, not bandwidth- or
// ALU-bound.  Each node visit is a dependent chain (load the node, test the
// box, pick the next node), neighbouring rays of a warp diverge to other
// nodes, and a leaf visit streams its rows.  The data is small (the random
// scene's rows are ~62 KB, a 10k-triangle mesh's ~1.4 MB) and stays in L1 /
// L2.  What the design does about it: nodes and rows are read through the
// read-only data cache (__ldg) straight from global memory, ray state stays
// in registers, and one warp's rays are neighbouring pixels (the render
// traces in Morton order), so their walks mostly coincide.  Keeping a small
// tree in shared memory, and wider node loads, are later work.
//
// Variants are template instances of one kernel: PRIM (planar / sphere /
// rect), FOLD (winner-record fold), FULL (planar: also texcoords and
// material), PRECOMP (planar: read the precomputed leaf geometry).
// leaf_size is a runtime loop bound; t_min is a launch argument, fixed per
// call (the wrapper refuses a tensor).
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

namespace {

constexpr float BIG = 3e37f;
constexpr int META_SCALE = 64;
constexpr int PRIM_PLANAR = 0, PRIM_SPHERE = 1, PRIM_RECT = 2;

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

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = c < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(c) < 1e-20f ? tiny : c);
}

template <int PRIM, bool FOLD, bool FULL, bool PRECOMP>
__global__ void __launch_bounds__(128)
bvh_kernel(const float* __restrict__ nodes, int n_nodes,
           const float* __restrict__ rows, int n_rows, int row_w, Rays r,
           int n, int leaf_size, float t_min, Out out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = r.ox[i], oy = r.oy[i], oz = r.oz[i];
  const float dx = r.dx[i], dy = r.dy[i], dz = r.dz[i];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float time = r.time[i];
  float best_t = r.init_t[i];
  int best_i = r.init_idx[i];
  bool improved = false;
  // Fold outputs: planar (nx, ny, nz, u, v, tu, tv, mat), sphere
  // (nx, ny, nz, mat, has_uv).
  float f0 = 0.f, f1 = 0.f, f2 = 0.f, f3 = 0.f, f4 = 0.f, f5 = 0.f, f6 = 0.f,
        f7 = 0.f;
  float a_vec = 0.f, inv_a = 0.f;
  if (PRIM == PRIM_SPHERE) {
    a_vec = dx * dx + dy * dy + dz * dz;
    inv_a = 1.0f / (a_vec > 0.0f ? a_vec : 1.0f);
  }

  int j = 0;
  while (j < n_nodes) {
    const float* nd = nodes + 8 * (size_t)j;
    float tn = t_min, tf = best_t;
    {
      const float a = (ld(nd + 0) - ox) * ix, b = (ld(nd + 3) - ox) * ix;
      tn = fmaxf(tn, fminf(a, b));
      tf = fminf(tf, fmaxf(a, b));
    }
    {
      const float a = (ld(nd + 1) - oy) * iy, b = (ld(nd + 4) - oy) * iy;
      tn = fmaxf(tn, fminf(a, b));
      tf = fminf(tf, fmaxf(a, b));
    }
    {
      const float a = (ld(nd + 2) - oz) * iz, b = (ld(nd + 5) - oz) * iz;
      tn = fmaxf(tn, fminf(a, b));
      tf = fminf(tf, fmaxf(a, b));
    }
    if (!(tn < tf)) {
      j = (int)ld(nd + 6);
      continue;
    }
    const int meta = (int)ld(nd + 7);
    const int count = min(meta % META_SCALE, leaf_size);
    const int first = meta / META_SCALE;
    for (int k = 0; k < count; ++k) {
      const float* row = rows + (size_t)min(first + k, n_rows - 1) * row_w;
      float t;
      bool valid;
      if (PRIM == PRIM_PLANAR) {
        float nx, ny, nz, ndotv0, m0x, m0y, m0z, m1x, m1y, m1z, m2x, m2y, m2z,
            c0, c1, c2;
        if (PRECOMP) {
          nx = ld(row + 17); ny = ld(row + 18); nz = ld(row + 19);
          ndotv0 = ld(row + 20);
          m0x = ld(row + 21); m0y = ld(row + 22); m0z = ld(row + 23);
          m1x = ld(row + 24); m1y = ld(row + 25); m1z = ld(row + 26);
          m2x = ld(row + 27); m2y = ld(row + 28); m2z = ld(row + 29);
          c0 = ld(row + 30); c1 = ld(row + 31); c2 = ld(row + 32);
        } else {
          const float v0x = ld(row + 0), v0y = ld(row + 1), v0z = ld(row + 2);
          const float v1x = ld(row + 3), v1y = ld(row + 4), v1z = ld(row + 5);
          const float v2x = ld(row + 6), v2y = ld(row + 7), v2z = ld(row + 8);
          const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
          const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
          nx = e1y * e2z - e1z * e2y;
          ny = e1z * e2x - e1x * e2z;
          nz = e1x * e2y - e1y * e2x;
          ndotv0 = nx * v0x + ny * v0y + nz * v0z;
          // m = n x edge for the edges v1-v0, v2-v1, v0-v2.
          const float g1x = v2x - v1x, g1y = v2y - v1y, g1z = v2z - v1z;
          const float g2x = v0x - v2x, g2y = v0y - v2y, g2z = v0z - v2z;
          m0x = ny * e1z - nz * e1y;
          m0y = nz * e1x - nx * e1z;
          m0z = nx * e1y - ny * e1x;
          m1x = ny * g1z - nz * g1y;
          m1y = nz * g1x - nx * g1z;
          m1z = nx * g1y - ny * g1x;
          m2x = ny * g2z - nz * g2y;
          m2y = nz * g2x - nx * g2z;
          m2z = nx * g2y - ny * g2x;
          c0 = m0x * v0x + m0y * v0y + m0z * v0z;
          c1 = m1x * v1x + m1y * v1y + m1z * v1z;
          c2 = m2x * v2x + m2y * v2y + m2z * v2z;
        }
        const float ndotd = nx * dx + ny * dy + nz * dz;
        const float ndoto = nx * ox + ny * oy + nz * oz;
        const bool ok = ndotd != 0.0f;
        t = ok ? (ndotv0 - ndoto) / ndotd : BIG;
        const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
        const float w0 = px * m0x + py * m0y + pz * m0z - c0;
        const float w1 = px * m1x + py * m1y + pz * m1z - c1;
        const float w2 = px * m2x + py * m2y + pz * m2z - c2;
        valid = ok && w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && t > t_min &&
                t < best_t;
        if (FOLD && valid) {
          float inv_n2, inv_len;
          if (PRECOMP) {
            inv_n2 = ld(row + 33);
            inv_len = ld(row + 34);
          } else {
            const float n2 = fmaxf(nx * nx + ny * ny + nz * nz, 1e-37f);
            inv_n2 = 1.0f / n2;
            inv_len = 1.0f / sqrtf(n2);
          }
          const float uu = w1 * inv_n2, vv = w2 * inv_n2;
          f0 = nx * inv_len; f1 = ny * inv_len; f2 = nz * inv_len;
          f3 = uu; f4 = vv;
          if (FULL) {
            const float uv0u = ld(row + 10), uv0v = ld(row + 11);
            const float uv1u = ld(row + 12), uv1v = ld(row + 13);
            const float uv2u = ld(row + 14), uv2v = ld(row + 15);
            f5 = uv2u + uu * (uv0u - uv2u) + vv * (uv1u - uv2u);
            f6 = uv2v + uu * (uv0v - uv2v) + vv * (uv1v - uv2v);
            f7 = ld(row + 16);
          }
        }
      } else if (PRIM == PRIM_SPHERE) {
        const float frac = (time - ld(row + 6)) * ld(row + 7);
        const float ocx = ox - (ld(row + 0) + frac * ld(row + 3));
        const float ocy = oy - (ld(row + 1) + frac * ld(row + 4));
        const float ocz = oz - (ld(row + 2) + frac * ld(row + 5));
        const float rad = ld(row + 8);
        const float half_b = ocx * dx + ocy * dy + ocz * dz;
        const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
        const float disc = half_b * half_b - a_vec * c;
        const bool ok = disc > 0.0f;
        const float sq = sqrtf(ok ? disc : 0.0f);
        const float root1 = (-half_b - sq) * inv_a;
        const float root2 = (-half_b + sq) * inv_a;
        t = (root1 > t_min && root1 < best_t) ? root1 : root2;
        valid = ok && t > t_min && t < best_t;
        if (FOLD && valid) {
          const float inv_r = 1.0f / (rad != 0.0f ? rad : 1.0f);
          f0 = (ocx + t * dx) * inv_r;
          f1 = (ocy + t * dy) * inv_r;
          f2 = (ocz + t * dz) * inv_r;
          f3 = ld(row + 10);
          f4 = ld(row + 11);
        }
      } else {
        const float ax = ld(row + 0), kk = ld(row + 1);
        const bool is0 = ax == 0.0f, is2 = ax == 2.0f;
        const float o_ax = is0 ? ox : (is2 ? oz : oy);
        const float d_ax = is0 ? dx : (is2 ? dz : dy);
        const bool parallel = d_ax == 0.0f;
        t = parallel ? BIG : (kk - o_ax) / d_ax;
        const float pu = (is0 ? oy : ox) + t * (is0 ? dy : dx);
        const float pv = (is2 ? oy : oz) + t * (is2 ? dy : dz);
        const bool inside = pu >= ld(row + 2) && pu <= ld(row + 4) &&
                            pv >= ld(row + 3) && pv <= ld(row + 5);
        valid = inside && t > t_min && t < best_t && !parallel;
      }
      if (valid) {
        best_t = t;
        best_i = (int)ld(row + 9);
        improved = true;
      }
    }
    ++j;
  }

  out.t[i] = best_t;
  out.code[i] = best_i;
  out.hit[i] = improved ? 1 : 0;
  if (FOLD) {
    float* a = out.aux + i;
    a[0] = f0;
    a[(size_t)n] = f1;
    a[2 * (size_t)n] = f2;
    a[3 * (size_t)n] = f3;
    a[4 * (size_t)n] = f4;
    if (FULL) {
      a[5 * (size_t)n] = f5;
      a[6 * (size_t)n] = f6;
      a[7 * (size_t)n] = f7;
    }
  }
}

template <int PRIM, bool FOLD, bool FULL, bool PRECOMP>
cudaError_t launch(const float* nodes, int n_nodes, const float* rows,
                   int n_rows, int row_w, const Rays& r, int n, int leaf_size,
                   float t_min, const Out& out, int block,
                   cudaStream_t stream) {
  const int grid = (n + block - 1) / block;
  bvh_kernel<PRIM, FOLD, FULL, PRECOMP><<<grid, block, 0, stream>>>(
      nodes, n_nodes, rows, n_rows, row_w, r, n, leaf_size, t_min, out);
  return cudaGetLastError();
}

}  // namespace

// Launches the closest-hit kernel on `stream` for n rays: nodes [n_nodes][8],
// rows [n_rows][row_w] (leaf order), ray components and times [n], init_t
// [n], init_idx [n]; outputs t [n], code [n], hit [n] (0/1 bytes) and, with
// fold, aux [5 or 8][n].  prim 0 planar, 1 sphere, 2 rect.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a variant
// or shape the kernel does not take.
extern "C" int art_bvh_closest_hit(
    const float* nodes, int n_nodes, const float* rows, int n_rows, int row_w,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* time, const float* init_t,
    const int* init_idx, int n, int leaf_size, float t_min, int prim,
    int fold, int full, int precomp, int block, float* out_t, int* out_code,
    uint8_t* out_hit, float* out_aux, void* stream_ptr) {
  if (n < 0 || n_nodes < 0 || leaf_size < 1 || leaf_size >= META_SCALE ||
      block < 32 || block > 128 || block % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_nodes > 0 && n_rows < 1) return (int)cudaErrorInvalidValue;
  const int need_w = prim == PRIM_PLANAR ? (precomp ? 35 : (full ? 17 : 10))
                                         : (prim == PRIM_SPHERE && fold ? 12
                                                                        : 10);
  if (row_w < need_w) return (int)cudaErrorInvalidValue;
  if (fold && out_aux == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Rays r{ox, oy, oz, dx, dy, dz, time, init_t, init_idx};
  const Out out{out_t, out_code, out_hit, out_aux};
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define ART_LAUNCH(P, F, U, C) \
  return (int)launch<P, F, U, C>(nodes, n_nodes, rows, n_rows, row_w, r, n, \
                                 leaf_size, t_min, out, block, s)
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
  if (prim == PRIM_RECT && !fold) ART_LAUNCH(PRIM_RECT, false, false, false);
#undef ART_LAUNCH
  return (int)cudaErrorInvalidValue;
}

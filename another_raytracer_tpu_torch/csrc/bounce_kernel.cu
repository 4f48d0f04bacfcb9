// The bounce kernel for NVIDIA Hopper (sm_90a): one step of the
// regenerating wavefront after the BVH closest-hit kernel K5, one thread a
// lane: the kinds no tree holds and the media's free flights, the winner's
// hit record, its texture and material, the scatter, the carry update and
// the re-arm of the lanes whose paths end.
//
// Replaces no TPU kernel: the JAX package's XLA fuses the same per-lane
// arithmetic (ops/integrator.py _advance and the regenerating step) into a
// few loop fusions, where eager PyTorch launches it as ~650-1,000
// elementwise kernels an iteration.  Reached from
// ops/integrator.py::_kernel_step_parts through ops/kernels/bounce_kernel.py
// on every CUDA step of trace_regenerative; its plain version is the eager
// step (ops/integrator.py::_eager_step_parts), which every CPU tensor and
// the differentiable trace run, followed by its re-arm (_cam_rearm).
//
// Per lane, in the eager step's order and with its arithmetic:
// * the winner: K5's (t, code) chained over the scene's trees (code -1: no
//   tree improved), then the swept spheres, rects and triangles
//   (intersect._scan_kind: the strict fold, t_max the best t on entry to the
//   kind), then the media's free flights (intersect._medium_t, one uniform
//   per medium on lanes DIM_MEDIUM + 2m);
// * the winner's hit record (intersect.make_hit_record): the sphere record
//   re-projected onto its sphere, from K5's folded centre where the sphere
//   fold is on (FOLD_SPHERE), the rect record, the triangle record or K5's
//   planar fold (FOLD_PLANAR), the medium record, then set_face_normal;
// * texture and material (shade.emit_and_scatter): solid, checker, noise
//   (K4's device code, perlin_device.cuh), image and barycentric textures;
//   lambertian, metal, dielectric, diffuse light and isotropic, with the
//   draws kernel's threefry (threefry.cuh);
// * the carry update of the regenerating step: miss -> background, emission,
//   throughput, origin, direction, bounce, the ended lanes' totals, their
//   next sample; the segments, the sphere winners and (MEDIA) the medium
//   winners, each a scatter in a medium, by integer atomics (exact, free
//   of order);
// * the re-arm (integrator._cam_rearm): a lane that ends with samples left
//   gets its next sample's primary ray (camera.generate_rays, from the
//   camera in Params), throughput 1 and bounce 0, so the host reads nothing
//   after the step.
//
// What bounds it on this card: at the main path's widths (10^5 lanes) the
// bytes of the carry (~90 a lane in and out) and the divergent per-kind
// branches; a narrow stage (6,144 lanes) is launch-bound.  What the design
// does about it:
// * One launch replaces the hundreds the eager step makes; the carry is read
//   once and written once, in place in the stage's graph buffers.
// * The scene's tables are packed once per scene (bounce_kernel.py's
//   pack_tables, SceneData.bounce_tables): one row a primitive, material,
//   texture, medium and transform, float rows in 16-byte multiples and int
//   rows of four, read with vector loads; the atlas and K4's Perlin tables
//   are read where the scene keeps them.
// * Template instances by the fold K5 gives (FOLD) and by media (MEDIA); a
//   lane runs only its own material's and texture's branch, so kinds the
//   scene lacks cost no time.
// * Block counts: each warp's ballots summed in shared memory, one atomic a
//   block per counter.
//
// Numerics: built with -fmad=false (ops/kernels/_build.py) and IEEE division
// and sqrt.  Each operation rounds as the eager step's and re-arm's on the
// card:
// float64 sqrt, sin, cos, log and pow(u, 1/3) cast to float where ops/vec3.py
// takes them through float64; acosf and atan2f where the record takes
// torch.acos / atan2 in float32; x / c for a Python float c as
// x * (1 / c) in float32, which is how PyTorch's CUDA division by a host
// scalar computes it; torch.minimum / maximum / clamp's NaN rules; sums in
// the eager order.  The card tests hold the carry bit for bit against the
// eager step followed by its re-arm (tests/test_torch_bounce_cuda.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false  (ops/kernels/_build.py)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROUNDS = 13;
#include "perlin_device.cuh"
#include "threefry.cuh"

// Python floats as the eager step's float32 tensors take them.
constexpr float BIG = (float)3e37;
constexpr float MEDIUM_REHIT_EPS = (float)1e-4;
constexpr float SQUARE_MAX = (float)1e18;
constexpr float NEAR_ZERO_EPS = (float)1e-8;
constexpr float SLAB_EPS = (float)1e-20;
constexpr float U_FLOOR = (float)1e-37;
constexpr float GRAZE_FLOOR = (float)1e-12;
constexpr float TWO_PI = (float)6.283185307179586;
constexpr float PI = (float)3.141592653589793;

constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1, PRIM_TRIANGLE = 2,
              PRIM_MEDIUM = 3;
constexpr int MAT_METAL = 1, MAT_DIELECTRIC = 2, MAT_DIFFUSE_LIGHT = 3,
              MAT_ISOTROPIC = 4;
constexpr int TEX_CHECKER = 1, TEX_NOISE = 2, TEX_IMAGE = 3,
              TEX_BARYCENTRIC = 4;
constexpr int MED_SPHERE = 0;
constexpr uint32_t DIM_SCATTER_A = 0, DIM_SCATTER_B = 2, DIM_MEDIUM = 8;
constexpr uint32_t CAMERA_BOUNCE = 0xFF00, DIM_PIXEL_JITTER = 0, DIM_LENS = 2,
                   DIM_TIME = 4;
constexpr int FOLD_NONE = 0, FOLD_PLANAR = 1, FOLD_SPHERE = 2;
// Float4s of one packed Perlin table set (perlin_kernel.py's TABLE_BYTES).
constexpr int PERLIN_F4 = PERLIN_N + 3 * PERLIN_N * 2 / 16;
constexpr int BLOCK = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int64_t MASK32 = 0xFFFFFFFFll;

// The launch's arguments, field for field bounce_kernel.py's Params (every
// field 8 bytes, so the two layouts agree).
struct Params {
  // The carry in and out (out may be in): o, d, throughput, total,
  // path_rad as 15 float columns, then alive, sample and bounce.
  const float* in_f[15];
  const bool* in_alive;
  const int64_t* in_sample;
  const int64_t* in_bounce;
  float* out_f[15];
  bool* out_alive;
  int64_t* out_sample;
  int64_t* out_bounce;
  const float* in_time;
  float* out_time;  // may be in_time
  const int64_t* pix;
  int64_t* segments;     // 0-d, added to
  int64_t* sphere_hits;  // 0-d, added to; null on a scene without spheres
  int64_t* medium_scatters;  // 0-d, added to; null on a scene without media
  const int64_t* seed_at;
  // K5's chained winner (null on a scene without trees) and its fold.
  const float* k5_t;
  const int* k5_code;
  const float* aux;  // [rows][n]
  // The packed scene tables (bounce_kernel.py's pack_tables).
  const float4 *xf, *sph, *rect, *tri, *med, *mat, *tex, *bg;
  const int4 *sph_i, *rect_i, *tri_i, *med_i, *mat_i, *tex_i, *img_i;
  const float* atlas;     // [P, 3]
  const float4* perlin;   // [Q][PERLIN_F4]
  int64_t n, seed, max_depth, stride, limit;
  int64_t n_xf, n_sph, n_rect, n_tri, n_med, n_mat, n_tex, n_img, n_perlin;
  int64_t sweep_sph, sweep_rect, sweep_tri;
  double t_min;
  // The camera (ops/camera.py's Camera, its float32 values held exactly):
  // the image's width and height, the lens and the shutter switches
  // (uniform across a launch), then the vectors and scalars.
  int64_t width, height, lens, shutter;
  double origin[3], lower_left[3], horizontal[3], vertical[3], cam_u[3],
      cam_v[3];
  double lens_radius, time0, time1;
};

// Float rows (float4s a row) and int rows (one int4 a row) of the tables.
constexpr int XF_F4 = 3, SPH_F4 = 3, RECT_F4 = 2, TRI_F4 = 4, MED_F4 = 2,
              TEX_F4 = 3;

struct V {
  float x, y, z;
};
__device__ __forceinline__ V operator+(V a, V b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V operator-(V a, V b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V operator*(V a, V b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V operator*(V a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V a, V b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V cross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V sel(bool c, V a, V b) {
  return c ? a : b;
}
__device__ __forceinline__ V xyz(float4 f) { return {f.x, f.y, f.z}; }

// ops/vec3.py's float64 roundings.
__device__ __forceinline__ float sqrt_(float x) {
  return (float)sqrt((double)x);
}
__device__ __forceinline__ float sin_(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos_(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float log_(float x) { return (float)log((double)x); }
__device__ __forceinline__ float cbrt_(float x) {
  return (float)pow((double)x, 1.0 / 3.0);
}
__device__ __forceinline__ float length(V a) { return sqrt_(dot(a, a)); }
// vec3.unit: a * (1 / where(n > 0, n, 1)).
__device__ __forceinline__ V unit(V a) {
  const float n = length(a);
  return a * (1.0f / (n > 0.0f ? n : 1.0f));
}

// torch.minimum / maximum (NaN in, NaN out) and clamp (NaN passes).
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ int64_t clampi(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// intersect._axis_component.
__device__ __forceinline__ float comp(V v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

// A world-from-object transform (row-major rotation R, translation tr).
struct Xf {
  V r0, r1, r2, tr;
};
__device__ __forceinline__ Xf load_xf(const Params& p, int64_t id) {
  const float4 a = p.xf[XF_F4 * id], b = p.xf[XF_F4 * id + 1],
               c = p.xf[XF_F4 * id + 2];
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, {c.y, c.z, c.w}};
}
// Object-space ray (intersect._ray_to_object_*): o' = R^T (o - tr),
// d' = R^T d, each component a dot with a column of R.
__device__ __forceinline__ void to_object(const Xf& x, V o, V d, V& ob,
                                          V& db) {
  const V c0 = {x.r0.x, x.r1.x, x.r2.x}, c1 = {x.r0.y, x.r1.y, x.r2.y},
          c2 = {x.r0.z, x.r1.z, x.r2.z};
  const V oc = o - x.tr;
  ob = {dot(c0, oc), dot(c1, oc), dot(c2, oc)};
  db = {dot(c0, d), dot(c1, d), dot(c2, d)};
}
// vec3.rotate with the rows of R.
__device__ __forceinline__ V rotate(const Xf& x, V v) {
  return {dot(x.r0, v), dot(x.r1, v), dot(x.r2, v)};
}

// The sweeps' object rays (intersect._object_rays_bn): the world ray where
// the scene has the identity transform alone.
__device__ __forceinline__ void sweep_rays(const Params& p, int64_t xf, V o,
                                           V d, V& ob, V& db) {
  if (p.n_xf == 1) {
    ob = o;
    db = d;
  } else {
    to_object(load_xf(p, xf), o, d, ob, db);
  }
}

// --------------------------------------------------------------------------
// The swept kinds (intersect._sphere_t, _rect_t, _triangle_t)
// --------------------------------------------------------------------------

struct Sphere {
  V c0, c1;
  float t0, t1, r, has_uv;
};
__device__ __forceinline__ Sphere load_sphere(const Params& p, int64_t j) {
  const float4 a = p.sph[SPH_F4 * j], b = p.sph[SPH_F4 * j + 1],
               c = p.sph[SPH_F4 * j + 2];
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, b.z, b.w, c.x, c.y};
}

__device__ __forceinline__ bool sphere_t(const Params& p, int64_t j, V o, V d,
                                         float time, float t_min, float t_max,
                                         float& root) {
  const Sphere s = load_sphere(p, j);
  V ob, db;
  sweep_rays(p, p.sph_i[j].y, o, d, ob, db);
  const float frac = (time - s.t0) / (s.t1 - s.t0);
  const V cdel = s.c1 - s.c0;
  const V center = {s.c0.x + frac * cdel.x, s.c0.y + frac * cdel.y,
                    s.c0.z + frac * cdel.z};
  const V oc = ob - center;
  const float a = dot(db, db);
  const float half_b = dot(oc, db);
  const float c = dot(oc, oc) - s.r * s.r;
  const float disc = half_b * half_b - a * c;
  const bool hit_disc = disc > 0.0f;
  const float sqrtd = sqrt_(hit_disc ? disc : 1.0f);
  const float root1 = (-half_b - sqrtd) / a;
  const float root2 = (-half_b + sqrtd) / a;
  const bool r1_ok = (root1 > t_min) & (root1 < t_max);
  root = r1_ok ? root1 : root2;
  return hit_disc & (root > t_min) & (root < t_max);
}

__device__ __forceinline__ bool rect_t(const Params& p, int64_t j, V o, V d,
                                       float t_min, float t_max, float& t) {
  const float4 f = p.rect[RECT_F4 * j];  // k, lo_u, lo_v, hi_u
  const float hi_v = p.rect[RECT_F4 * j + 1].x;
  const int4 ri = p.rect_i[j];  // axis, mat, xf
  const int axis = ri.x;
  V ob, db;
  sweep_rays(p, ri.z, o, d, ob, db);
  const float o_ax = comp(ob, axis), d_ax = comp(db, axis);
  const bool parallel = d_ax == 0.0f;
  t = parallel ? BIG : (f.x - o_ax) / (parallel ? 1.0f : d_ax);
  const int au = axis == 0 ? 1 : 0, av = axis == 2 ? 1 : 2;
  const float pu = comp(ob, au) + t * comp(db, au);
  const float pv = comp(ob, av) + t * comp(db, av);
  const bool inside = (pu >= f.y) & (pu <= f.w) & (pv >= f.z) & (pv <= hi_v);
  return inside & (t > t_min) & (t < t_max) & !parallel;
}

struct Tri {
  V v0, v1, v2;
  float uv[6];
};
__device__ __forceinline__ Tri load_tri(const Params& p, int64_t j) {
  const float4 a = p.tri[TRI_F4 * j], b = p.tri[TRI_F4 * j + 1],
               c = p.tri[TRI_F4 * j + 2], e = p.tri[TRI_F4 * j + 3];
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x},
          {c.y, c.z, c.w, e.x, e.y, e.z}};
}

__device__ __forceinline__ bool triangle_t(const Params& p, int64_t j, V o,
                                           V d, float t_min, float t_max,
                                           float& t) {
  const Tri tr = load_tri(p, j);
  V ob, db;
  sweep_rays(p, p.tri_i[j].y, o, d, ob, db);
  const V n = cross(tr.v1 - tr.v0, tr.v2 - tr.v0);
  const float ndotd = dot(n, db);
  const float ndoto = dot(n, ob);
  const bool parallel = ndotd == 0.0f;
  t = parallel ? BIG : (dot(n, tr.v0) - ndoto) / (parallel ? 1.0f : ndotd);
  const V pp = ob + db * t;
  const float w0 = dot(n, cross(tr.v1 - tr.v0, pp - tr.v0));
  const float w1 = dot(n, cross(tr.v2 - tr.v1, pp - tr.v1));
  const float w2 = dot(n, cross(tr.v0 - tr.v2, pp - tr.v2));
  return (w0 >= 0.0f) & (w1 >= 0.0f) & (w2 >= 0.0f) & (t > t_min) &
         (t < t_max) & !parallel;
}

// --------------------------------------------------------------------------
// Media (intersect._medium_interval, _medium_t)
// --------------------------------------------------------------------------

__device__ __forceinline__ void slab(float dc, float oc, float lo, float hi,
                                     float& near, float& far) {
  const float eps = dc < 0.0f ? -SLAB_EPS : SLAB_EPS;
  const float inv = 1.0f / (fabsf(dc) < SLAB_EPS ? eps : dc);
  const float ta = (lo - oc) * inv;
  const float tb = (hi - oc) * inv;
  near = tmin(ta, tb);
  far = tmax(ta, tb);
}

// Boundary entry and exit of medium m; returns boundary_hit.
__device__ __forceinline__ bool medium_interval(const Params& p, int64_t m,
                                                V o, V d, float& t1,
                                                float& t2) {
  const int4 mi = p.med_i[m];  // kind, mat, xf
  const float4 fa = p.med[MED_F4 * m], fb = p.med[MED_F4 * m + 1];
  const V a3 = xyz(fa), b3 = {fa.w, fb.x, fb.y};
  V ob, db;
  sweep_rays(p, mi.z, o, d, ob, db);
  bool ok;
  if (mi.x == MED_SPHERE) {
    const V oc = ob - a3;
    const float qa = dot(db, db);
    const float half_b = dot(oc, db);
    const float qc = dot(oc, oc) - b3.x * b3.x;
    const float disc = half_b * half_b - qa * qc;
    ok = disc > 0.0f;
    const float sq = sqrt_(ok ? disc : 1.0f);
    t1 = (-half_b - sq) / qa;
    t2 = (-half_b + sq) / qa;
  } else {
    float nx, xx, ny, xy, nz, xz;
    slab(db.x, ob.x, a3.x, b3.x, nx, xx);
    slab(db.y, ob.y, a3.y, b3.y, ny, xy);
    slab(db.z, ob.z, a3.z, b3.z, nz, xz);
    t1 = tmax(tmax(nx, ny), nz);
    t2 = tmin(tmin(xx, xy), xz);
    ok = t1 < t2;
  }
  return ok & (t2 > t1 + MEDIUM_REHIT_EPS);
}

// --------------------------------------------------------------------------
// The hit record (intersect.make_hit_record)
// --------------------------------------------------------------------------

struct Rec {
  V p, n;
  int64_t mat;
  float u, v, tu, tv;
};

// intersect._onto_sphere.
__device__ __forceinline__ V onto_sphere(V off, float r) {
  const bool fits = (fabsf(off.x) < SQUARE_MAX) & (fabsf(off.y) < SQUARE_MAX) &
                    (fabsf(off.z) < SQUARE_MAX);
  const V safe = fits ? off : V{1.0f, 1.0f, 1.0f};
  const float len2 = dot(safe, safe);
  const bool ok = fits & (len2 > 0.0f);
  const float scale = fabsf(r) / sqrt_(ok ? len2 : 1.0f);
  return ok ? safe * scale : off;
}

// intersect._sphere_uv: x / c as PyTorch's CUDA division by a host scalar.
__device__ __forceinline__ void sphere_uv(V n, float has_uv, float& u,
                                          float& v) {
  const float theta = acosf(clampf(-n.y, -1.0f, 1.0f));
  const float phi = atan2f(-n.z, n.x) + PI;
  u = (phi * (1.0f / TWO_PI)) * has_uv;
  v = (theta * (1.0f / PI)) * has_uv;
}

// intersect._sphere_record: the gathered sphere, its root picked again.
__device__ __forceinline__ void sphere_record(const Params& p, V o, V d,
                                              float time, float t,
                                              int64_t idx, Rec& rec) {
  const int64_t ii = clampi(idx, p.n_sph - 1);
  const Sphere s = load_sphere(p, ii);
  const int4 si = p.sph_i[ii];  // mat, xf
  const Xf x = load_xf(p, si.y);
  V ob, db;
  to_object(x, o, d, ob, db);
  const float frac = (time - s.t0) / (s.t1 - s.t0);
  const V center = s.c0 + (s.c1 - s.c0) * frac;
  const V oc = ob - center;
  const float a = dot(db, db);
  const float half_b = dot(oc, db);
  const float c = dot(oc, oc) - s.r * s.r;
  const float disc = half_b * half_b - a * c;
  const float sq = sqrt_(disc > 0.0f ? disc : 1.0f);
  const float root1 = (-half_b - sq) / a;
  const float root2 = (-half_b + sq) / a;
  const bool pick1 = fabsf(root1 - t) <= fabsf(root2 - t);
  t = disc > 0.0f ? (pick1 ? root1 : root2) : t;
  const V off = ob + db * t - center;
  const V on = onto_sphere(off, s.r);
  const V n_obj = on * (1.0f / s.r);
  sphere_uv(n_obj, s.has_uv, rec.u, rec.v);
  rec.tu = rec.u;
  rec.tv = rec.v;
  rec.n = rotate(x, n_obj);
  if (p.n_xf == 1) {
    rec.p = o + d * t + (on - off);
  } else {
    rec.p = rotate(x, center + on) + x.tr;
  }
  rec.mat = si.x;
}

// intersect._sphere_record_aux: K5's folded centre, radius, mat, has_uv.
__device__ __forceinline__ void sphere_record_aux(const Params& p, int64_t i,
                                                  V o, V d, float t,
                                                  Rec& rec) {
  const int64_t n = p.n;
  const V center = {p.aux[i], p.aux[n + i], p.aux[2 * n + i]};
  const float r = p.aux[3 * n + i];
  rec.mat = clampi((int64_t)p.aux[4 * n + i], p.n_mat - 1);
  const V pt = o + d * t;
  const V off = pt - center;
  const V on = onto_sphere(off, r);
  rec.n = on * (1.0f / r);
  sphere_uv(rec.n, p.aux[5 * n + i], rec.u, rec.v);
  rec.tu = rec.u;
  rec.tv = rec.v;
  rec.p = pt + (on - off);
}

// intersect._rect_record.
__device__ __forceinline__ void rect_record(const Params& p, V o, V d, float t,
                                            int64_t idx, Rec& rec) {
  const int64_t ii = clampi(idx, p.n_rect - 1);
  const float4 f = p.rect[RECT_F4 * ii];  // k, lo_u, lo_v, hi_u
  const float hi_v = p.rect[RECT_F4 * ii + 1].x;
  const int4 ri = p.rect_i[ii];  // axis, mat, xf
  const int axis = ri.x;
  const Xf x = load_xf(p, ri.z);
  V ob, db;
  to_object(x, o, d, ob, db);
  const float o_ax = comp(ob, axis), d_ax = comp(db, axis);
  const bool ok = d_ax != 0.0f;
  t = ok ? (f.x - o_ax) / (ok ? d_ax : 1.0f) : t;
  const V p_obj = ob + db * t;
  const int au = axis == 0 ? 1 : 0, av = axis == 2 ? 1 : 2;
  const float pu = comp(p_obj, au), pv = comp(p_obj, av);
  rec.u = (pu - f.y) / (f.w - f.y);
  rec.v = (pv - f.z) / (hi_v - f.z);
  rec.tu = rec.u;
  rec.tv = rec.v;
  const V n_obj = {axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
                   axis == 2 ? 1.0f : 0.0f};
  rec.n = rotate(x, n_obj);
  rec.p = o + d * t;
  rec.mat = ri.y;
}

// intersect._triangle_record.
__device__ __forceinline__ void triangle_record(const Params& p, V o, V d,
                                                float t, int64_t idx,
                                                Rec& rec) {
  const int64_t ii = clampi(idx, p.n_tri - 1);
  const Tri tr = load_tri(p, ii);
  const int4 ti = p.tri_i[ii];  // mat, xf
  V ob = o, db = d;
  Xf x;
  if (p.n_xf != 1) {
    x = load_xf(p, ti.y);
    to_object(x, o, d, ob, db);
  }
  const V n = cross(tr.v1 - tr.v0, tr.v2 - tr.v0);
  const float ndotd = dot(n, db);
  const bool ok = ndotd != 0.0f;
  t = ok ? (dot(n, tr.v0) - dot(n, ob)) / (ok ? ndotd : 1.0f) : t;
  const V p_obj = ob + db * t;
  const float n2 = dot(n, n);
  const float u = dot(n, cross(tr.v2 - tr.v1, p_obj - tr.v1)) / n2;
  const float v = dot(n, cross(tr.v0 - tr.v2, p_obj - tr.v2)) / n2;
  const float w = 1.0f - u - v;
  rec.u = u;
  rec.v = v;
  rec.tu = u * tr.uv[0] + v * tr.uv[2] + w * tr.uv[4];
  rec.tv = u * tr.uv[1] + v * tr.uv[3] + w * tr.uv[5];
  rec.n = unit(p.n_xf == 1 ? n : rotate(x, n));
  rec.p = o + d * t;
  rec.mat = ti.x;
}

// intersect._triangle_record_aux: K5's planar fold (n, u, v, tu, tv, mat).
__device__ __forceinline__ void triangle_record_aux(const Params& p,
                                                    int64_t i, V o, V d,
                                                    float t, Rec& rec) {
  const int64_t n = p.n;
  rec.n = {p.aux[i], p.aux[n + i], p.aux[2 * n + i]};
  rec.u = p.aux[3 * n + i];
  rec.v = p.aux[4 * n + i];
  rec.tu = p.aux[5 * n + i];
  rec.tv = p.aux[6 * n + i];
  rec.mat = clampi((int64_t)p.aux[7 * n + i], p.n_mat - 1);
  rec.p = o + d * t;
}

// intersect._medium_record, given the winner's boundary entry t1 and uniform
// u as its one-hot sum over the media takes them.
__device__ __forceinline__ void medium_record(const Params& p, V o, V d,
                                              int64_t idx, float t1, float u,
                                              float t_min, Rec& rec) {
  const int64_t ii = clampi(idx, p.n_med - 1);
  if (p.n_med > 1) {  // where(sel, x, 0).sum(dim=1)
    t1 = t1 + 0.0f;
    u = u + 0.0f;
  }
  const float r1 = tmax(tmax(t1, t_min), 0.0f);
  const float hd = p.med[MED_F4 * ii + 1].z * log_(tmax(u, U_FLOOR));
  const float t = r1 + hd / length(d);
  rec.p = o + d * t;
  rec.n = {1.0f, 0.0f, 0.0f};
  rec.mat = p.med_i[ii].y;
  rec.u = rec.v = rec.tu = rec.tv = 0.0f;
}

// --------------------------------------------------------------------------
// Textures and materials (shade.texture_value, shade.emit_and_scatter)
// --------------------------------------------------------------------------

__device__ __forceinline__ V texture_value(const Params& p, int64_t tex,
                                           const Rec& rec) {
  const int64_t tid = clampi(tex, p.n_tex - 1);
  const int4 ti = p.tex_i[tid];  // kind, aux
  const float4 fa = p.tex[TEX_F4 * tid], fb = p.tex[TEX_F4 * tid + 1];
  switch (ti.x) {
    case TEX_CHECKER: {
      const float sines =
          sin_(10.0f * rec.p.x) * sin_(10.0f * rec.p.y) * sin_(10.0f * rec.p.z);
      return sines < 0.0f ? V{fa.w, fb.x, fb.y} : xyz(fa);
    }
    case TEX_NOISE: {
      const float scale = p.tex[TEX_F4 * tid + 2].y;
      const V q = rec.p * scale;
      const int64_t set = clampi(ti.y, p.n_perlin - 1);
      const float noise = perlin_at(p.perlin + set * PERLIN_F4, q.x, q.y, q.z);
      const float gray = 0.5f * (1.0f + noise);
      return {gray, gray, gray};
    }
    case TEX_IMAGE: {
      const int64_t img = clampi(ti.y, p.n_img - 1);
      const int4 ii = p.img_i[img];  // off, w, h
      const int64_t w = ii.y, h = ii.z;
      const float cu = clampf(rec.tu, 0.0f, 1.0f);
      const float cv = 1.0f - clampf(rec.tv, 0.0f, 1.0f);
      const int64_t i = min((int64_t)(int)(cu * (float)w), w - 1);
      const int64_t j = min((int64_t)(int)(cv * (float)h), h - 1);
      const float* texel = p.atlas + 3 * ((int64_t)ii.x + j * w + i);
      return {texel[0], texel[1], texel[2]};
    }
    case TEX_BARYCENTRIC: {
      const float4 fc = p.tex[TEX_F4 * tid + 2];
      const V ca = xyz(fa), cb = {fa.w, fb.x, fb.y}, cc = {fb.z, fb.w, fc.x};
      return ca * rec.u + cb * rec.v + cc * (1.0f - rec.u - rec.v);
    }
    default:
      return xyz(fa);
  }
}

// vec3.reflect and vec3.refract.
__device__ __forceinline__ V reflect(V v, V n) {
  return v - n * (2.0f * dot(v, n));
}
__device__ __forceinline__ V refract(V uv, V n, float eta) {
  const float cos_theta = clamp_max(dot(-uv, n), 1.0f);
  const V perp = (uv + n * cos_theta) * eta;
  const V par =
      n * (-sqrt_(clamp_min(fabsf(1.0f - dot(perp, perp)), GRAZE_FLOOR)));
  return perp + par;
}

// The scatter of a hit lane: direction, attenuation, emission, ok.
__device__ __forceinline__ bool scatter(const Params& p, const Rec& rec,
                                        bool front, V d_in, uint32_t seed,
                                        uint32_t pix, uint32_t sample,
                                        uint32_t bounce, V& dir, V& att,
                                        V& emit) {
  const int4 mi = p.mat_i[rec.mat];  // kind, tex
  const int kind = mi.x;
  const V n = rec.n;
  float u1, u2;
  uniform2(seed, pix, sample, bounce, DIM_SCATTER_A, u1, u2);
  // vec3.unit_vector_from_uniforms.
  const float z = 1.0f - 2.0f * u1;
  const float r = sqrt_(clamp_min(1.0f - z * z, 0.0f));
  const float phi = TWO_PI * u2;
  const V rand_unit = {r * cos_(phi), r * sin_(phi), z};
  const V lam_dir = n + rand_unit;
  const bool near_zero = (fabsf(lam_dir.x) < NEAR_ZERO_EPS) &
                         (fabsf(lam_dir.y) < NEAR_ZERO_EPS) &
                         (fabsf(lam_dir.z) < NEAR_ZERO_EPS);
  dir = near_zero ? n : lam_dir;
  bool ok = true;
  if (kind == MAT_METAL || kind == MAT_DIELECTRIC || kind == MAT_ISOTROPIC) {
    float u3, u4;
    uniform2(seed, pix, sample, bounce, DIM_SCATTER_B, u3, u4);
    const V in_ball = rand_unit * cbrt_(u3);
    if (kind == MAT_ISOTROPIC) {
      dir = in_ball;
    } else {
      const V unit_d = unit(d_in);
      if (kind == MAT_METAL) {
        const float fuzz = p.mat[rec.mat].x;
        dir = reflect(unit_d, n) + in_ball * fuzz;
        ok = dot(dir, n) > 0.0f;
      } else {
        const float ir = p.mat[rec.mat].y;
        const float ratio = front ? 1.0f / ir : ir;
        const float cos_theta = clamp_max(dot(-unit_d, n), 1.0f);
        const float sin_theta =
            sqrt_(clamp_min(1.0f - cos_theta * cos_theta, GRAZE_FLOOR));
        const bool cannot_refract = ratio * sin_theta > 1.0f;
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;
        const float c = 1.0f - cos_theta;
        const float reflectance = r0 + (1.0f - r0) * (c * ((c * c) * (c * c)));
        dir = (cannot_refract | (reflectance > u4)) ? reflect(unit_d, n)
                                                     : refract(unit_d, n, ratio);
      }
    }
  }
  const V tex_val = texture_value(p, mi.y, rec);
  att = kind == MAT_DIELECTRIC ? V{1.0f, 1.0f, 1.0f} : tex_val;
  emit = V{0.0f, 0.0f, 0.0f};
  if (kind == MAT_DIFFUSE_LIGHT) {
    ok = false;
    emit = tex_val;
  }
  return ok;
}

// --------------------------------------------------------------------------
// The re-arm's camera ray (camera.generate_rays)
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t launch_seed(const Params& p) {
  return (uint32_t)(p.seed_at != nullptr ? *p.seed_at : p.seed);
}

__device__ __forceinline__ V cam_vec(const double (&a)[3]) {
  return {(float)a[0], (float)a[1], (float)a[2]};
}

// The primary ray of (pix, sample): origin, direction and time, as the
// eager re-arm computes them on the card: x / c for a host scalar c as
// x * (1 / c), base = lower_left - origin, (base + hor s) + ver t, the lens
// disk of vec3.in_unit_disk_from_uniforms, time0 + tu (time1 - time0).  The
// lens disk comes first: in this order every instance builds in at most 80
// registers without a spill (the other order spills 4 bytes in one).
__device__ __forceinline__ void camera_ray(const Params& p, uint32_t seed,
                                           int64_t pix, uint32_t sample, V& o,
                                           V& d, float& time) {
  float rdx = 0.0f, rdy = 0.0f;
  if (p.lens) {
    float lu, lv;
    uniform2(seed, (uint32_t)pix, sample, CAMERA_BOUNCE, DIM_LENS, lu, lv);
    const float r = sqrt_(lu), phi = TWO_PI * lv;
    const float radius = (float)p.lens_radius;
    rdx = radius * (r * cos_(phi));
    rdy = radius * (r * sin_(phi));
  }
  const float i = (float)(pix % p.width), j = (float)(pix / p.width);
  float ju, jv;
  uniform2(seed, (uint32_t)pix, sample, CAMERA_BOUNCE, DIM_PIXEL_JITTER, ju,
           jv);
  const float s = (i + ju) * (1.0f / (float)(p.width - 1));
  const float t =
      ((float)(p.height - 1) - j + jv) * (1.0f / (float)(p.height - 1));
  const V origin = cam_vec(p.origin);
  d = ((cam_vec(p.lower_left) - origin) + cam_vec(p.horizontal) * s) +
      cam_vec(p.vertical) * t;
  o = origin;
  if (p.lens) {
    const V offset = cam_vec(p.cam_u) * rdx + cam_vec(p.cam_v) * rdy;
    o = offset + origin;
    d = d - offset;
  }
  time = (float)p.time0;
  if (p.shutter) {
    float tu, unused;
    uniform2(seed, (uint32_t)pix, sample, CAMERA_BOUNCE, DIM_TIME, tu, unused);
    time = time + tu * ((float)p.time1 - time);
  }
}

// --------------------------------------------------------------------------
// The step
// --------------------------------------------------------------------------

template <int FOLD, bool MEDIA>
__global__ void __launch_bounds__(BLOCK) bounce_kernel(const Params p) {
  __shared__ int s_count[3];  // segments, sphere winners, medium winners
  if (threadIdx.x < 3) s_count[threadIdx.x] = 0;
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  bool scattered = false, regen = false, sphere_hit = false,
       medium_hit = false;
  if (i < p.n) {
    const bool alive = p.in_alive[i];
    V o = {p.in_f[0][i], p.in_f[1][i], p.in_f[2][i]};
    V d = {p.in_f[3][i], p.in_f[4][i], p.in_f[5][i]};
    V thr = {p.in_f[6][i], p.in_f[7][i], p.in_f[8][i]};
    V total = {p.in_f[9][i], p.in_f[10][i], p.in_f[11][i]};
    V prad = {p.in_f[12][i], p.in_f[13][i], p.in_f[14][i]};
    const int64_t sample = p.in_sample[i];
    int64_t bounce = p.in_bounce[i];
    const float t_min = (float)p.t_min;
    // delta = where(miss, thr * bg, 0) + where(hit, thr * emit, 0).
    V miss_part = {0.0f, 0.0f, 0.0f}, hit_part = {0.0f, 0.0f, 0.0f};
    V hit_p, new_dir, att;
    if (alive) {
      const float time = p.in_time[i];
      const uint32_t seed = launch_seed(p);
      const uint32_t pix = (uint32_t)p.pix[i];
      const uint32_t s32 = (uint32_t)sample, b32 = (uint32_t)bounce;
      // The winner: K5's trees, the swept kinds, the media.
      float t = BIG;
      int kind = -1;
      int64_t idx = 0;
      if (p.k5_t != nullptr) {
        t = p.k5_t[i];
        const int code = p.k5_code[i];
        if (code >= 0) {
          kind = code % 4;
          idx = code / 4;
        }
      }
      if (p.sweep_sph) {
        const float t_max = t;
        for (int64_t j = 0; j < p.n_sph; ++j) {
          float root;
          if (sphere_t(p, j, o, d, time, t_min, t_max, root) && root < t) {
            t = root;
            kind = PRIM_SPHERE;
            idx = j;
          }
        }
      }
      if (p.sweep_rect) {
        const float t_max = t;
        for (int64_t j = 0; j < p.n_rect; ++j) {
          float tr;
          if (rect_t(p, j, o, d, t_min, t_max, tr) && tr < t) {
            t = tr;
            kind = PRIM_RECT;
            idx = j;
          }
        }
      }
      if (p.sweep_tri) {
        const float t_max = t;
        for (int64_t j = 0; j < p.n_tri; ++j) {
          float tt;
          if (triangle_t(p, j, o, d, t_min, t_max, tt) && tt < t) {
            t = tt;
            kind = PRIM_TRIANGLE;
            idx = j;
          }
        }
      }
      float med_t1 = 0.0f, med_u = 0.0f;
      if (MEDIA) {
        const float t_max = t;
        const float ray_len = length(d);
        for (int64_t m = 0; m < p.n_med; ++m) {
          float um, unused;
          uniform2(seed, pix, s32, b32, DIM_MEDIUM + 2 * (uint32_t)m, um,
                   unused);
          float t1, t2;
          bool ok = medium_interval(p, m, o, d, t1, t2);
          float r1 = tmax(t1, t_min);
          const float r2 = tmin(t2, t_max);
          ok = ok & (r1 < r2);
          r1 = tmax(r1, 0.0f);
          const float dist_inside = (r2 - r1) * ray_len;
          const float hit_dist = p.med[MED_F4 * m + 1].z * log_(um);
          ok = ok & (hit_dist <= dist_inside);
          const float tm = r1 + hit_dist / ray_len;
          if (ok && tm < t) {
            t = tm;
            kind = PRIM_MEDIUM;
            idx = m;
            med_t1 = t1;
            med_u = um;
          }
        }
      }
      const bool hit = kind >= 0;
      sphere_hit = hit & (kind == PRIM_SPHERE);
      if (MEDIA) medium_hit = kind == PRIM_MEDIUM;
      if (!hit) {
        const float4 bg = p.bg[0];
        miss_part = thr * xyz(bg);
      } else {
        Rec rec;
        if (kind == PRIM_SPHERE) {
          if (FOLD == FOLD_SPHERE) {
            sphere_record_aux(p, i, o, d, t, rec);
          } else {
            sphere_record(p, o, d, time, t, idx, rec);
          }
        } else if (kind == PRIM_RECT) {
          rect_record(p, o, d, t, idx, rec);
        } else if (kind == PRIM_TRIANGLE) {
          if (FOLD == FOLD_PLANAR) {
            triangle_record_aux(p, i, o, d, t, rec);
          } else {
            triangle_record(p, o, d, t, idx, rec);
          }
        } else {
          medium_record(p, o, d, idx, med_t1, med_u, t_min, rec);
        }
        // set_face_normal; a medium's record faces front.
        const bool front = (dot(d, rec.n) < 0.0f) | (kind == PRIM_MEDIUM);
        rec.n = front ? rec.n : -rec.n;
        V emit;
        const bool ok =
            scatter(p, rec, front, d, seed, pix, s32, b32, new_dir, att, emit);
        hit_part = thr * emit;
        hit_p = rec.p;
        scattered = ok;
      }
    }
    const V delta = miss_part + hit_part;
    prad = prad + delta;
    if (scattered) {
      thr = thr * att;
      o = hit_p;
      d = new_dir;
    }
    if (alive) bounce = bounce + 1;
    // Depth exhaustion contributes nothing further (engine.h:451-452).
    bool alive_next = scattered & (bounce < p.max_depth);
    const bool ended = alive & !alive_next;
    const V zero = {0.0f, 0.0f, 0.0f};
    total = total + sel(ended, prad, zero);
    prad = sel(ended, zero, prad);
    const int64_t next_sample =
        ended ? ((sample + p.stride) & MASK32) : sample;
    regen = ended & (next_sample < p.limit);
    alive_next = alive_next | regen;
    const float tail[6] = {total.x, total.y, total.z, prad.x, prad.y, prad.z};
#pragma unroll
    for (int k = 0; k < 6; ++k) p.out_f[9 + k][i] = tail[k];
    p.out_alive[i] = alive_next;
    p.out_sample[i] = next_sample;
    if (regen) {
      // The re-arm: the next sample's primary ray.  What the step leaves of
      // the lane is written or dead by now, and the seed and the pixel are
      // read again, so the camera's draws take no registers from the step.
      V o2, d2;
      float time2;
      camera_ray(p, launch_seed(p), p.pix[i], (uint32_t)next_sample, o2, d2,
                 time2);
      const float head[9] = {o2.x, o2.y, o2.z, d2.x, d2.y, d2.z,
                             1.0f, 1.0f, 1.0f};
#pragma unroll
      for (int k = 0; k < 9; ++k) p.out_f[k][i] = head[k];
      p.out_bounce[i] = 0;
      p.out_time[i] = time2;
    } else {
      const float head[9] = {o.x, o.y, o.z, d.x, d.y, d.z,
                             thr.x, thr.y, thr.z};
#pragma unroll
      for (int k = 0; k < 9; ++k) p.out_f[k][i] = head[k];
      p.out_bounce[i] = bounce;
      if (p.out_time != p.in_time) p.out_time[i] = p.in_time[i];
    }
  }
  const unsigned b_scat = __ballot_sync(FULL_MASK, scattered);
  const unsigned b_regen = __ballot_sync(FULL_MASK, regen);
  const unsigned b_sph = __ballot_sync(FULL_MASK, sphere_hit);
  const unsigned b_med = MEDIA ? __ballot_sync(FULL_MASK, medium_hit) : 0u;
  if ((threadIdx.x & 31) == 0) {
    if (b_scat | b_regen) {
      atomicAdd(&s_count[0], __popc(b_scat) + __popc(b_regen));
    }
    if (b_sph) atomicAdd(&s_count[1], __popc(b_sph));
    if (b_med) atomicAdd(&s_count[2], __popc(b_med));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_count[0]) {
      atomicAdd(reinterpret_cast<unsigned long long*>(p.segments),
                (unsigned long long)s_count[0]);
    }
    if (s_count[1] && p.sphere_hits != nullptr) {
      atomicAdd(reinterpret_cast<unsigned long long*>(p.sphere_hits),
                (unsigned long long)s_count[1]);
    }
    if (MEDIA && s_count[2] && p.medium_scatters != nullptr) {
      atomicAdd(reinterpret_cast<unsigned long long*>(p.medium_scatters),
                (unsigned long long)s_count[2]);
    }
  }
}

template <int FOLD, bool MEDIA>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int64_t grid = (p.n + BLOCK - 1) / BLOCK;
  bounce_kernel<FOLD, MEDIA><<<(unsigned)grid, BLOCK, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// sizeof(Params), which bounce_kernel.py checks against its own layout.
extern "C" int art_bounce_params_size() { return (int)sizeof(Params); }

// One step of the wavefront's lanes after K5 (see the header) on `stream`:
// `params` a Params (a void pointer: the type has internal linkage), `fold`
// 0 (none), 1 (planar) or 2 (sphere), `media` 0 or 1 selects the instance.
// Returns cudaGetLastError(), or cudaErrorInvalidValue on arguments the
// kernel does not take.
extern "C" int art_bounce(const void* params, int fold, int media,
                          void* stream_ptr) {
  if (params == nullptr) return (int)cudaErrorInvalidValue;
  const Params& p = *static_cast<const Params*>(params);
  if (p.n < 0 || fold < 0 || fold > 2 || (media != 0) != (p.n_med > 0) ||
      p.width < 1 || p.height < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.n == 0) return (int)cudaSuccess;
  if ((fold != FOLD_NONE && p.aux == nullptr) ||
      (p.k5_t == nullptr) != (p.k5_code == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
  if (media) {
    e = fold == FOLD_PLANAR ? launch<FOLD_PLANAR, true>(p, stream)
      : fold == FOLD_SPHERE ? launch<FOLD_SPHERE, true>(p, stream)
                            : launch<FOLD_NONE, true>(p, stream);
  } else {
    e = fold == FOLD_PLANAR ? launch<FOLD_PLANAR, false>(p, stream)
      : fold == FOLD_SPHERE ? launch<FOLD_SPHERE, false>(p, stream)
                            : launch<FOLD_NONE, false>(p, stream);
  }
  return (int)e;
}

// Perlin noise kernel for NVIDIA Hopper (sm_90a): one thread per point.
//
// Replaces: another_raytracer_tpu/ops/pallas/perlin_kernel.py::perlin_noise_tpu
// (body _kernel), reached from ops/shade.py::texture_value for every noise
// texture on the forward path (and, through perlin_noise_tpu_nograd, on
// differentiable renders whose trainable set cannot reach the noise
// argument).  Same function (perlin.h:29-96): the lattice hash
// perm_x[i & 255] ^ perm_y[j & 255] ^ perm_z[k & 255] over the 8 corners,
// the dot of each corner's ranvec gradient with the offset to the point,
// and the Hermite-smoothed trilinear blend.  Unlike the TPU kernel, which
// takes one table set (Q == 1), each point carries its own table id, so
// scenes with several noise textures run the kernel too.
//
// What bounds it on this card: instruction issue and shared-memory
// gathers.  A point reads 12 bytes and writes 4; the rest is ~30
// table reads and ~80 float operations.  What the design does about it:
// every block copies the tables it may need (3 x 256 perm entries and
// 256 x 3 ranvec per table, 6 KB each) into shared memory once, and every
// read after that is a shared-memory gather; the +1 lattice neighbour is
// the index (i + 1) & 255 (the TPU kernel's rolled table copies and its
// half-table lane gathers are TPU workarounds, left out).
//
// Numerics: built with -fmad=false (ops/kernels/_build.py), so each
// operation rounds as in the plain version (ops/shade.py::perlin_noise),
// which runs the same operations in the same order: the two agree bit for
// bit on the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false  (ops/kernels/_build.py)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PERLIN_N = 256;
constexpr int TABLE_FLOATS = 6 * PERLIN_N;  // perm [3][256] + ranvec [256][3]

__global__ void __launch_bounds__(256)
perlin_kernel(const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ pz, const int* __restrict__ pid,
              const int* __restrict__ perm, const float* __restrict__ ranvec,
              int n_tables, int n, float* __restrict__ out) {
  extern __shared__ float smem[];
  int* s_perm = reinterpret_cast<int*>(smem);  // [Q][3][256]
  float* s_ran = smem + 3 * PERLIN_N * n_tables;  // [Q][256][3]
  for (int k = threadIdx.x; k < 3 * PERLIN_N * n_tables; k += blockDim.x) {
    s_perm[k] = perm[k];
    s_ran[k] = ranvec[k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  int q = pid == nullptr ? 0 : pid[i];
  q = min(max(q, 0), n_tables - 1);
  const int* tp = s_perm + q * 3 * PERLIN_N;
  const float* tr = s_ran + q * 3 * PERLIN_N;
  const float x = px[i], y = py[i], z = pz[i];
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const float u = x - fx, v = y - fy, w = z - fz;
  const int ii = (int)fx, jj = (int)fy, kk = (int)fz;
  // Hermite smoothing u*u*(3-2u) (perlin.h:80-82).
  const float uu = u * u * (3.0f - 2.0f * u);
  const float vv = v * v * (3.0f - 2.0f * v);
  const float ww = w * w * (3.0f - 2.0f * w);
  const int px0 = tp[ii & 255], px1 = tp[(ii + 1) & 255];
  const int py0 = tp[PERLIN_N + (jj & 255)], py1 = tp[PERLIN_N + ((jj + 1) & 255)];
  const int pz0 = tp[2 * PERLIN_N + (kk & 255)];
  const int pz1 = tp[2 * PERLIN_N + ((kk + 1) & 255)];

  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int g = ((di ? px1 : px0) ^ (dj ? py1 : py0) ^ (dk ? pz1 : pz0)) & 255;
        const float* gr = tr + 3 * g;
        const float wgt = (di ? uu : 1.0f - uu) * (dj ? vv : 1.0f - vv) *
                          (dk ? ww : 1.0f - ww);
        const float dot = gr[0] * (di ? u - 1.0f : u) +
                          gr[1] * (dj ? v - 1.0f : v) +
                          gr[2] * (dk ? w - 1.0f : w);
        accum = accum + wgt * dot;
      }
    }
  }
  out[i] = accum;
}

}  // namespace

// Perlin noise of n points (px, py, pz [n]) with per-point table ids pid [n]
// (nullptr: table 0) over n_tables table sets perm [Q][3][256] int32 and
// ranvec [Q][256][3] f32, into out [n], on `stream`.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when the
// tables do not fit in shared memory.
extern "C" int art_perlin_noise(const float* px, const float* py,
                                const float* pz, const int* pid,
                                const int* perm, const float* ranvec,
                                int n_tables, int n, float* out,
                                void* stream_ptr) {
  if (n < 0 || n_tables < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_tables * TABLE_FLOATS * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        perlin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int block = 256;
  perlin_kernel<<<(n + block - 1) / block, block, smem,
                  static_cast<cudaStream_t>(stream_ptr)>>>(
      px, py, pz, pid, perm, ranvec, n_tables, n, out);
  return (int)cudaGetLastError();
}

// Perlin noise kernel for NVIDIA Hopper (sm_90a): a persistent grid over the
// points, the tables staged once per resident block.
//
// Replaces: another_raytracer_tpu/ops/pallas/perlin_kernel.py::perlin_noise_tpu
// (body _kernel), reached from ops/shade.py::texture_value for every noise
// texture of the eager forward step (and, through perlin_noise_tpu_nograd,
// on differentiable renders whose trainable set cannot reach the noise
// argument); the wavefront's steps on the card evaluate the same device
// code (perlin_device.cuh) inside the bounce kernel.  Same function (perlin.h:29-96): the lattice hash
// perm_x[i & 255] ^ perm_y[j & 255] ^ perm_z[k & 255] over the 8 corners,
// the dot of each corner's ranvec gradient with the offset to the point,
// and the Hermite-smoothed trilinear blend.  Unlike the TPU kernel, which
// takes one table set (Q == 1), a point may carry its own table id, so
// scenes with several noise textures run the kernel too.
//
// What bounds it on this card: at the main path's widths (~10^5 points) the
// launch and the stage of the tables, then device memory (a point reads 12
// bytes and writes 4).  What the design does about it:
// * The tables are packed once per scene (the wrapper's pack_tables): per
//   table set 256 ranvec float4 (x, y, z, 0), so a corner's gradient is one
//   16-byte shared load, then per axis 256 16-bit words perm[i] |
//   perm[(i + 1) & 255] << 8, so a point reads its two lattice neighbours
//   on an axis with one load: 3 perm loads and 8 ranvec loads a point.
//   5,632 bytes a table set, copied into shared memory with 16-byte loads.
// * The grid is persistent (the blocks the card holds at once, at most one
//   per BLOCK points) and strides over the points, so each block stages the
//   tables once; a thread reads its first point before the stage, so that
//   load overlaps the copy.
// * One table set needs no id array: pid may be null (table 0).
// * A point's noise is perlin_device.cuh's perlin_at, which the bounce
//   kernel calls too.
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

#include <mutex>

namespace {

#include "perlin_device.cuh"

// Float4s per packed table set: 256 ranvec, then 3 x 256 16-bit words.
constexpr int TABLE_F4 = PERLIN_N + 3 * PERLIN_N * 2 / 16;
constexpr int MAX_SMEM = 232448;
constexpr int BLOCK = 256;
constexpr int MAX_DEVICES = 64;

__global__ void __launch_bounds__(BLOCK)
perlin_kernel(const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ pz, const int* __restrict__ pid,
              const float4* __restrict__ tab, int n_tables, int n,
              float* __restrict__ out) {
  extern __shared__ float4 s_tab[];  // [Q][TABLE_F4]
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  // The first point before the stage, so its load overlaps the copy.
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (first < n) {
    x = px[first];
    y = py[first];
    z = pz[first];
  }
  for (int k = threadIdx.x; k < TABLE_F4 * n_tables; k += blockDim.x) {
    s_tab[k] = __ldg(tab + k);
  }
  __syncthreads();
  for (int i = first; i < n; i += stride) {
    if (i != first) {
      x = px[i];
      y = py[i];
      z = pz[i];
    }
    const int q = pid == nullptr ? 0 : min(max(pid[i], 0), n_tables - 1);
    out[i] = perlin_at(s_tab + q * TABLE_F4, x, y, z);
  }
}

}  // namespace

// Perlin noise of n points (px, py, pz [n]) with per-point table ids pid [n]
// (nullptr: table 0) over n_tables packed table sets tab [Q][TABLE_F4]
// float4 (the wrapper's pack_tables), into out [n], on `stream`.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when the
// tables do not fit in shared memory.
extern "C" int art_perlin_noise(const float* px, const float* py,
                                const float* pz, const int* pid,
                                const float* tab, int n_tables, int n,
                                float* out, void* stream_ptr) {
  if (n < 0 || n_tables < 1 || tab == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_tables * TABLE_F4 * sizeof(float4);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  // Per device, the shared memory opted into and the last table count's
  // resident blocks: set and queried once, so that a launch captured in a
  // CUDA graph (or one of the wavefront's hundreds per render) makes no
  // such call.
  struct Shape {
    int opted = 48 * 1024, tables = 0, resident = 0;
  };
  static std::mutex mu;
  static Shape shapes[MAX_DEVICES];
  int resident = 0;
  {
    const std::lock_guard<std::mutex> lock(mu);
    Shape& c = shapes[dev];
    if ((int)smem > c.opted) {
      e = cudaFuncSetAttribute(perlin_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      c.opted = (int)smem;
    }
    // A persistent grid: the blocks the card holds at once.
    if (n_tables != c.tables) {
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, perlin_kernel, BLOCK, smem);
      }
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      c.tables = n_tables;
      c.resident = per_sm * sms;
    }
    resident = c.resident;
  }
  const int need = (n + BLOCK - 1) / BLOCK;
  const int grid = need < resident ? need : resident;
  perlin_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      px, py, pz, pid, reinterpret_cast<const float4*>(tab), n_tables, n, out);
  return (int)cudaGetLastError();
}

// Replay backward of the fused differentiable path for NVIDIA Hopper
// (sm_90a): one thread per ray lane, a reverse loop over the lane's residual
// rows.
//
// Replaces: another_raytracer_tpu/ops/pallas/mega_diff.py::_traced_bwd (the
// T <= 16 select-sum replay) and _bwd_large (the T > 16 gather/scatter
// replay), both a reverse lax.scan over the record-mode megakernel's
// residual rows.  One kernel, two instances by where a lane's gradients
// accumulate (template argument WARP_TABLES), for any texture count T up to
// the shared-memory limit (~4,800; the random scene has 485), both
// deterministic:
//   per-lane columns (T up to 292): each thread its own column of the
//     gradient table, summed in a fixed order;
//   per-warp tables (larger T): each warp one table, added to in a fixed
//     order (below).
//
// The radiance of a lane is an explicit multiplicative chain,
//   L = sum_chains sum_k (prod_{j<k} a_j) x_k,
// with a_j the albedo of the j-th scatter and x_k a light's emission or the
// background, so with ghat = dLoss/dL (per channel) and T_prev the recorded
// entry throughput, walking the rows backwards with the suffix value r:
//   r_after = end ? 0 : r;  gterm = ghat * T_prev
//   scatter:   d a_i += gterm * r_after;   r = a_i * r_after
//   light hit: d x_i += gterm;             r = x_i
//   miss:      d bg  += gterm;             r = bg
//   metal absorption (event 0 with the end bit): r = 0
// Idle rows (event 0 without the end bit) change nothing.  A checker row with
// the odd bit routes to tex_cb; the dielectric sentinel tid == T has
// attenuation 1 and routes nothing.
//
// What bounds it on this card: device-memory reads.  Each lane reads its
// code row (4 B) and, on live rows, its three T_prev values (12 B) per
// iteration — 199 MB at the bench size — with a handful of flops per row.
// The rows are [iters][B], so a warp's reads for one iteration are
// contiguous.  What the design does about it: one pass, no recompute of the
// sweep or the shading; tprev is read only on live rows.
//
// Per-lane columns: each thread accumulates its lane's gradients in its own
// column of a shared table [K][blockDim] (K = 2 (T+1) 3 + 3 entries: tex_ca
// and tex_cb rows with the sentinel row, then the background), with no
// atomics.  The block then sums each entry over its threads in a fixed order
// and writes one partial row; the wrapper sums the rows.  The result does
// not depend on scheduling.  The columns take (6 (T+1) + 3) floats per
// thread, so at 32 threads they outgrow the 227 KB of shared memory above
// T = 292.
//
// Per-warp tables (WARP_TABLES): each warp adds into its own shared table
// [K] (23 KB at T = 485), and the block sums the warps' tables in warp
// order into its partial row.  Within a warp, every lane of the warp takes
// each row step together: lanes that add to the same entry in one step (the
// random scene's checker ground) are found with __match_any_sync and their
// values summed by a fixed shuffle tree before the group's lowest lane adds
// the sum; a lane alone on its entry adds its own value.  Each entry thus
// takes its adds in an order fixed by the data, so the result is
// bit-deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (another_raytracer_tpu_torch/ops/kernels/_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Flags : int { HAS_CHECKER = 1, HAS_METAL = 2, HAS_DIEL = 4 };

constexpr unsigned FULL = 0xffffffffu;

// Shared-memory bytes for texture count T at `block` threads (the wrapper's
// mega_diff.replay_smem_bytes picks the instance and block from the same
// formula).
__host__ __device__ inline size_t smem_bytes(int T, int block,
                                             bool warp_tables) {
  const size_t tab = 6 * (size_t)(T + 1);
  const size_t k = tab + 3;
  return (tab + k * (size_t)(warp_tables ? block / 32 : block)) *
         sizeof(float);
}

// Sum of v over the warp by a fixed shuffle tree (every lane takes part).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// One row step of a warp's table: each lane adds g[3] to entries slot * 3 +
// c (slot < 0: nothing), in an order fixed by the slots (see the header).
// Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(float* wt, int slot, const float g[3]) {
  if (!__any_sync(FULL, slot >= 0)) return;
  const int me = threadIdx.x & 31;
  const unsigned self = 1u << me;
  // Lanes with no entry key themselves apart (-1 - me).
  const unsigned peers = __match_any_sync(FULL, slot >= 0 ? slot : -1 - me);
  if (slot >= 0 && peers == self) {
#pragma unroll
    for (int c = 0; c < 3; ++c) wt[slot * 3 + c] += g[c];
  }
  unsigned groups = __ballot_sync(FULL, slot >= 0 && peers != self);
  while (groups) {
    const int src = __ffs(groups) - 1;
    const unsigned grp = __shfl_sync(FULL, peers, src);
    const int s = __shfl_sync(FULL, slot, src);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = warp_sum(grp & self ? g[c] : 0.0f);
      if (me == src) wt[s * 3 + c] += v;
    }
    groups &= ~grp;
  }
  __syncwarp();
}

template <bool WARP_TABLES>
__global__ void mega_replay_kernel(const int* __restrict__ codes,
                                   const float* __restrict__ tprev,
                                   const float* __restrict__ ghat,
                                   const float* __restrict__ ca,
                                   const float* __restrict__ cb,
                                   const float* __restrict__ bg, int iters,
                                   int n, int T, int flags,
                                   float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int rows = T + 1;             // texture rows + the sentinel row
  const int tab_n = 6 * rows;         // albedo table [2][T+1][3]
  const int K = tab_n + 3;            // gradient entries per lane
  float* tab = smem;
  float* acc = smem + tab_n;  // [K][blockDim], or [blockDim / 32][K]
  const int tx = threadIdx.x;
  const int nb = blockDim.x;
  const int nw = nb / 32;

  const bool has_checker = flags & HAS_CHECKER;
  const bool has_metal = flags & HAS_METAL;
  // The sentinel row is the dielectric's unit attenuation; a scene without
  // dielectrics never records it (the select-sum replay reads 0 there).
  const float sentinel = (flags & HAS_DIEL) ? 1.0f : 0.0f;
  for (int k = tx; k < tab_n; k += nb) {
    const int half = k / (3 * rows), t = (k / 3) % rows, c = k % 3;
    tab[k] = t == T ? sentinel : (half ? cb : ca)[t * 3 + c];
  }
  const int acc_n = WARP_TABLES ? nw * K : K * nb;
  for (int k = tx; k < acc_n; k += nb) acc[k] = 0.0f;
  __syncthreads();

  const int lane = blockIdx.x * nb + tx;
  // Every lane of a warp takes each row step in WARP_TABLES (lanes past n
  // with nothing to add); per-lane columns need only the live lanes.
  if (WARP_TABLES || lane < n) {
    const bool live = lane < n;
    // Entry k of this thread's column is acc[k * nb + tx]; of its warp's
    // table, wt[k].
    float* wt = acc + (tx >> 5) * K;
    float g[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      g[0] = ghat[lane];
      g[1] = ghat[n + lane];
      g[2] = ghat[2 * (size_t)n + lane];
    }
    const float bgv[3] = {bg[0], bg[1], bg[2]};
    float r[3] = {0.0f, 0.0f, 0.0f};
    float gbg[3] = {0.0f, 0.0f, 0.0f};
    const size_t plane = (size_t)iters * n;
    for (int it = iters - 1; it >= 0; --it) {
      // Per-warp tables: every lane reaches warp_add in each step, with the
      // entry row it adds g_a to (slot, -1 for none); per-lane columns add
      // in place and skip the rest of a row without an entry.
      int slot = -1;
      float g_a[3] = {0.0f, 0.0f, 0.0f};
      const size_t row = (size_t)it * n + lane;
      const int code = (WARP_TABLES && !live) ? 0 : codes[row];
      const int ev = code & 3;
      const bool end = code & 4;
      if (ev == 0) {
        // Idle row: nothing.  Metal absorption: the chain ends at zero.
        if (end && has_metal) r[0] = r[1] = r[2] = 0.0f;
        if constexpr (!WARP_TABLES) continue;
      } else {
        const float tp[3] = {tprev[row], tprev[plane + row],
                             tprev[2 * plane + row]};
        float gterm[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) gterm[c] = g[c] * tp[c];
        if (ev == 3) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            gbg[c] += gterm[c];
            r[c] = bgv[c];
          }
          if constexpr (!WARP_TABLES) continue;
        } else {
          const int tid = min(code >> 4, T);  // clamp only guards the reads
          slot = (has_checker && (code & 8) ? rows : 0) + tid;
          const float* a = tab + slot * 3;
          float* col = acc + (size_t)slot * 3 * nb + tx;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float r_after = end ? 0.0f : r[c];
            // ev 1 scatter: d a += gterm * r_after; ev 2 light: d x += gterm.
            g_a[c] = ev == 1 ? gterm[c] * r_after : gterm[c];
            if constexpr (!WARP_TABLES) col[c * nb] += g_a[c];
            r[c] = ev == 1 ? a[c] * r_after : a[c];
          }
        }
      }
      if constexpr (WARP_TABLES) warp_add(wt, slot, g_a);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if constexpr (WARP_TABLES) {
        const float v = warp_sum(gbg[c]);
        if ((tx & 31) == 0) wt[tab_n + c] = v;
      } else {
        acc[(tab_n + c) * nb + tx] = gbg[c];
      }
    }
  }
  __syncthreads();

  // Sum each entry over the block's threads (or warps) in a fixed order.
  for (int k = tx; k < K; k += nb) {
    float s = 0.0f;
    if constexpr (WARP_TABLES) {
      for (int w = 0; w < nw; ++w) s += acc[w * K + k];
    } else {
      for (int j = 0; j < nb; ++j) s += acc[k * nb + j];
    }
    partial[(size_t)blockIdx.x * K + k] = s;
  }
}

template <bool WARP_TABLES>
cudaError_t launch(const int* codes, const float* tprev, const float* ghat,
                   const float* ca, const float* cb, const float* bg,
                   int iters, int n, int T, int flags, int block,
                   float* partial, cudaStream_t stream) {
  const size_t bytes = smem_bytes(T, block, WARP_TABLES);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_replay_kernel<WARP_TABLES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int grid = (n + block - 1) / block;
  mega_replay_kernel<WARP_TABLES><<<grid, block, bytes, stream>>>(
      codes, tprev, ghat, ca, cb, bg, iters, n, T, flags, partial);
  return cudaGetLastError();
}

}  // namespace

// Launches the replay on `stream`.  codes [iters][n] int32, tprev
// [3][iters][n], ghat [3][n], ca and cb [T][3], bg [3] are device memory;
// partial receives [ceil(n / block)][6 (T+1) + 3] floats (tex_ca rows,
// sentinel row, tex_cb rows, sentinel row, background).  warp_tables 0
// takes the per-lane columns, 1 the per-warp tables.  Returns
// cudaGetLastError() (0 on success).
extern "C" int art_mega_replay(const int* codes, const float* tprev,
                               const float* ghat, const float* ca,
                               const float* cb, const float* bg, int iters,
                               int n, int T, int flags, int block,
                               int warp_tables, float* partial,
                               void* stream) {
  if (iters < 0 || n < 0 || T < 1 || block <= 0 || block > 1024 ||
      block % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(warp_tables
                   ? launch<true>(codes, tprev, ghat, ca, cb, bg, iters, n,
                                  T, flags, block, partial, s)
                   : launch<false>(codes, tprev, ghat, ca, cb, bg, iters, n,
                                   T, flags, block, partial, s));
}

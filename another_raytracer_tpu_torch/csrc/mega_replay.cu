// Replay backward of the fused differentiable path for NVIDIA Hopper
// (sm_90a): one thread per ray lane, a reverse walk over the lane's residual
// rows in chunks.
//
// Replaces: another_raytracer_tpu/ops/pallas/mega_diff.py::_traced_bwd (the
// T <= 16 select-sum replay) and _bwd_large (the T > 16 gather/scatter
// replay), both a reverse lax.scan over the record-mode megakernel's
// residual rows.  One kernel, two instances by where a lane's gradients
// accumulate (template argument INST), for any texture count T up to the
// shared-memory limit, both deterministic:
//   per-lane columns (LANE_COLUMNS): each thread its own column of the
//     gradient table, summed in a fixed order;
//   per-warp tables (WARP_TABLES): each warp one table, added to in a fixed
//     order (below).
// mega_diff.replay_instance picks the instance and its block by size
// (chip_smoke.py holds its pick against the measured times at the main
// paths' T).
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
// the odd bit routes to its texture's tex_cb row; the dielectric sentinel
// tid == T has attenuation 1 and adds to no gradient.
//
// Compact tables: the gradient rows are the T tex_ca rows, then tex_cb rows
// for the C checker textures only (the record kernels set the odd bit on
// nothing else), then the background: 3 (T + C) + 3 entries.  The wrapper
// gives the map from texture to tex_cb row (cb_row, -1 for a solid texture:
// its odd bit is read as clear) and its inverse (cb_tex), packed once per
// scene (SceneData.replay_slots).  Scene 1 (T = 485, C = 1) thus needs 5.8 KB
// per warp table instead of 11.7 KB.
//
// What bounds it on this card: device-memory reads.  Each lane reads its
// code row (4 B) on every iteration and its three T_prev values (12 B) only
// on live rows (event != 0): 45% of Cornell's rows and 35% of scene 1's at
// the bench size (97,200 lanes x 128 rows), 119 MB and 102 MB with the
// cotangents, 0.035 and 0.031 ms at 3.35 TB/s (mega_diff.replay_work).  By
// the card's 32-byte sectors (a T_prev row's sector serves 8 lanes and is
// fetched while any of them is live) it is 130 MB and 111 MB.  The flops
// per row are a handful.  The rows are [iters][B], so a warp's reads for one
// iteration are 128 contiguous bytes.  A lane's rows depend on each other
// only through r, so a walk of one load after another waits on the latency
// of device memory (two per row: the code, then the T_prev it gates), and
// the grid has one warp for 32 lanes, ~23 per SM at the bench size: too few
// to hide it.  What the design does about it:
//   - a lane walks its rows CHUNK at a time from the end: the chunk's code
//     loads go out together (and the next chunk's while this one runs),
//     then the T_prev loads of its live rows together, then the CHUNK steps
//     run from registers, in the same reverse order as one row at a time;
//   - a chunk whose rows change nothing in any lane of the warp (the idle
//     suffix of the lanes' rows) is skipped warp-wide: no T_prev loads, no
//     table adds;
//   - the tprev planes and the cotangent channels are read where they lie
//     (K2's record buffer): no copy before the launch;
//   - compact tables halve scene 1's blocks (31,160 B at 128 threads).
// Measured with instances of 1, 4, 8 and 16 rows a chunk (H100 80GB HBM3 at
// 700 W; PERF.md): chunks of 8 take the Cornell launch from 0.127 ms one
// row at a time to 0.072 ms, 49% of the live-row bound and 54% of the
// sector one; chunks of 16 need ~150 registers and lose.  Scene 1's launch (0.145 ms) is held by the per-warp
// tables' adds (below), not by its bytes.
//
// Per-lane columns: each thread accumulates its lane's gradients in its own
// column of a shared table [K][blockDim], with no atomics (its adds are
// bank-conflict free: the column stride is the block size).  The block then
// sums each entry over its threads in a fixed order (a fixed warp tree) and
// writes one partial row; the wrapper sums the rows.  The result does not
// depend on scheduling.
//
// Per-warp tables (WARP_TABLES): each warp adds into its own shared table
// [K], and the block sums the warps' tables in warp order into its partial
// row.  Within a warp, every lane of the warp takes each row step together:
// lanes that add to the same entry in one step (the random scene's checker
// ground) are found with __match_any_sync and their values summed by a
// fixed shuffle tree before the group's lowest lane adds the sum; a lane
// alone on its entry adds its own value.  Each entry thus takes its adds in
// an order fixed by the data, so the result is bit-deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (another_raytracer_tpu_torch/ops/kernels/_build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

enum Flags : int { HAS_CHECKER = 1, HAS_METAL = 2, HAS_DIEL = 4 };
enum Instance : int { LANE_COLUMNS = 0, WARP_TABLES = 1 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
// Rows a lane's walk takes at once (mega_diff.REPLAY_CHUNK gives the same).
constexpr int CHUNK = 8;

struct Args {
  const int* codes;    // [iters][n]
  const float* tp[3];  // T_prev planes, [iters][n] each
  const float* g[3];   // ghat channels, [n] each
  const float* ca;     // [T][3]
  const float* cb;     // [T][3]
  const float* bg;     // [3]
  const int* cb_row;   // [T]: tex_cb row of each texture, -1 if none
  const int* cb_tex;   // [C]: texture of each tex_cb row
  int iters, n, T, C, flags;
  float* partial;      // [gridDim.x][3 (T + C) + 3]
};

// Gradient entries of a block's partial row: tex_ca rows, the C tex_cb rows,
// the background.
__host__ __device__ inline int entries(int T, int C) { return 3 * (T + C) + 3; }

// Shared-memory bytes of one block (mega_diff.replay_smem_bytes gives the
// same): the albedo table (tex_ca rows, tex_cb rows, the sentinel), the
// texture-to-tex_cb-row map where C > 0, and the gradient columns, one per
// thread or one table per warp.
__host__ __device__ inline size_t smem_bytes(int T, int C, int block,
                                             int inst) {
  const size_t k = entries(T, C);
  return (3 * (size_t)(T + C + 1) + (C > 0 ? T : 0) +
          k * (inst == WARP_TABLES ? block / 32 : block)) *
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
  // Lanes with no entry share one key, so that the match sorts out fewer
  // values (their peers are never read).
  const unsigned peers = __match_any_sync(FULL, slot >= 0 ? slot : -1);
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

// Does a row change anything?  (Idle rows, event 0 without the end bit, do
// not; neither do the zero rows past a lane's end.)
__device__ __forceinline__ bool matters(int code, bool has_metal) {
  return (code & 3) != 0 || (has_metal && (code & 4));
}

// The codes of rows hi - 1, ..., hi - CHUNK of this lane (0 below row 0 and
// on lanes past n), loaded together.
__device__ __forceinline__ void load_codes(int (&code)[CHUNK], const Args& a,
                                           int hi, int lane, bool live) {
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    const int it = hi - 1 - k;
    code[k] = live && it >= 0 ? __ldcs(a.codes + (size_t)it * a.n + lane) : 0;
  }
}

template <int INST>
__global__ void mega_replay_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C;
  const int K = entries(T, C);
  const int tab_n = 3 * (T + C + 1);
  float* tab = smem;  // albedo rows [T + C + 1][3]
  int* cb_row = reinterpret_cast<int*>(smem + tab_n);  // [T] where C > 0
  float* acc = smem + tab_n + (C > 0 ? T : 0);  // [K][blockDim] or [nw][K]
  const int tx = threadIdx.x;
  const int nb = blockDim.x;
  const int nw = nb / 32;

  const bool has_metal = a.flags & HAS_METAL;
  const bool odd_routes = (a.flags & HAS_CHECKER) && C > 0;
  // The sentinel row is the dielectric's unit attenuation; a scene without
  // dielectrics never records it (the select-sum replay reads 0 there).
  const float sentinel = (a.flags & HAS_DIEL) ? 1.0f : 0.0f;
  for (int k = tx; k < tab_n; k += nb) {
    const int row = k / 3, c = k % 3;
    tab[k] = row < T       ? a.ca[row * 3 + c]
             : row < T + C ? a.cb[a.cb_tex[row - T] * 3 + c]
                           : sentinel;
  }
  if (C > 0) {
    for (int k = tx; k < T; k += nb) cb_row[k] = a.cb_row[k];
  }
  const int acc_n = INST == WARP_TABLES ? nw * K : K * nb;
  for (int k = tx; k < acc_n; k += nb) acc[k] = 0.0f;
  __syncthreads();

  // Every lane of a warp takes every chunk (lanes past n with code 0), so
  // the warp votes and the per-warp tables' steps see all 32 lanes.
  const int lane = blockIdx.x * nb + tx;
  const bool live = lane < a.n;
  float* wt = acc + (tx >> 5) * K;  // this warp's table: entry k at wt[k]
  float* col = acc + tx;  // this thread's column: entry k at col[k * nb]
  float g[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] = a.g[c][lane];
  }
  const float bgv[3] = {a.bg[0], a.bg[1], a.bg[2]};
  float r[3] = {0.0f, 0.0f, 0.0f};
  float gbg[3] = {0.0f, 0.0f, 0.0f};

  int code[CHUNK];
  load_codes(code, a, a.iters, lane, live);
  for (int hi = a.iters; hi > 0; hi -= CHUNK) {
    int next[CHUNK];
    load_codes(next, a, hi - CHUNK, lane, live);
    bool any = false;
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) any |= matters(code[k], has_metal);
    if (__any_sync(FULL, any)) {
      // The chunk's T_prev loads, on live rows only, all issued before the
      // first step uses one.
      float tp[CHUNK][3];
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const size_t row = (size_t)(hi - 1 - k) * a.n + lane;
        const bool ld = (code[k] & 3) != 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) tp[k][c] = ld ? __ldcs(a.tp[c] + row) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int cd = code[k];
        const int ev = cd & 3;
        const bool end = cd & 4;
        // The entry row this step adds g_a to (-1: none).
        int slot = -1;
        float g_a[3] = {0.0f, 0.0f, 0.0f};
        if (ev == 0) {
          // Idle row: nothing.  Metal absorption: the chain ends at zero.
          if (end && has_metal) r[0] = r[1] = r[2] = 0.0f;
        } else {
          float gterm[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) gterm[c] = g[c] * tp[k][c];
          if (ev == 3) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              gbg[c] += gterm[c];
              r[c] = bgv[c];
            }
          } else {
            const int tid = min(cd >> 4, T);  // clamp only guards the reads
            int row = tid;
            if (tid == T) {
              row = T + C;  // the sentinel: its attenuation, no gradient
            } else if (odd_routes && (cd & 8) && cb_row[tid] >= 0) {
              row = T + cb_row[tid];
            }
            if (tid < T) slot = row;
            const float* alb = tab + row * 3;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float r_after = end ? 0.0f : r[c];
              // ev 1 scatter: d a += gterm * r_after; ev 2 light: d x += gterm.
              g_a[c] = ev == 1 ? gterm[c] * r_after : gterm[c];
              r[c] = ev == 1 ? alb[c] * r_after : alb[c];
            }
          }
        }
        if constexpr (INST == WARP_TABLES) {
          warp_add(wt, slot, g_a);
        } else if (slot >= 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) col[(slot * 3 + c) * nb] += g_a[c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) code[k] = next[k];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if constexpr (INST == WARP_TABLES) {
      const float v = warp_sum(gbg[c]);
      if ((tx & 31) == 0) wt[K - 3 + c] = v;
    } else {
      col[(K - 3 + c) * nb] = gbg[c];
    }
  }
  __syncthreads();

  // Sum each entry over the block's warps or threads in a fixed order.
  float* out = a.partial + (size_t)blockIdx.x * K;
  if constexpr (INST == WARP_TABLES) {
    for (int k = tx; k < K; k += nb) {
      float s = 0.0f;
      for (int w = 0; w < nw; ++w) s += acc[w * K + k];
      out[k] = s;
    }
  } else {
    // Warp w sums entries w, w + nw, ...: each lane its threads j = lane +
    // 32 i in order, then a fixed shuffle tree.
    const int me = tx & 31;
    for (int k = tx >> 5; k < K; k += nw) {
      float s = 0.0f;
      for (int j = me; j < nb; j += 32) s += acc[k * nb + j];
      s = warp_sum(s);
      if (me == 0) out[k] = s;
    }
  }
}

template <int INST>
struct Replay {
  // Per device, the shared memory opted into: set once, so that a launch
  // captured in a CUDA graph makes no such call.
  static cudaError_t opt_in(size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    static std::mutex mu;
    static size_t opted[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    const std::lock_guard<std::mutex> lock(mu);
    if (smem > opted[dev]) {
      e = cudaFuncSetAttribute(mega_replay_kernel<INST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
      opted[dev] = smem;
    }
    return cudaSuccess;
  }

  static cudaError_t launch(const Args& a, int block, cudaStream_t s) {
    const size_t smem = smem_bytes(a.T, a.C, block, INST);
    const cudaError_t e = opt_in(smem);
    if (e != cudaSuccess) return e;
    const int grid = (a.n + block - 1) / block;
    mega_replay_kernel<INST><<<grid, block, smem, s>>>(a);
    return cudaGetLastError();
  }

  static cudaError_t occupancy(int T, int C, int block, int* per_sm) {
    const size_t smem = smem_bytes(T, C, block, INST);
    const cudaError_t e = opt_in(smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, mega_replay_kernel<INST>, block, smem);
  }
};

// Launch and occupancy query of instance `inst` (LANE_COLUMNS or
// WARP_TABLES).
cudaError_t launch(int inst, const Args& a, int block, cudaStream_t s) {
  return inst == WARP_TABLES ? Replay<WARP_TABLES>::launch(a, block, s)
                             : Replay<LANE_COLUMNS>::launch(a, block, s);
}

cudaError_t occupancy(int inst, int T, int C, int block, int* per_sm) {
  return inst == WARP_TABLES
             ? Replay<WARP_TABLES>::occupancy(T, C, block, per_sm)
             : Replay<LANE_COLUMNS>::occupancy(T, C, block, per_sm);
}

bool shape_ok(int T, int C, int block, int inst) {
  return (inst == LANE_COLUMNS || inst == WARP_TABLES) && T >= 1 && C >= 0 &&
         C <= T && block > 0 && block <= 1024 && block % 32 == 0;
}

}  // namespace

// Launches the replay on `stream`.  codes [iters][n] int32, the three
// tprev planes [iters][n] and ghat channels [n] float32, ca and cb [T][3],
// bg [3], cb_row [T] and cb_tex [C] int32 are device memory (cb_row and
// cb_tex may be null where C == 0); partial receives [ceil(n / block)][3 (T
// + C) + 3] floats (tex_ca rows, the C tex_cb rows, background).  instance
// 0 takes the per-lane columns, 1 the per-warp tables.  Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape or instance the kernel does not take.
extern "C" int art_mega_replay(const int* codes, const float* tp_x,
                               const float* tp_y, const float* tp_z,
                               const float* g_x, const float* g_y,
                               const float* g_z, const float* ca,
                               const float* cb, const float* bg,
                               const int* cb_row, const int* cb_tex,
                               int iters, int n, int T, int C, int flags,
                               int block, int instance, float* partial,
                               void* stream) {
  if (iters < 0 || n < 0 || !shape_ok(T, C, block, instance) ||
      (C > 0 && (cb_row == nullptr || cb_tex == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const Args a{codes, {tp_x, tp_y, tp_z}, {g_x, g_y, g_z}, ca, cb, bg,
               cb_row, cb_tex, iters, n, T, C, flags, partial};
  return (int)launch(instance, a, block, static_cast<cudaStream_t>(stream));
}

// Blocks of one instance resident on an SM at once (the occupancy query),
// into *per_sm.  Returns a CUDA error code (0 on success).
extern "C" int art_mega_replay_occupancy(int T, int C, int block,
                                         int instance, int* per_sm) {
  if (!shape_ok(T, C, block, instance)) return (int)cudaErrorInvalidValue;
  return (int)occupancy(instance, T, C, block, per_sm);
}

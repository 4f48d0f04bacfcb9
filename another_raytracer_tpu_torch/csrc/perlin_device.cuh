// K4's Perlin noise of one point, shared by the Perlin kernel
// (perlin_kernel.cu, one thread a point) and the bounce kernel
// (bounce_kernel.cu, a noise texture's lane): perlin.h:29-96, with the
// operations and their order of ops/shade.py::perlin_noise.  Included inside
// each source's anonymous namespace; both are built with -fmad=false, so the
// noise is the plain version's bit for bit.

constexpr int PERLIN_N = 256;

// `ran` is one packed table set (perlin_kernel.py's pack_tables): 256 ranvec
// float4 (x, y, z, 0), then per axis 256 16-bit words perm[i] |
// perm[(i + 1) & 255] << 8.
__device__ __forceinline__ float perlin_at(const float4* ran, float x, float y,
                                           float z) {
  const uint16_t* words = reinterpret_cast<const uint16_t*>(ran + PERLIN_N);
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const float u = x - fx, v = y - fy, w = z - fz;
  const int ii = (int)fx, jj = (int)fy, kk = (int)fz;
  // Hermite smoothing u*u*(3-2u) (perlin.h:80-82).
  const float uu = u * u * (3.0f - 2.0f * u);
  const float vv = v * v * (3.0f - 2.0f * v);
  const float ww = w * w * (3.0f - 2.0f * w);
  // Each word holds an axis's entries at the lattice index and the next.
  const unsigned wx = words[ii & 255];
  const unsigned wy = words[PERLIN_N + (jj & 255)];
  const unsigned wz = words[2 * PERLIN_N + (kk & 255)];

  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const unsigned g =
            ((wx >> (8 * di)) ^ (wy >> (8 * dj)) ^ (wz >> (8 * dk))) & 255u;
        const float4 gr = ran[g];
        const float wgt = (di ? uu : 1.0f - uu) * (dj ? vv : 1.0f - vv) *
                          (dk ? ww : 1.0f - ww);
        const float dot = gr.x * (di ? u - 1.0f : u) +
                          gr.y * (dj ? v - 1.0f : v) +
                          gr.z * (dk ? w - 1.0f : w);
        accum = accum + wgt * dot;
      }
    }
  }
  return accum;
}

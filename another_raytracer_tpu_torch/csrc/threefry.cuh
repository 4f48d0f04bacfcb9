// threefry-2x32 draws shared by the megakernel's forward builds (K1, K3,
// the draws kernel) and the bounce kernel: ops/rng.py's uniform2, bit for
// bit.  Included inside each source's anonymous namespace, after the source
// defines ROUNDS (13, ops/rng.py's ROUNDS); it includes nothing itself.

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

// Fused reparameterized Gaussian sampling for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel sample_normal_fused -> _sample_pallas (body
// _sample_kernel) in multimodal_vae_comparison_tpu/ops/pallas/sample_kernel.py:
//   z = mu + scale * eps,  eps = sqrt(-2 log u1) cos(2 pi u2)   (Box-Muller)
// with u1, u2 from two uint32 draws per element made inside the kernel, so
// the noise never comes from device memory; eps is written for the backward.
//
// The TPU kernel draws from the core's own generator; here the draws come
// from Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3"), keyed by the 64-bit seed, with the element index as the
// counter: words 0 and 1 of the output block are the two draws.  The stream
// therefore differs from the TPU's by nature; the bits -> normal map is
// exactly _boxmuller_from_bits: u1 = (a >> 8) 2^-24 + 1e-7, u2 = (b >> 8)
// 2^-24, unsigned shifts.
//
// What bounds it on the card: 8 bytes read and 8 written per element
// against ~60 integer and ~30 fp32 operations, so memory traffic; at the
// sizes a VAE samples (a few thousand latents) launch latency is all of its
// time.  One thread per element with a grid-stride loop, consecutive
// threads on consecutive addresses.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr float INV_2_24 = 1.0f / 16777216.0f;
constexpr float TWO_PI = 6.283185307179586f;

// words 0 and 1 of Philox4x32-10 on counter (idx, 0, 0) under key (k0, k1)
__device__ __forceinline__ void philox_two(unsigned long long idx, uint32_t k0,
                                           uint32_t k1, uint32_t& a, uint32_t& b) {
  uint32_t c0 = (uint32_t)idx, c1 = (uint32_t)(idx >> 32), c2 = 0u, c3 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  a = c0;
  b = c1;
}

__global__ void __launch_bounds__(THREADS)
sample_normal(const float* __restrict__ mu, const float* __restrict__ scale,
              float* __restrict__ z, float* __restrict__ eps, long long n,
              uint32_t k0, uint32_t k1) {
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * THREADS) {
    uint32_t a, b;
    philox_two((unsigned long long)idx, k0, k1, a, b);
    const float u1 = (float)(a >> 8) * INV_2_24 + 1e-7f;
    const float u2 = (float)(b >> 8) * INV_2_24;
    const float e = sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI * u2);
    eps[idx] = e;
    z[idx] = mu[idx] + scale[idx] * e;
  }
}

}  // namespace

extern "C" {

// mu, scale, z, eps: n contiguous fp32 on the device, n >= 1; the key is the
// low and high word of the seed.  Launches on `stream` and returns
// cudaGetLastError().
int sample_forward(const void* mu, const void* scale, void* z, void* eps,
                   long long n, unsigned int seed_lo, unsigned int seed_hi,
                   void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride covers the rest
  sample_normal<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)mu, (const float*)scale, (float*)z, (float*)eps, n, seed_lo,
      seed_hi);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

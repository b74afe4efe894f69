// KL(N(mu, scale) || N(0, 1)) summed over the last axis, for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel kl_normal_std_fused -> _kl_pallas (body
// _kl_kernel) in multimodal_vae_comparison_tpu/ops/pallas/kl_kernel.py:
//   out[r] = sum_d 0.5 * (scale^2 + mu^2 - 1 - log(scale^2)),
// over (rows, D) contiguous inputs -> (rows,), rows = numel / D.
//
// What bounds it on the card: ~7 FLOP and one log per 8 bytes read, so it is
// bound by memory traffic.  At the training shape (24, 16) per modality the
// call reads 2 * 24 * 16 * 4 B and writes 96 B, about 1 ns at 3.35 TB/s:
// launch latency is all of its time, and one launch in place of the plain
// version's chain of elementwise launches is what the kernel buys.
//
// Layout: one warp per row, with a grid-stride loop over rows; lanes stride
// over D (consecutive lanes on consecutive addresses) and accumulate in fp32
// registers; a __shfl_xor_sync tree reduces across the warp and lane 0
// writes.  logf (not __logf) keeps the result within 1e-6 of the plain
// version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;  // rows per block per pass
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = WARP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
kl_std_fwd(const float* __restrict__ mu, const float* __restrict__ scale,
           float* __restrict__ out, long long rows, int d) {
  const int lane = threadIdx.x % WARP;
  // r is the same for every lane of a warp, so the whole warp enters and
  // leaves the loop together and the full-mask shuffle is safe
  for (long long r = (long long)blockIdx.x * WARPS + threadIdx.x / WARP;
       r < rows; r += (long long)gridDim.x * WARPS) {
    const float* m = mu + r * d;
    const float* s = scale + r * d;
    float acc = 0.f;
    for (int j = lane; j < d; j += WARP) {
      const float var = s[j] * s[j];
      acc += 0.5f * (var + m[j] * m[j] - 1.f - logf(var));
    }
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

}  // namespace

extern "C" {

// mu, scale: (rows, d) contiguous fp32 on the device, rows >= 1, d >= 1;
// out: (rows,).  Launches on `stream` and returns cudaGetLastError().
int kl_forward(const void* mu, const void* scale, void* out, long long rows,
               int d, void* stream) {
  long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride covers the rest
  kl_std_fwd<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)mu, (const float*)scale, (float*)out, rows, d);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

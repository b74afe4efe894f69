// Product-of-experts precision fusion forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel poe_fused -> _poe_pallas (body _poe_kernel)
// in multimodal_vae_comparison_tpu/ops/pallas/poe_kernel.py:
//   prec_e = 1 / (scale_e^2 + EPS),  P = p0 + sum_e prec_e,
//   mu = (sum_e mu_e prec_e) / P,    scale = sqrt(1 / P),
// over stacked experts (E, N) -> two outputs (N,), N = prod of (..., D).
//
// What bounds it on the card: it does ~5 FLOP per 8 bytes read, so it is
// bound by memory traffic; at the serving shape (E <= 2, 128 x 16) the call
// moves about 50 KB and launch latency is all of its time.  The design reads
// each input once and writes each output once, with one thread per output
// element looping over E (a runtime argument) in registers; consecutive
// threads touch consecutive addresses, and a grid-stride loop covers any N.
// The TPU kernel's VMEM-size gate (_poe_eligible) has no counterpart here.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float EPS = 1e-8f;  // constants.EPS
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
poe_fwd(const float* __restrict__ mus, const float* __restrict__ scales,
        float* __restrict__ mu_out, float* __restrict__ scale_out,
        long long n, int experts, float prior_precision) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc_prec = 0.f, acc_mu = 0.f;
    for (int e = 0; e < experts; ++e) {
      const float s = scales[e * n + i];
      const float prec = 1.f / (s * s + EPS);
      acc_prec += prec;
      acc_mu += mus[e * n + i] * prec;
    }
    const float denom = acc_prec + prior_precision;
    mu_out[i] = acc_mu / denom;
    scale_out[i] = sqrtf(1.f / denom);
  }
}

}  // namespace

extern "C" {

// mus, scales: (E, N) contiguous fp32 on the device; mu_out, scale_out: (N,).
// Launches on `stream` and returns cudaGetLastError().
int poe_forward(const void* mus, const void* scales, void* mu_out,
                void* scale_out, long long n, int experts,
                float prior_precision, void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  poe_fwd<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)mus, (const float*)scales, (float*)mu_out,
      (float*)scale_out, n, experts, prior_precision);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// Product-of-experts precision fusion over a whole subset lattice, forward
// and backward, for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel poe_fused -> _poe_pallas (body _poe_kernel)
// in multimodal_vae_comparison_tpu/ops/pallas/poe_kernel.py, and its
// closed-form VJP _poe_bwd, which the JAX package runs as jnp outside the
// kernel.  For every subset s of the M experts (a bitmask over M <= 8):
//   prec_e = 1 / (scale_e^2 + EPS),  P_s = sum_{e in s} prec_e + p0,
//   mu_s = (sum_{e in s} mu_e prec_e) / P_s,  scale_s = sqrt(1 / P_s),
// over experts of N = prod(..., D) elements each -> (S, N) outputs; the
// one-subset case (S = 1, all experts) is the TPU kernel's own function.
// The backward sums the closed form of _poe_bwd over the subsets that hold
// each expert, in lattice order:
//   d_mu_e    = sum_s g_mu_s prec_e inv_s,              inv_s = scale_s^2
//   d_scale_e = sum_s (g_mu_s inv_s (mu_e - mu_s) - 0.5 g_scale_s inv_s scale_s)
//                     * (-2 scale_e / var_e^2).
//
// What bounds it on this card: the launch.  The training lattice (M = 2,
// S = 3, N = 24 x 16) moves about 20 KB a call, a few nanoseconds at 3.35
// TB/s against some microseconds to launch; bytes bound it only at N of
// millions.  A subset a launch, with its backward in torch ops, cost the
// POE objective about 20 launches a subset and a step.
//
// The design does the whole lattice in one launch each way.  One thread
// owns element n across all experts and subsets: it reads its M expert
// pairs once into registers (each expert is read once for all subsets, not
// once per subset) and forms every subset's sums from them; the backward's
// thread adds its experts' gradients over the subsets in registers, so
// there are no atomics and the order of every sum is fixed.  The experts
// come as M pointers and the lattice as S bitmasks, both passed by value in
// the kernel's parameters: the caller stacks nothing, and no table is
// copied to the device, so a launch is safe inside a CUDA graph.
//
// At these sizes a thread's chain of dependent latencies is the kernel's
// time past the launch, so the design shortens it: every expert's loads,
// and four subsets' backward inputs at a time, are issued before any is
// used, so their memory latencies overlap; the forward's per-subset
// division and square root are __fdividef and rsqrtf (about 2 ulp), not
// IEEE-rounded with their slow-path branches (kernel_variants.py measures
// both choices).  Everything else is rounded one operation at a time
// (__fmul_rn, __fadd_rn), as the plain PyTorch version computes it, so the
// backward equals the plain closed form bit for bit and no fused
// multiply-add moves a result.  The TPU kernel's VMEM-size gate
// (_poe_eligible) has no counterpart here.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float EPS = 1e-8f;  // constants.EPS
constexpr int THREADS = 128;
constexpr int MAX_EXPERTS = 8;
constexpr int MAX_SUBSETS = 32;
constexpr int CHUNK = 4;  // subsets whose backward inputs load together

struct Experts {
  const float* mu[MAX_EXPERTS];
  const float* scale[MAX_EXPERTS];
};

struct Lattice {
  unsigned int mask[MAX_SUBSETS];  // bit e set: expert e is in the subset
};

// Every expert's mean and stddev at element i, all loads issued before any
// is used: the arithmetic after each load (an IEEE division branches to its
// slow path) would otherwise keep the next load from starting, and each
// expert would cost a memory latency of its own.
__device__ __forceinline__ void load_experts(const Experts& ex, int experts, long long i,
                                             float (&mu)[MAX_EXPERTS],
                                             float (&scale)[MAX_EXPERTS]) {
#pragma unroll
  for (int e = 0; e < MAX_EXPERTS; ++e) {
    mu[e] = scale[e] = 0.f;
    if (e < experts) {
      mu[e] = ex.mu[e][i];
      scale[e] = ex.scale[e][i];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
poe_lattice_fwd(Experts ex, Lattice lat, int experts, int subsets,
                float* __restrict__ mu_out, float* __restrict__ scale_out,
                long long n, float prior_precision) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float mu[MAX_EXPERTS], scale[MAX_EXPERTS], prec[MAX_EXPERTS], weighted[MAX_EXPERTS];
    load_experts(ex, experts, i, mu, scale);
#pragma unroll
    for (int e = 0; e < MAX_EXPERTS; ++e) {
      prec[e] = weighted[e] = 0.f;
      if (e < experts) {
        prec[e] = 1.f / __fadd_rn(__fmul_rn(scale[e], scale[e]), EPS);
        weighted[e] = __fmul_rn(mu[e], prec[e]);
      }
    }
    for (int k = 0; k < subsets; ++k) {
      const unsigned int mask = lat.mask[k];
      float acc_prec = 0.f, acc_mu = 0.f;
#pragma unroll
      for (int e = 0; e < MAX_EXPERTS; ++e) {
        if (mask >> e & 1u) {
          acc_prec = __fadd_rn(acc_prec, prec[e]);
          acc_mu = __fadd_rn(acc_mu, weighted[e]);
        }
      }
      const float denom = __fadd_rn(acc_prec, prior_precision);
      // about 2 ulp each, where IEEE rounding's slow-path branches cost a
      // third of a microsecond a subset
      mu_out[k * n + i] = __fdividef(acc_mu, denom);
      scale_out[k * n + i] = rsqrtf(denom);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
poe_lattice_bwd(Experts ex, Lattice lat, int experts, int subsets,
                const float* __restrict__ g_mu, const float* __restrict__ g_scale,
                const float* __restrict__ mu_out, const float* __restrict__ scale_out,
                float* __restrict__ d_mus, float* __restrict__ d_scales, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float mu[MAX_EXPERTS], scale[MAX_EXPERTS], prec[MAX_EXPERTS], dprec_dscale[MAX_EXPERTS];
    float d_mu[MAX_EXPERTS], d_scale[MAX_EXPERTS];
    load_experts(ex, experts, i, mu, scale);
#pragma unroll
    for (int e = 0; e < MAX_EXPERTS; ++e) {
      prec[e] = dprec_dscale[e] = d_mu[e] = d_scale[e] = 0.f;
      if (e < experts) {
        const float s = scale[e];
        const float var = __fadd_rn(__fmul_rn(s, s), EPS);
        prec[e] = 1.f / var;
        // d prec_e / d scale_e = -2 scale_e / var_e^2
        dprec_dscale[e] = __fmul_rn(-2.f, s) / __fmul_rn(var, var);
      }
    }
    // CHUNK subsets' four inputs are loaded together before any of them is
    // used, so their memory latencies overlap
    for (int k0 = 0; k0 < subsets; k0 += CHUNK) {
      float gm[CHUNK], gs[CHUNK], mu_k[CHUNK], scale_k[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        gm[c] = gs[c] = mu_k[c] = scale_k[c] = 0.f;
        if (k0 + c < subsets) {
          const long long at = (k0 + c) * n + i;
          gm[c] = g_mu[at];
          gs[c] = g_scale[at];
          mu_k[c] = mu_out[at];
          scale_k[c] = scale_out[at];
        }
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const unsigned int mask = k0 + c < subsets ? lat.mask[k0 + c] : 0u;
        const float inv = __fmul_rn(scale_k[c], scale_k[c]);  // 1 / P_k
        const float gm_inv = __fmul_rn(gm[c], inv);
        // d scale_k / d prec_e = -0.5 inv^(3/2)
        const float gs_term = __fmul_rn(__fmul_rn(__fmul_rn(gs[c], -0.5f), inv), scale_k[c]);
#pragma unroll
        for (int e = 0; e < MAX_EXPERTS; ++e) {
          if (mask >> e & 1u) {
            d_mu[e] = __fadd_rn(d_mu[e], __fmul_rn(__fmul_rn(gm[c], prec[e]), inv));
            const float g_prec =
                __fadd_rn(__fmul_rn(gm_inv, __fsub_rn(mu[e], mu_k[c])), gs_term);
            d_scale[e] = __fadd_rn(d_scale[e], __fmul_rn(g_prec, dprec_dscale[e]));
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < MAX_EXPERTS; ++e) {
      if (e < experts) {
        d_mus[e * n + i] = d_mu[e];
        d_scales[e * n + i] = d_scale[e];
      }
    }
  }
}

unsigned int grid_for(long long n) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride covers the rest
  return blocks < 1 ? 1u : (unsigned int)blocks;
}

// The experts and lattice as kernel parameters; false where the counts or a
// mask fall outside what the kernels take.
bool pack(const void* const* mus, const void* const* scales, int experts,
          const unsigned int* masks, int subsets, Experts* ex, Lattice* lat) {
  if (experts < 1 || experts > MAX_EXPERTS || subsets < 1 || subsets > MAX_SUBSETS)
    return false;
  for (int e = 0; e < MAX_EXPERTS; ++e) {
    ex->mu[e] = e < experts ? (const float*)mus[e] : nullptr;
    ex->scale[e] = e < experts ? (const float*)scales[e] : nullptr;
  }
  const unsigned int all = (1u << experts) - 1u;
  for (int k = 0; k < MAX_SUBSETS; ++k) {
    lat->mask[k] = k < subsets ? masks[k] : 0u;
    if (k < subsets && (masks[k] == 0u || (masks[k] & ~all) != 0u)) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// mus, scales: host arrays of `experts` device pointers, each to N
// contiguous fp32; masks: host array of `subsets` non-empty bitmasks over
// the experts; mu_out, scale_out: (subsets, N) contiguous fp32.  Launches
// one kernel on `stream` and returns cudaGetLastError().
int poe_lattice_forward(const void* const* mus, const void* const* scales, int experts,
                        const unsigned int* masks, int subsets, void* mu_out,
                        void* scale_out, long long n, float prior_precision,
                        void* stream) {
  Experts ex;
  Lattice lat;
  if (!pack(mus, scales, experts, masks, subsets, &ex, &lat) || n < 1)
    return (int)cudaErrorInvalidValue;
  poe_lattice_fwd<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      ex, lat, experts, subsets, (float*)mu_out, (float*)scale_out, n, prior_precision);
  return (int)cudaGetLastError();
}

// As poe_lattice_forward, plus g_mu, g_scale: (subsets, N) gradients of the
// outputs; mu_out, scale_out: the forward's outputs; d_mus, d_scales:
// (experts, N) contiguous fp32, each expert's gradient summed over the
// subsets that hold it (0 where none does).
int poe_lattice_backward(const void* const* mus, const void* const* scales, int experts,
                         const unsigned int* masks, int subsets, const void* g_mu,
                         const void* g_scale, const void* mu_out, const void* scale_out,
                         void* d_mus, void* d_scales, long long n, void* stream) {
  Experts ex;
  Lattice lat;
  if (!pack(mus, scales, experts, masks, subsets, &ex, &lat) || n < 1)
    return (int)cudaErrorInvalidValue;
  poe_lattice_bwd<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      ex, lat, experts, subsets, (const float*)g_mu, (const float*)g_scale,
      (const float*)mu_out, (const float*)scale_out, (float*)d_mus, (float*)d_scales, n);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// KL(N(mu, scale) || N(0, 1)) summed over the last axis, for M posteriors at
// once, forward and backward, for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel kl_normal_std_fused -> _kl_pallas (body
// _kl_kernel) in multimodal_vae_comparison_tpu/ops/pallas/kl_kernel.py, and
// its closed-form VJP _kl_bwd, which the JAX package runs as jnp outside the
// kernel:
//   out[m, r]      = sum_d 0.5 * (scale^2 + mu^2 - 1 - log(scale^2)),
//   d_mu[m, r, d]    = g[m, r] * mu,
//   d_scale[m, r, d] = g[m, r] * (scale - 1 / scale),
// over M <= 8 posteriors of (rows, D) contiguous elements each.  M = 1 is
// the TPU kernel's own function.
//
// What bounds it on this card: the launch.  At the training shape (M = 2
// posteriors of (24, 16)) the forward reads 6 KB and writes 192 B, about
// 2 ns at 3.35 TB/s against some microseconds to launch; bytes bound it only
// at rows of millions.  One launch per modality, a stack of the results and
// a backward of four torch ops per modality cost the MOE objective about 11
// launches a step.
//
// The design does all M posteriors in one launch each way and writes the
// (M, rows) tensor that the objective stacked before.  The posteriors come
// as M pointer pairs passed by value in the kernel's parameters, so nothing
// is stacked or copied to the device and a launch is safe inside a CUDA
// graph; the grid's y is the posterior, so no thread divides a 64-bit index
// to find it.  Forward: one warp per (posterior, row), with a grid-stride
// loop over the rows; lanes stride over D (consecutive lanes on consecutive
// addresses) and accumulate in fp32 registers; a __shfl_xor_sync tree
// reduces across the warp and lane 0 writes.  logf (not __logf) keeps the
// result within 1e-6 of the plain version.  Backward: one thread per
// element, its loads issued before its division; the upstream gradient is
// read through its strides, so the broadcast gradient of a sum needs no
// copy.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;  // rows per block per pass
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_POSTERIORS = 8;

struct Posteriors {
  const float* mu[MAX_POSTERIORS];
  const float* scale[MAX_POSTERIORS];
};

// a[m] by constant indices only: a runtime index into the parameter struct
// would copy it to the stack
__device__ __forceinline__ const float* pick(const float* const (&a)[MAX_POSTERIORS], int m) {
  const float* out = a[0];
#pragma unroll
  for (int k = 1; k < MAX_POSTERIORS; ++k)
    if (m == k) out = a[k];
  return out;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = WARP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
kl_std_multi_fwd(Posteriors p, float* __restrict__ out, long long rows, int d) {
  const int lane = threadIdx.x % WARP, m = blockIdx.y;
  const float* mu = pick(p.mu, m);
  const float* scale = pick(p.scale, m);
  // r is the same for every lane of a warp, so the whole warp enters and
  // leaves the loop together and the full-mask shuffle is safe
  for (long long r = (long long)blockIdx.x * WARPS + threadIdx.x / WARP; r < rows;
       r += (long long)gridDim.x * WARPS) {
    float acc = 0.f;
    for (int j = lane; j < d; j += WARP) {
      const float sj = scale[r * d + j], mj = mu[r * d + j];
      const float var = sj * sj;
      acc += 0.5f * (var + mj * mj - 1.f - logf(var));
    }
    acc = warp_sum(acc);
    if (lane == 0) out[m * rows + r] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
kl_std_multi_bwd(Posteriors p, const float* __restrict__ g, long long g_stride_m,
                 long long g_stride_r, float* __restrict__ d_mu,
                 float* __restrict__ d_scale, long long n, int d) {
  const int m = blockIdx.y;
  const float* mu = pick(p.mu, m);
  const float* scale = pick(p.scale, m);
  const float* up_m = g + m * g_stride_m;
  // the row of element i: a 32-bit division wherever n allows one
  const bool narrow = n <= 0xffffffffLL;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = narrow ? (long long)((unsigned int)i / (unsigned int)d) : i / d;
    const float up = up_m[row * g_stride_r];
    const float s = scale[i], mi = mu[i];
    d_mu[m * n + i] = up * mi;
    d_scale[m * n + i] = up * (s - 1.f / s);
  }
}

dim3 grid_for(long long units, int per_block, int m) {
  long long blocks = (units + per_block - 1) / per_block;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride covers the rest
  return dim3(blocks < 1 ? 1u : (unsigned int)blocks, (unsigned int)m);
}

bool pack(const void* const* mus, const void* const* scales, int m, Posteriors* p) {
  if (m < 1 || m > MAX_POSTERIORS) return false;
  for (int k = 0; k < MAX_POSTERIORS; ++k) {
    p->mu[k] = k < m ? (const float*)mus[k] : nullptr;
    p->scale[k] = k < m ? (const float*)scales[k] : nullptr;
  }
  return true;
}

}  // namespace

extern "C" {

// mus, scales: host arrays of m device pointers, each to (rows, d)
// contiguous fp32, rows >= 1, d >= 1; out: (m, rows) contiguous fp32.
// Launches one kernel on `stream` and returns cudaGetLastError().
int kl_multi_forward(const void* const* mus, const void* const* scales, int m, void* out,
                     long long rows, int d, void* stream) {
  Posteriors p;
  if (!pack(mus, scales, m, &p) || rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  kl_std_multi_fwd<<<grid_for(rows, WARPS, m), THREADS, 0, (cudaStream_t)stream>>>(
      p, (float*)out, rows, d);
  return (int)cudaGetLastError();
}

// As kl_multi_forward, plus g: the (m, rows) gradient of the output at
// element strides g_stride_m, g_stride_r (0 where it is broadcast); d_mu,
// d_scale: (m, rows, d) contiguous fp32.
int kl_multi_backward(const void* const* mus, const void* const* scales, int m,
                      const void* g, long long g_stride_m, long long g_stride_r,
                      void* d_mu, void* d_scale, long long rows, int d, void* stream) {
  Posteriors p;
  if (!pack(mus, scales, m, &p) || rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const long long n = rows * d;
  kl_std_multi_bwd<<<grid_for(n, THREADS, m), THREADS, 0, (cudaStream_t)stream>>>(
      p, (const float*)g, g_stride_m, g_stride_r, (float*)d_mu, (float*)d_scale, n, d);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

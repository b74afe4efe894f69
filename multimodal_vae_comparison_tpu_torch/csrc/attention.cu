// Masked attention forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel masked_flash_attention -> _flash_pallas
// (body _attn_kernel) in multimodal_vae_comparison_tpu/ops/pallas/attention.py:
//   out = softmax(q k^T / sqrt(Dh) + bias) v,  bias = 0 or -1e30 per key,
// with an online softmax over chunks of keys and fp32 accumulators.
//
// What bounds it on the card: at the serving shapes (Tq = Tk = 45, Dh = 32;
// Tq = 45, Tk = 1, Dh = 8) a head is a few KB and the whole call moves a few
// MB at ~2 FLOP per byte, so it is bound by memory traffic and, at these
// sizes, by launch latency.  The design keeps every intermediate (scores,
// probabilities, running max and sum) in registers and shared memory and
// reads each input from device memory once per block, writing the output
// once; no tensor cores (fp32, Dh as small as 8).
//
// Layout: one block per (batch*head, tile of ROWS query rows); one warp per
// query row.  K and V of the head are staged in shared memory KV_CHUNK keys
// at a time.  For a chunk, lane j scores key j (a Dh-long dot product from
// shared memory), the warp reduces max and sum with shuffles, and for p.v
// each lane owns the output dims lane, lane+32, ... (Dh <= 128).
//
// Masking is additive with -1e30 exactly as the TPU kernel does it; masked
// keys are not skipped, so a row with every key masked gives the uniform
// average of V, as the Pallas kernel and the XLA path both give.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int ROWS = 8;          // query rows (= warps) per block
constexpr int KV_CHUNK = 32;     // keys per shared-memory chunk, one per lane
constexpr int MAX_DH = 128;
constexpr int DH_SLOTS = MAX_DH / WARP;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = WARP / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = WARP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(ROWS * WARP)
masked_attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ key_mask,  // (B, Tk) or null
                     float* __restrict__ out, int heads, int tq, int tk,
                     int dh, float sm_scale) {
  __shared__ float ks[KV_CHUNK][MAX_DH + 1];  // +1: lanes read rows, no bank conflicts
  __shared__ float vs[KV_CHUNK][MAX_DH];
  __shared__ float qs[ROWS][MAX_DH];
  __shared__ float bias[KV_CHUNK];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.y * ROWS + warp;
  const bool active = row < tq;

  const float* qrow = q + ((size_t)bh * tq + row) * dh;
  for (int d = lane; d < dh; d += WARP) qs[warp][d] = active ? qrow[d] * sm_scale : 0.f;

  const float* kh = k + (size_t)bh * tk * dh;
  const float* vh = v + (size_t)bh * tk * dh;
  float acc[DH_SLOTS];
#pragma unroll
  for (int i = 0; i < DH_SLOTS; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < tk; k0 += KV_CHUNK) {
    const int n = min(KV_CHUNK, tk - k0);
    __syncthreads();  // the previous chunk is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < n * dh; idx += blockDim.x) {
      const int j = idx / dh, d = idx - j * dh;
      ks[j][d] = kh[(size_t)(k0 + j) * dh + d];
      vs[j][d] = vh[(size_t)(k0 + j) * dh + d];
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      bias[j] = (key_mask == nullptr || key_mask[(size_t)b * tk + k0 + j]) ? 0.f : NEG_INF;
    __syncthreads();
    if (!active) continue;

    float s = -INFINITY;  // lanes past the chunk take no part
    if (lane < n) {
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qs[warp][d] * ks[lane][d];
      s = dot + bias[lane];
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = lane < n ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DH_SLOTS; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
      for (int i = 0; i < DH_SLOTS; ++i) {
        const int d = lane + i * WARP;
        if (d < dh) acc[i] += pj * vs[j][d];
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = out + ((size_t)bh * tq + row) * dh;
#pragma unroll
    for (int i = 0; i < DH_SLOTS; ++i) {
      const int d = lane + i * WARP;
      if (d < dh) orow[d] = acc[i] * inv;
    }
  }
}

}  // namespace

extern "C" {

// q: (B*H, Tq, Dh), k/v: (B*H, Tk, Dh), out: (B*H, Tq, Dh), all contiguous
// fp32 on the device; key_mask: (B, Tk) bool (1 byte) or null.  Launches on
// `stream` and returns cudaGetLastError().
int masked_attention_forward(const void* q, const void* k, const void* v,
                             const void* key_mask, void* out, int batch,
                             int heads, int tq, int tk, int dh,
                             float sm_scale, void* stream) {
  dim3 grid(batch * heads, (tq + ROWS - 1) / ROWS);
  masked_attention_fwd<<<grid, ROWS * WARP, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)key_mask, (float*)out, heads, tq, tk, dh, sm_scale);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

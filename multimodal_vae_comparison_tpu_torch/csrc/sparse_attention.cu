// Strided block-sparse causal self-attention for Hopper (sm_90a), fp32:
// forward (with the row log-sum-exp), dq, and dk/dv.
//
// Replaces the Pallas TPU kernels of
// multimodal_vae_comparison_tpu/ops/pallas/sparse_attention.py:
//   strided_block_sparse_attention -> _sparse_pallas (body _sparse_kernel),
//   _sparse_backward_pallas (bodies _dq_kernel and _dkv_kernel).
// Query block i sees its own block (causal inside) and every stride-th
// earlier block in full:
//   o   = softmax(q k^T / sqrt(Dh) + mask) v      over the live key blocks
//   lse = row log-sum-exp of the masked scores
//   p = exp(s - lse), ds = p (do v^T - delta), delta = rowsum(do * o)
//   dq = sum ds k / sqrt(Dh);  dv = sum p^T do;  dk = sum ds^T (q / sqrt(Dh))
//
// What bounds it on the card: at T = 2048, block 128, stride 4, Dh 32 a
// head has 40 live block pairs of 256 and each pair costs 4 * 128 * 128 * Dh
// FLOP against 32 KiB of K and V, about 128 FLOP per byte: the forward is
// bound by fp32 operations, and so are the backward kernels (6 and 8
// * 128 * 128 * Dh FLOP per pair).  No tensor cores: the products are fp32.
//
// Design (the TPU grid is not carried over: it walks (bh, query block, live
// slot) in order with the running state in scratch between steps).  Here
// one thread block owns one (batch*head, query block) -- for dk/dv one
// (batch*head, key block) -- and loops over its live blocks itself.  The
// live set needs no table: key block j is live for query block i iff
// j <= i and (i - j) % stride == 0, walked in increasing j, diagonal last.
// One thread owns one row: its q (or k, v) row, the running max and sum and
// its Dh accumulators stay in registers; the other side's tiles are staged
// through shared memory (two tiles of block x Dh) and read as float4
// broadcasts, every thread of a warp on the same address.  The diagonal
// mask is added as -1e30 like the TPU kernel does, so control flow stays
// uniform.  dk/dv accumulate in registers and are written once: no atomics,
// so the result is deterministic.  Dh is padded to DHP in {4,8,16,32,64}
// (zeros) so that the inner loops unroll; block <= 128 rows per tile.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_BLOCK = 128;   // rows per tile = threads per block
constexpr int CHUNK = 16;        // keys scored before one rescale of the row
constexpr float NEG_INF = -1e30f;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

// rows x dh floats at g -> rows x DHP at s, zero padded, times mul
template <int DHP>
__device__ __forceinline__ void stage_tile(float* s, const float* __restrict__ g,
                                           int rows, int dh, float mul) {
  for (int idx = threadIdx.x; idx < rows * DHP; idx += blockDim.x) {
    const int r = idx / DHP, d = idx - r * DHP;
    s[idx] = d < dh ? g[(size_t)r * dh + d] * mul : 0.f;
  }
}

template <int DHP>
__device__ __forceinline__ void load_row(float (&x)[DHP], const float* __restrict__ g,
                                         int dh, float mul) {
#pragma unroll
  for (int d = 0; d < DHP; ++d) x[d] = d < dh ? g[d] * mul : 0.f;
}

template <int DHP>
__device__ __forceinline__ float dot_row(const float (&x)[DHP], const float4* row) {
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < DHP / 4; ++d4) {
    const float4 y = row[d4];
    acc += x[4 * d4] * y.x + x[4 * d4 + 1] * y.y + x[4 * d4 + 2] * y.z
           + x[4 * d4 + 3] * y.w;
  }
  return acc;
}

template <int DHP>
__device__ __forceinline__ void axpy_row(float (&acc)[DHP], float a, const float4* row) {
#pragma unroll
  for (int d4 = 0; d4 < DHP / 4; ++d4) {
    const float4 y = row[d4];
    acc[4 * d4] += a * y.x;
    acc[4 * d4 + 1] += a * y.y;
    acc[4 * d4 + 2] += a * y.z;
    acc[4 * d4 + 3] += a * y.w;
  }
}

// grid (batch*heads, T / block), `block` threads
template <int DHP>
__global__ void __launch_bounds__(MAX_BLOCK)
sparse_fwd(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int t, int dh, int block, int stride,
           float sm_scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + block * DHP;
  const int i = blockIdx.y;
  const int r = threadIdx.x;
  const size_t head = (size_t)blockIdx.x * t * dh;
  const size_t row = (size_t)blockIdx.x * t + (size_t)i * block + r;

  float qr[DHP], acc[DHP];
  load_row<DHP>(qr, q + row * dh, dh, sm_scale);
#pragma unroll
  for (int d = 0; d < DHP; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int j = i % stride; j <= i; j += stride) {
    __syncthreads();  // the previous tiles are consumed
    stage_tile<DHP>(ks, k + head + (size_t)j * block * dh, block, dh, 1.f);
    stage_tile<DHP>(vs, v + head + (size_t)j * block * dh, block, dh, 1.f);
    __syncthreads();
    const bool diag = j == i;
    for (int j0 = 0; j0 < block; j0 += CHUNK) {
      float s[CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const int key = j0 + jj;   // key < block is uniform over the block
        if (key < block) {
          const float dot = dot_row<DHP>(
              qr, reinterpret_cast<const float4*>(ks + key * DHP));
          s[jj] = dot + ((diag && key > r) ? NEG_INF : 0.f);
        } else {
          s[jj] = -INFINITY;
        }
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DHP; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const int key = j0 + jj;
        if (key < block) {
          const float p = expf(s[jj] - m_new);
          l += p;
          axpy_row<DHP>(acc, p, reinterpret_cast<const float4*>(vs + key * DHP));
        }
      }
      m = m_new;
    }
  }

  const float denom = fmaxf(l, 1e-30f);
  const float inv = 1.f / denom;
  float* orow = o + row * dh;
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    if (d < dh) orow[d] = acc[d] * inv;
  lse[row] = m + logf(denom);
}

// grid (batch*heads, T / block), `block` threads
template <int DHP>
__global__ void __launch_bounds__(MAX_BLOCK)
sparse_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ d_out,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int t, int dh, int block, int stride,
          float sm_scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + block * DHP;
  const int i = blockIdx.y;
  const int r = threadIdx.x;
  const size_t head = (size_t)blockIdx.x * t * dh;
  const size_t row = (size_t)blockIdx.x * t + (size_t)i * block + r;

  float qr[DHP], dor[DHP], acc[DHP];
  load_row<DHP>(qr, q + row * dh, dh, sm_scale);
  load_row<DHP>(dor, d_out + row * dh, dh, 1.f);
#pragma unroll
  for (int d = 0; d < DHP; ++d) acc[d] = 0.f;
  const float lse_r = lse[row], delta_r = delta[row];

  for (int j = i % stride; j <= i; j += stride) {
    __syncthreads();
    stage_tile<DHP>(ks, k + head + (size_t)j * block * dh, block, dh, 1.f);
    stage_tile<DHP>(vs, v + head + (size_t)j * block * dh, block, dh, 1.f);
    __syncthreads();
    const bool diag = j == i;
    for (int key = 0; key < block; ++key) {
      const float4* krow = reinterpret_cast<const float4*>(ks + key * DHP);
      const float4* vrow = reinterpret_cast<const float4*>(vs + key * DHP);
      const float s = dot_row<DHP>(qr, krow) + ((diag && key > r) ? NEG_INF : 0.f);
      const float p = expf(s - lse_r);
      const float ds = p * (dot_row<DHP>(dor, vrow) - delta_r);
      axpy_row<DHP>(acc, ds, krow);
    }
  }

  float* out = dq + row * dh;
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    if (d < dh) out[d] = acc[d] * sm_scale;
}

// grid (batch*heads, T / block) over KEY blocks, `block` threads, one key
// row each; walks the query blocks i = j, j + stride, ... that see block j
template <int DHP>
__global__ void __launch_bounds__(MAX_BLOCK)
sparse_dkv(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ d_out,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int t, int dh,
           int block, int stride, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // q rows, already scaled
  float* dos = qs + block * DHP;
  float* lses = dos + block * DHP;
  float* deltas = lses + block;
  const int j = blockIdx.y;
  const int c = threadIdx.x;
  const int nq = t / block;
  const size_t head = (size_t)blockIdx.x * t * dh;
  const size_t row = (size_t)blockIdx.x * t + (size_t)j * block + c;

  float kr[DHP], vr[DHP], dkr[DHP], dvr[DHP];
  load_row<DHP>(kr, k + row * dh, dh, 1.f);
  load_row<DHP>(vr, v + row * dh, dh, 1.f);
#pragma unroll
  for (int d = 0; d < DHP; ++d) dkr[d] = dvr[d] = 0.f;

  for (int i = j; i < nq; i += stride) {
    __syncthreads();
    stage_tile<DHP>(qs, q + head + (size_t)i * block * dh, block, dh, sm_scale);
    stage_tile<DHP>(dos, d_out + head + (size_t)i * block * dh, block, dh, 1.f);
    const size_t rows = (size_t)blockIdx.x * t + (size_t)i * block;
    lses[c] = lse[rows + c];
    deltas[c] = delta[rows + c];
    __syncthreads();
    const bool diag = i == j;
    for (int r = 0; r < block; ++r) {
      const float4* qrow = reinterpret_cast<const float4*>(qs + r * DHP);
      const float4* dorow = reinterpret_cast<const float4*>(dos + r * DHP);
      const float s = dot_row<DHP>(kr, qrow) + ((diag && c > r) ? NEG_INF : 0.f);
      const float p = expf(s - lses[r]);
      const float ds = p * (dot_row<DHP>(vr, dorow) - deltas[r]);
      axpy_row<DHP>(dvr, p, dorow);
      axpy_row<DHP>(dkr, ds, qrow);
    }
  }

  float* dk_out = dk + row * dh;
  float* dv_out = dv + row * dh;
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    if (d < dh) {
      dk_out[d] = dkr[d];
      dv_out[d] = dvr[d];
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= STATIC_SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DHP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o,
                       float* lse, int bh, int t, int dh, int block, int stride,
                       float sm_scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)block * DHP * sizeof(float);
  cudaError_t err = allow_smem(sparse_fwd<DHP>, smem);
  if (err != cudaSuccess) return err;
  sparse_fwd<DHP><<<dim3(bh, t / block), block, smem, stream>>>(
      q, k, v, o, lse, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

template <int DHP>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* d_out, const float* lse, const float* delta,
                      float* dq, int bh, int t, int dh, int block, int stride,
                      float sm_scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)block * DHP * sizeof(float);
  cudaError_t err = allow_smem(sparse_dq<DHP>, smem);
  if (err != cudaSuccess) return err;
  sparse_dq<DHP><<<dim3(bh, t / block), block, smem, stream>>>(
      q, k, v, d_out, lse, delta, dq, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

template <int DHP>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* d_out, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int t, int dh, int block,
                       int stride, float sm_scale, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)block * DHP + 2 * (size_t)block) * sizeof(float);
  cudaError_t err = allow_smem(sparse_dkv<DHP>, smem);
  if (err != cudaSuccess) return err;
  sparse_dkv<DHP><<<dim3(bh, t / block), block, smem, stream>>>(
      q, k, v, d_out, lse, delta, dk, dv, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

// the smallest padded head width that holds dh (the wrapper keeps dh <= 64)
#define FOR_HEAD_DIM(dh, LAUNCH)            \
  ((dh) <= 4 ? LAUNCH(4) : (dh) <= 8 ? LAUNCH(8) : (dh) <= 16 ? LAUNCH(16) \
   : (dh) <= 32 ? LAUNCH(32) : LAUNCH(64))

}  // namespace

extern "C" {

// All tensors contiguous fp32 on the device: q, k, v, o, d_out, dq, dk, dv
// (bh, t, dh); lse, delta (bh, t).  1 <= dh <= 64, 1 <= block <= 128,
// t % block == 0, t / block <= 65535, stride >= 1.  Each launches on
// `stream` and returns the cudaError_t of the launch.
int sparse_attention_forward(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int t, int dh, int block,
                             int stride, float sm_scale, void* stream) {
#define LAUNCH(DHP)                                                          \
  launch_fwd<DHP>((const float*)q, (const float*)k, (const float*)v, (float*)o, \
                  (float*)lse, bh, t, dh, block, stride, sm_scale,           \
                  (cudaStream_t)stream)
  return (int)FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

int sparse_attention_dq(const void* q, const void* k, const void* v,
                        const void* d_out, const void* lse, const void* delta,
                        void* dq, int bh, int t, int dh, int block, int stride,
                        float sm_scale, void* stream) {
#define LAUNCH(DHP)                                                          \
  launch_dq<DHP>((const float*)q, (const float*)k, (const float*)v,          \
                 (const float*)d_out, (const float*)lse, (const float*)delta, \
                 (float*)dq, bh, t, dh, block, stride, sm_scale,             \
                 (cudaStream_t)stream)
  return (int)FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

int sparse_attention_dkv(const void* q, const void* k, const void* v,
                         const void* d_out, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int t, int dh, int block,
                         int stride, float sm_scale, void* stream) {
#define LAUNCH(DHP)                                                          \
  launch_dkv<DHP>((const float*)q, (const float*)k, (const float*)v,         \
                  (const float*)d_out, (const float*)lse, (const float*)delta, \
                  (float*)dk, (float*)dv, bh, t, dh, block, stride, sm_scale, \
                  (cudaStream_t)stream)
  return (int)FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

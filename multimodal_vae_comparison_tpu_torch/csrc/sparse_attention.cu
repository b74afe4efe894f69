// Strided block-sparse causal self-attention for Hopper (sm_90a): forward
// (with the row log-sum-exp), dq, and dk/dv, on fp32 or bf16 q, k, v.
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
// FLOP against 32 KiB of K and V, about 128 FLOP per byte: all three kernels
// are bound by operations (the backward kernels do 6 and 8 * 128 * 128 * Dh
// FLOP per pair).  In fp32 FMAs that bound is the card's 67 TFLOP/s; on
// the tensor cores, three TF32 products per fp32 product at 495 TFLOP/s.
//
// The TPU grid is not carried over: it walks (bh, query block, live slot)
// in order with the running state in scratch between steps.  Here a thread
// block owns its query rows (for dk/dv its key rows) and loops over its live
// blocks itself.  The live set needs no table: key block j is live for
// query block i iff j <= i and (i - j) % stride == 0, walked in increasing
// j, diagonal last.
//
// Forward, sparse_fwd_mma (block a multiple of 16, Dh a multiple of 4 and
// >= 8, 16-byte aligned inputs).  The two products run on the tensor cores
// at fp32-grade accuracy: mma.sync m16n8k8 TF32 with the 3xTF32 split,
// x = hi + lo, a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, fp32 accumulate (a
// single TF32 pass keeps three digits and misses the tolerance the model
// trains at).  A thread block is 4 warps; a warp owns two row tiles of 16
// query rows (one for Dh 64 and block 16), so that every K and V fragment it
// reads and splits feeds six MMAs.  Its Q fragments (scaled by log2(e) /
// sqrt(Dh), split once) stay in registers.  K and V tiles go through a
// two-stage ring in shared memory filled by cp.async, the next live tile
// loading under the current one's math; rows are padded by 4 floats, which
// makes both the K^T and the V fragment reads conflict-free.  Keys are taken
// 32 at a time: S = Q K^T, the online softmax in base 2 (one ex2 per score)
// with row max over the quad by shuffles and the row sum reduced once at the
// end, then O = alpha O + P V with P straight from the accumulators: the A
// operand's columns are taken as the keys 2t, 2t + 1 that thread t already
// holds, and V's rows are read in the same order, so no shuffle is needed.
// The tensor core truncates toward zero each time it accumulates, and such
// one-sided errors add up along a row instead of averaging out (the video
// model's gradients felt 12 chained MMAs per score and 48 per 32 keys of
// output).  So the hi hi terms run in chains of Dh / 8 (scores) and 4 (a
// chunk's P V) MMAs from zero, the cross terms in accumulators of their own,
// and the pieces are added in fp32 with rounding.  On the diagonal tile a
// warp stops at its own last row and masks the one partly visible chunk with
// -1e30.  Heavy query blocks are scheduled first.  No atomics: reruns are
// bit-identical.
//
// dq and dk/dv, sparse_dq_mma and sparse_dkv_mma (the same shapes), run all
// five products of the backward the same way: 3xTF32, hi hi chains of Dh / 8
// MMAs for a score or dP and 4 for a chunk's share of dQ, dK or dV, summed in
// fp32 into accumulators that persist across chunks.  dq is the forward's
// skeleton with q and d_out fragments resident and P = 2^(S - lse log2 e)
// (lse is known, so no running max); dk/dv is key-block-major and transposed
// (S^T = K Q^T, dP^T = V dO^T), so that each operand keeps a fragment pattern
// of the forward, with k and v resident and the q and d_out tiles, lse and
// delta of each query block that sees the key block in the cp.async ring.
// One row tile a warp: two operands and two accumulators fill the registers.
// Heavy blocks first (late query blocks for dq, early key blocks for dk/dv);
// dk and dv are written once by the block that owns their rows, no atomics.
//
// Forward, dq and dk/dv for the other shapes (sparse_fwd, sparse_dq,
// sparse_dkv): one thread owns one row; its q (or k, v) row, the running max and sum and its Dh
// accumulators stay in registers; the other side's tiles are staged through
// shared memory (two tiles of block x Dh) and read as float4 broadcasts,
// every thread of a warp on the same address.  The diagonal mask is added as
// -1e30 like the TPU kernel does, so control flow stays uniform.  dk/dv
// accumulate in registers and are written once: no atomics, so the result is
// deterministic.  Dh is padded to DHP in {4,8,16,32,64} (zeros) so that the
// inner loops unroll; block <= 128 rows per tile.
//
// Input dtype.  The kernels above are templates on the element type T of
// q, k and v, instantiated for float and __nv_bfloat16 (the launchers' _bf16
// instances).  bf16 is widened to fp32 where it is loaded, into registers or
// shared memory (exact), so the arithmetic after it is the fp32 kernels'.
// o, lse, d_out and delta are fp32 in both; dq, dk and dv are written in T,
// as the Pallas kernels cast them back to the inputs' dtype.  The 3xTF32
// kernels' staging moves 4 elements a thread: a 16-byte cp.async for fp32,
// an 8-byte load widened into a float4 for bf16 (synchronous, so the next
// tile no longer loads under the current one's math: the bf16 dq and dk/dv
// still do so).  Their rule (Dh % 4 == 0 and 16-byte aligned tensors) keeps
// every bf16 unit 8-byte aligned and every bf16 pair that store_rows writes
// 4-byte aligned, so it holds for both types.
//
// bf16 forward on bf16 tensor cores, sparse_fwd_tc (the bf16 launcher where
// tc_takes the shape: mma_takes and Dh % 8 == 0).  The widened 3xTF32
// kernel ran slower on bf16 than on fp32 inputs: synchronous staging, and
// three TF32 MMAs per 8 of depth of which one multiplies the zero lo plane
// of a widened k or v.  This one keeps sparse_fwd_mma's grid, schedule
// (heavy query blocks first, the live set walked without a table), warps of
// MT row tiles and masking, and runs its products as bf16_tc.cuh does: K
// and V tiles staged in bf16 by cp.async in a two-stage ring (half the
// shared memory), S = Q K^T on one bf16 MMA per 16 of depth with q and k as
// they are (sm_scale log2 e applied to the fp32 S, not folded into q, which
// would make q inexact in bf16), P V as two MMAs on P's hi and lo bf16
// planes.  What bounds it on the card: at the video decoder's (80, 2, 2048,
// 32) its bytes (bf16 q, k, v in, fp32 out and lse out), 0.032 ms at 3.35
// TB/s, above its MMAs' 6 Dh FLOP per visible pair at the dense bf16 rate
// of 989 TFLOP/s, 0.016 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_tc.cuh"

namespace {

constexpr int MAX_BLOCK = 128;   // rows per tile = threads per block
constexpr int CHUNK = 16;        // keys scored before one rescale of the row
constexpr float NEG_INF = -1e30f;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows x dh floats at g -> rows x DHP at s, zero padded, times mul
template <int DHP, typename S>
__device__ __forceinline__ void stage_tile(float* s, const S* __restrict__ g,
                                           int rows, int dh, float mul) {
  for (int idx = threadIdx.x; idx < rows * DHP; idx += blockDim.x) {
    const int r = idx / DHP, d = idx - r * DHP;
    s[idx] = d < dh ? to_f(g[(size_t)r * dh + d]) * mul : 0.f;
  }
}

template <int DHP, typename S>
__device__ __forceinline__ void load_row(float (&x)[DHP], const S* __restrict__ g,
                                         int dh, float mul) {
#pragma unroll
  for (int d = 0; d < DHP; ++d) x[d] = d < dh ? to_f(g[d]) * mul : 0.f;
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
template <typename T, int DHP>
__global__ void __launch_bounds__(MAX_BLOCK)
sparse_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, float* __restrict__ o,
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

// ---- forward on the tensor cores ------------------------------------------

constexpr int MMA_WARPS = 4;     // warps per thread block, 16 * MT query rows each
constexpr int MMA_KEYS = 32;     // keys per online-softmax step: 4 n-tiles of 8
constexpr int MMA_PAD = 4;       // floats added to a shared-memory row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// 4 consecutive elements at g -> 4 floats at s (16-byte aligned): an async
// copy for fp32; for bf16 an 8-byte load, widened
__device__ __forceinline__ void stage4(float* s, const float* g) { cp_async16(s, g); }
__device__ __forceinline__ void stage4(float* s, const __nv_bfloat16* g) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  *reinterpret_cast<float4*>(s) = make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x in one instruction; 0 for -inf and for the -1e30 of a masked pair
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits), lo the exact
// remainder, of which the tensor core reads the leading 10 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row) b (8 x 8, col).  Thread (g = lane / 4,
// t = lane % 4) holds a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b0, b1 = B[t][g], B[t+4][g]; c[0..3] = C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big[m][n] + small[m][n] += a[m] b[n] for M x N independent accumulator
// pairs at fp32-grade accuracy: big takes the hi hi term, small the two
// cross terms.  b[n] = (b0[n], b1[n]) is split here, once for all M row
// tiles, and each term runs over all accumulators before the next, so that
// consecutive MMAs do not wait for each other.  The tensor core truncates
// where it accumulates, each time toward zero, and along a row of the
// attention matrix those errors do not average out; so the chains on big
// are kept short (the caller starts from zero every few MMAs and adds the
// pieces up in fp32 with rounding), and small, 2^-11 of the size, may run on.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&big)[M][N][4], float (&small)[M][N][4],
                                           const uint32_t (&a_hi)[M][4],
                                           const uint32_t (&a_lo)[M][4],
                                           const float (&b0)[N], const float (&b1)[N]) {
  uint32_t b0_hi[N], b0_lo[N], b1_hi[N], b1_lo[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_tf32(b0[n], b0_hi[n], b0_lo[n]);
    split_tf32(b1[n], b1_hi[n], b1_lo[n]);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(small[m][n], a_lo[m], b0_hi[n], b1_hi[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(small[m][n], a_hi[m], b0_lo[n], b1_lo[n]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(big[m][n], a_hi[m], b0_hi[n], b1_hi[n]);
}

// rows x dh elements at g -> rows x (DHP + MMA_PAD) floats at s, 4 elements
// a copy (stage4: async for fp32); the units past dh are zeros
template <int DHP, typename S>
__device__ __forceinline__ void stage_tile_async(float* s, const S* __restrict__ g,
                                                 int rows, int dh) {
  constexpr int UNITS = DHP / 4;
  for (int idx = threadIdx.x; idx < rows * UNITS; idx += blockDim.x) {
    const int r = idx / UNITS, c = 4 * (idx % UNITS);
    float* dst = s + r * (DHP + MMA_PAD) + c;
    if (c < dh) stage4(dst, g + (size_t)r * dh + c);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A warp owns MT row tiles of 16 query rows, a thread block 4 warps.
// grid (batch*heads, (T / block) * ceil(block / (64 * MT))), 32 * min(4,
// ceil(block / (16 * MT))) threads; dynamic shared memory 4 * block *
// (DHP + 4) floats (two stages of a K and a V tile).  block % 16 == 0,
// dh % 4 == 0, 8 <= dh <= DHP.
template <typename T, int DHP, int MT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
sparse_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int t, int dh, int block, int stride,
               float sm_scale) {
  constexpr int KS = DHP / 8;            // k-steps of q k^T = n-tiles of p v
  constexpr int LD = DHP + MMA_PAD;
  constexpr int NT = MMA_KEYS / 8;       // n-tiles of q k^T = k-steps of p v
  constexpr int WARP_ROWS = 16 * MT, BLOCK_ROWS = MMA_WARPS * WARP_ROWS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = block * LD;           // floats of one staged tile

  const int nsub = (block + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int y = gridDim.y - 1 - blockIdx.y;   // late (heavy) query blocks first
  const int i = y / nsub, sub = y - i * nsub;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = sub * BLOCK_ROWS + warp * WARP_ROWS;  // the warp's first row in the block
  const bool active = r0 < block;
  const size_t head = (size_t)blockIdx.x * t * dh;
  const size_t row0 = (size_t)blockIdx.x * t + (size_t)i * block + r0;

  const int first = i % stride, n_tiles = i / stride + 1;
  stage_tile_async<DHP>(smem, k + head + (size_t)first * block * dh, block, dh);
  stage_tile_async<DHP>(smem + tile, v + head + (size_t)first * block * dh, block, dh);
  cp_async_commit();

  // q fragments, scaled so that the scores are base-2 logits, split once;
  // a row tile past the block's end (block % 32 == 16) holds zeros
  uint32_t q_hi[KS][MT][4], q_lo[KS][MT][4];
  float acc[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ks * 8 + tg + (e >> 1) * 4;
        const int row = mt * 16 + g + (e & 1) * 8;
        const float x = (r0 + row < block && col < dh)
            ? to_f(q[(row0 + row) * dh + col]) * (sm_scale * LOG2E) : 0.f;
        split_tf32(x, q_hi[ks][mt][e], q_lo[ks][mt][e]);
        acc[mt][ks][e] = 0.f;
      }
  float m[MT][2], l[MT][2];   // rows g and g + 8 of each row tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j = first + kt * stride;
    if (kt + 1 < n_tiles) {   // the next live tile loads under this one's math
      float* next = smem + ((kt + 1) & 1) * 2 * tile;
      stage_tile_async<DHP>(next, k + head + (size_t)(j + stride) * block * dh, block, dh);
      stage_tile_async<DHP>(next + tile, v + head + (size_t)(j + stride) * block * dh,
                            block, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* ks_tile = smem + (kt & 1) * 2 * tile;
      const float* vs_tile = ks_tile + tile;
      const bool diag = j == i;
      // on the diagonal no key after this warp's last row is visible
      const int key_end = diag ? min(block, r0 + WARP_ROWS) : block;
      for (int key0 = 0; key0 < key_end; key0 += MMA_KEYS) {
        // n-tiles past key_end (the diagonal's masked keys, or the end of a
        // block that is not a multiple of 32) read the last valid one again
        // and are set to -inf below
        const int nt_valid = min(NT, (key_end - key0) >> 3);
        const float* kp[NT];
        float s[MT][NT][4], s_small[MT][NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          kp[nt] = ks_tile + (key0 + min(nt, nt_valid - 1) * 8 + g) * LD + tg;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][nt][e] = s_small[mt][nt][e] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          float b0[NT], b1[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            b0[nt] = kp[nt][ks * 8];
            b1[nt] = kp[nt][ks * 8 + 4];
          }
          mma_3xtf32<MT, NT>(s, s_small, q_hi[ks], q_lo[ks], b0, b1);
        }
        const bool masked = diag && key0 + MMA_KEYS - 1 > r0;   // some key > some row
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + nt * 8 + 2 * tg + (e & 1);
              const int row = r0 + mt * 16 + g + (e >> 1) * 8;
              s[mt][nt][e] += s_small[mt][nt][e];
              if (nt >= nt_valid) s[mt][nt][e] = -INFINITY;
              else if (masked && key > row) s[mt][nt][e] = NEG_INF;
            }
        float alpha[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // rows g and g + 8
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mx = fmaxf(mx, fmaxf(s[mt][nt][2 * h], s[mt][nt][2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[mt][h], mx);
            alpha[mt][h] = ex2(m[mt][h] - m_new);
            m[mt][h] = m_new;
            l[mt][h] *= alpha[mt][h];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 2 * h; e < 2 * h + 2; ++e) {
                s[mt][nt][e] = ex2(s[mt][nt][e] - m_new);
                l[mt][h] += s[mt][nt][e];   // this thread's share; the quad sums at the end
              }
          }
        // o = alpha o + p v, the chunk's p v summed from zero.  The A
        // operand's columns t, t + 4 are taken as the keys 2t, 2t + 1 this
        // thread holds, and V's rows are read in that order.  p is 0 past
        // nt_valid, where V's last valid rows are read again.
        float pv[MT][KS][4], pv_small[MT][KS][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[mt][ks][e] = pv_small[mt][ks][e] = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t p_hi[MT][4], p_lo[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            split_tf32(s[mt][nt][0], p_hi[mt][0], p_lo[mt][0]);
            split_tf32(s[mt][nt][2], p_hi[mt][1], p_lo[mt][1]);
            split_tf32(s[mt][nt][1], p_hi[mt][2], p_lo[mt][2]);
            split_tf32(s[mt][nt][3], p_hi[mt][3], p_lo[mt][3]);
          }
          const float* vp = vs_tile + (key0 + min(nt, nt_valid - 1) * 8 + 2 * tg) * LD + g;
          float b0[KS], b1[KS];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            b0[ks] = vp[ks * 8];
            b1[ks] = vp[LD + ks * 8];
          }
          mma_3xtf32<MT, KS>(pv, pv_small, p_hi, p_lo, b0, b1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][ks][e] = fmaf(acc[mt][ks][e], alpha[mt][e >> 1],
                                    pv[mt][ks][e] + pv_small[mt][ks][e]);
      }
    }
    __syncthreads();   // the stage is free for the tile after the next
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[mt][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int r = mt * 16 + g + 8 * h;
      if (r0 + r < block) {
        const float denom = fmaxf(sum, 1e-30f);
        const float inv = 1.f / denom;
        const size_t row = row0 + r;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int col = ks * 8 + 2 * tg;
          if (col < dh)
            *reinterpret_cast<float2*>(o + row * dh + col) =
                make_float2(acc[mt][ks][2 * h] * inv, acc[mt][ks][2 * h + 1] * inv);
        }
        if (tg == 0) lse[row] = (m[mt][h] + log2f(denom)) * LN2;
      }
    }
}

// ---- bf16 forward on bf16 tensor cores -------------------------------------

constexpr int TC_STAGES = 2;   // key blocks in flight

// The grid, threads and warps' row tiles of sparse_fwd_mma<_, _, MT>;
// dynamic shared memory TC_STAGES * 2 * block * row_stride(DHP) bf16 (a K
// and a V tile a stage).  block % 16 == 0, dh % 8 == 0, 8 <= dh <= DHP,
// q, k, v 16-byte aligned.
template <int DHP, int MT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
sparse_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int t, int dh, int block, int stride,
              float sm_scale) {
  constexpr int DT = DHP / 8;
  constexpr int WARP_ROWS = 16 * MT, BLOCK_ROWS = MMA_WARPS * WARP_ROWS;
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  const int tile = block * bf16tc::row_stride(DHP);   // elements of one staged tile

  const int nsub = (block + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int y = gridDim.y - 1 - blockIdx.y;   // late (heavy) query blocks first
  const int i = y / nsub, sub = y - i * nsub;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = sub * BLOCK_ROWS + warp * WARP_ROWS;  // the warp's first row in the block
  const bool active = r0 < block;
  const size_t head = (size_t)blockIdx.x * t * dh;
  const size_t row0 = (size_t)blockIdx.x * t + (size_t)i * block + r0;

  const int first = i % stride, n_tiles = i / stride + 1;
  auto issue = [&](int kt) {   // live key block kt into its stage; a group even when empty
    if (kt < n_tiles) {
      __nv_bfloat16* stage = ring + (kt % TC_STAGES) * 2 * tile;
      const size_t at = head + (size_t)(first + kt * stride) * block * dh;
      bf16tc::stage_rows<DHP>(stage, k + at, block, block, dh);
      bf16tc::stage_rows<DHP>(stage + tile, v + at, block, block, dh);
    }
    bf16tc::commit();
  };
#pragma unroll
  for (int kt = 0; kt < TC_STAGES - 1; ++kt) issue(kt);

  // q fragments as they are; a row tile past the block's end holds zeros
  uint32_t qf[DHP / 16][MT][4];
  bf16tc::load_q<DHP, MT>(qf, q + row0 * dh, active ? block - r0 : 0, dh);
  float acc[MT][DT][4];
  float m[MT][2], l[MT][2];   // rows g and g + 8 of each row tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }
  const float scale2 = sm_scale * LOG2E;

  for (int kt = 0; kt < n_tiles; ++kt) {
    bf16tc::wait<TC_STAGES - 2>();   // key block kt has landed (this thread's copies)
    __syncthreads();                 // everyone's, and block kt - 1's stage is free
    issue(kt + TC_STAGES - 1);
    if (active) {
      const __nv_bfloat16* ks = ring + (kt % TC_STAGES) * 2 * tile;
      const bool diag = first + kt * stride == i;
      // on the diagonal no key after this warp's last row is visible
      const int key_end = diag ? min(block, r0 + WARP_ROWS) : block;
      for (int key0 = 0; key0 < key_end; key0 += bf16tc::KEYS) {
        // n-tiles past key_end (the diagonal's masked keys, or the end of a
        // block that is not a multiple of 32) are -inf; their rows past the
        // block read its last row again
        const int nt_valid = min(bf16tc::NT, (key_end - key0) >> 3);
        const bool masked = diag && key0 + bf16tc::KEYS - 1 > r0;   // some key > some row
        bf16tc::step<DHP, MT>(
            qf, ks, ks + tile, key0, block - 1,
            [&](float s, int mt, int nt, int e) {
              const int key = key0 + nt * 8 + 2 * tg + (e & 1);
              const int row = r0 + mt * 16 + g + (e >> 1) * 8;
              return nt >= nt_valid ? -INFINITY : masked && key > row ? NEG_INF : s * scale2;
            },
            m, l, acc);
      }
    }
  }

  bf16tc::row_sums<MT>(l);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (active && r0 + r < block) {
        const float denom = fmaxf(l[mt][h], 1e-30f);
        const float inv = 1.f / denom;
        const size_t row = row0 + r;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const int col = dt * 8 + 2 * tg;
          if (col < dh)
            *reinterpret_cast<float2*>(o + row * dh + col) =
                make_float2(acc[mt][dt][2 * h] * inv, acc[mt][dt][2 * h + 1] * inv);
        }
        if (tg == 0) lse[row] = (m[mt][h] + log2f(denom)) * LN2;
      }
    }
}

// grid (batch*heads, T / block), `block` threads
template <typename T, int DHP>
__global__ void __launch_bounds__(MAX_BLOCK)
sparse_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ d_out,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int t, int dh, int block, int stride,
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

  T* out = dq + row * dh;
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    if (d < dh) out[d] = from_f<T>(acc[d] * sm_scale);
}

// grid (batch*heads, T / block) over KEY blocks, `block` threads, one key
// row each; walks the query blocks i = j, j + stride, ... that see block j
template <typename T, int DHP>
__global__ void __launch_bounds__(MAX_BLOCK)
sparse_dkv(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ d_out,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int t, int dh,
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

  T* dk_out = dk + row * dh;
  T* dv_out = dv + row * dh;
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    if (d < dh) {
      dk_out[d] = from_f<T>(dkr[d]);
      dv_out[d] = from_f<T>(dvr[d]);
    }
}

// ---- backward on the tensor cores ------------------------------------------

// Where a backward kernel keeps the operands whose rows a warp owns: in
// registers, split once, up to Dh 32; for Dh 64, where two split operands
// beside two accumulators overflow the 255 registers (ptxas spilled 256 and
// 424 bytes even with the operands unsplit), in shared memory, staged once.
__host__ __device__ constexpr bool rows_in_smem(int dhp) { return dhp > 32; }

// The A operand of the products whose rows a warp owns for the whole kernel
// (q and d_out in dq, k and v in dk/dv): MT row tiles of 16 rows over KS
// k-steps of 8 columns, in mma_tf32's A layout, times mul.  In registers it
// is split into TF32 hi/lo once; IN_SMEM it is read from the warp's rows
// staged in shared memory (rows padded by 4 floats: conflict-free) and split
// at each use.
template <int KS, int MT, bool IN_SMEM>
struct RowFrags {
  static constexpr int LD = KS * 8 + MMA_PAD;
  uint32_t w[IN_SMEM ? 1 : KS][MT][4][2];
  const float* staged;
  float mul;

  // rows r0 .. r0 + 16 MT of the rows x dh matrix at g (zeros past `rows`
  // and dh); IN_SMEM, the same rows staged at s instead
  template <typename S>
  __device__ __forceinline__ void load(const S* __restrict__ g, const float* s, int r0,
                                       int rows, int dh, float scale) {
    staged = s;
    mul = scale;
    if constexpr (!IN_SMEM) {
      const int lane = threadIdx.x & 31, gq = lane >> 2, tg = lane & 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = ks * 8 + tg + (e >> 1) * 4;
            const int row = r0 + mt * 16 + gq + (e & 1) * 8;
            const float x = (row < rows && col < dh) ? to_f(g[(size_t)row * dh + col]) * mul
                                                     : 0.f;
            split_tf32(x, w[ks][mt][e][0], w[ks][mt][e][1]);
          }
    }
  }

  __device__ __forceinline__ void get(int ks, uint32_t (&hi)[MT][4],
                                      uint32_t (&lo)[MT][4]) const {
    const int lane = threadIdx.x & 31, gq = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (IN_SMEM) {
          const float x = staged[(mt * 16 + gq + (e & 1) * 8) * LD + ks * 8 + tg
                                 + (e >> 1) * 4];
          split_tf32(x * mul, hi[mt][e], lo[mt][e]);
        } else {
          hi[mt][e] = w[ks][mt][e][0];
          lo[mt][e] = w[ks][mt][e][1];
        }
      }
  }
};

// c = a b^T over 32 rows of a staged tile from row0: the tile's rows are the
// product's columns (the keys of q k^T and d_out v^T in dq, the queries of
// k q^T and v d_out^T in dk/dv), read as the forward reads K.  The hi hi
// terms chain KS MMAs from zero, the cross terms apart, summed at the end.
// n-tiles past nt_valid read the last valid one again; the caller drops them.
template <int DHP, int MT, bool IN_SMEM>
__device__ __forceinline__ void tile_scores(float (&c)[MT][MMA_KEYS / 8][4],
                                            const RowFrags<DHP / 8, MT, IN_SMEM>& a,
                                            const float* tile, int row0, int nt_valid) {
  constexpr int KS = DHP / 8, NT = MMA_KEYS / 8, LD = DHP + MMA_PAD;
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  float small[MT][NT][4];
  const float* p[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    p[nt] = tile + (row0 + min(nt, nt_valid - 1) * 8 + g) * LD + tg;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = small[mt][nt][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float b0[NT], b1[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b0[nt] = p[nt][ks * 8];
      b1[nt] = p[nt][ks * 8 + 4];
    }
    uint32_t hi[MT][4], lo[MT][4];
    a.get(ks, hi, lo);
    mma_3xtf32<MT, NT>(c, small, hi, lo, b0, b1);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] += small[mt][nt][e];
}

// acc += a b over 32 rows of a staged tile from row0 (keys in dq, queries in
// dk/dv): a, in tile_scores' accumulator layout, is the A operand with its
// columns t, t + 4 taken as the rows 2t, 2t + 1 that thread t holds, and
// the tile's rows are read in that order (as the forward reads V), so no
// shuffle.  Each 16 x 8 piece of the chunk's product chains 4 hi hi MMAs
// from zero and is added to acc in fp32; at most 4 output n-tiles a pass
// (Dh 64 takes two) keep the partial sums within the registers.  a is 0
// past nt_valid, where the last valid rows are read again.
template <int DHP, int MT>
__device__ __forceinline__ void tile_accumulate(float (&acc)[MT][DHP / 8][4],
                                                const float (&a)[MT][MMA_KEYS / 8][4],
                                                const float* tile, int row0, int nt_valid) {
  constexpr int KS = DHP / 8, NT = MMA_KEYS / 8, LD = DHP + MMA_PAD;
  constexpr int KG = KS < 4 ? KS : 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += KG) {
    float part[MT][KG][4], small[MT][KG][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][kg][e] = small[mt][kg][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(a[mt][nt][0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(a[mt][nt][2], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(a[mt][nt][1], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(a[mt][nt][3], a_hi[mt][3], a_lo[mt][3]);
      }
      const float* bp = tile + (row0 + min(nt, nt_valid - 1) * 8 + 2 * tg) * LD + g;
      float b0[KG], b1[KG];
#pragma unroll
      for (int kg = 0; kg < KG; ++kg) {
        b0[kg] = bp[(k0 + kg) * 8];
        b1[kg] = bp[LD + (k0 + kg) * 8];
      }
      mma_3xtf32<MT, KG>(part, small, a_hi, a_lo, b0, b1);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][k0 + kg][e] += part[mt][kg][e] + small[mt][kg][e];
  }
}

// rows x dh of a warp's accumulator (row tiles of 16 from r0, its C layout)
// times mul, to the rows x dh matrix at g
__device__ __forceinline__ void store2(float* g, float a, float b) {
  *reinterpret_cast<float2*>(g) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* g, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(g) = __floats2bfloat162_rn(a, b);
}

template <int DHP, int MT, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ g,
                                           const float (&acc)[MT][DHP / 8][4], int r0,
                                           int rows, int dh, float mul) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + mt * 16 + gq + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int ks = 0; ks < DHP / 8; ++ks) {
        const int col = ks * 8 + 2 * tg;
        if (col < dh)
          store2(g + (size_t)row * dh + col, acc[mt][ks][2 * h] * mul,
                 acc[mt][ks][2 * h + 1] * mul);
      }
    }
}

// dq on the tensor cores, query-block-major: the forward's skeleton.  A warp
// owns MT row tiles of 16 query rows, their q (scaled so that scores are
// base-2 logits) and d_out fragments, lse * log2(e) and delta in registers;
// K and V tiles go through the two-stage cp.async ring.  Per 32 keys: S =
// Q K^T, P = 2^(S - lse2) (lse is known: no running max), dP = dO V^T, dS =
// P (dP - delta), dQ += dS K with dS straight from the accumulators.  Grid
// and threads as sparse_fwd_mma, heavy query blocks first; dynamic shared
// memory that of sparse_fwd_mma, and for Dh 64 the block's q and d_out rows
// after it (2 * 64 MT * (DHP + 4) floats).
template <typename T, int DHP, int MT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
sparse_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ d_out,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int t, int dh, int block, int stride,
              float sm_scale) {
  constexpr int KS = DHP / 8, NT = MMA_KEYS / 8, LD = DHP + MMA_PAD;
  constexpr int WARP_ROWS = 16 * MT, BLOCK_ROWS = MMA_WARPS * WARP_ROWS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = block * LD;

  const int nsub = (block + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int y = gridDim.y - 1 - blockIdx.y;   // late (heavy) query blocks first
  const int i = y / nsub, sub = y - i * nsub;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = sub * BLOCK_ROWS + warp * WARP_ROWS;
  const bool active = r0 < block;
  const size_t head = (size_t)blockIdx.x * t * dh;
  const size_t rows = (size_t)blockIdx.x * t + (size_t)i * block;   // the block's first row

  constexpr bool IN_SMEM = rows_in_smem(DHP);
  float* own = smem + 4 * tile;   // IN_SMEM: this block's q rows, then its d_out rows
  const int own_first = sub * BLOCK_ROWS, own_rows = min(BLOCK_ROWS, block - own_first);
  if (IN_SMEM) {
    stage_tile_async<DHP>(own, q + (rows + own_first) * dh, own_rows, dh);
    stage_tile_async<DHP>(own + BLOCK_ROWS * LD, d_out + (rows + own_first) * dh,
                          own_rows, dh);
  }
  const int first = i % stride, n_tiles = i / stride + 1;
  stage_tile_async<DHP>(smem, k + head + (size_t)first * block * dh, block, dh);
  stage_tile_async<DHP>(smem + tile, v + head + (size_t)first * block * dh, block, dh);
  cp_async_commit();

  RowFrags<KS, MT, IN_SMEM> qf, dof;
  const float* mine = own + warp * WARP_ROWS * LD;
  qf.load(q + rows * dh, mine, r0, block, dh, sm_scale * LOG2E);
  dof.load(d_out + rows * dh, mine + BLOCK_ROWS * LD, r0, block, dh, 1.f);
  float lse2[MT][2], dlt[MT][2], acc[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mt * 16 + g + 8 * h;
      lse2[mt][h] = r < block ? lse[rows + r] * LOG2E : 0.f;
      dlt[mt][h] = r < block ? delta[rows + r] : 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][ks][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j = first + kt * stride;
    if (kt + 1 < n_tiles) {   // the next live tile loads under this one's math
      float* next = smem + ((kt + 1) & 1) * 2 * tile;
      stage_tile_async<DHP>(next, k + head + (size_t)(j + stride) * block * dh, block, dh);
      stage_tile_async<DHP>(next + tile, v + head + (size_t)(j + stride) * block * dh,
                            block, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* ks_tile = smem + (kt & 1) * 2 * tile;
      const float* vs_tile = ks_tile + tile;
      const bool diag = j == i;
      // on the diagonal no key after this warp's last row is visible
      const int key_end = diag ? min(block, r0 + WARP_ROWS) : block;
      for (int key0 = 0; key0 < key_end; key0 += MMA_KEYS) {
        const int nt_valid = min(NT, (key_end - key0) >> 3);
        const bool masked = diag && key0 + MMA_KEYS - 1 > r0;   // some key > some row
        float s[MT][NT][4], dp[MT][NT][4];
        tile_scores<DHP, MT>(s, qf, ks_tile, key0, nt_valid);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = key0 + nt * 8 + 2 * tg + (e & 1);
              const int row = r0 + mt * 16 + g + (e >> 1) * 8;
              const bool hidden = nt >= nt_valid || (masked && key > row);
              s[mt][nt][e] = hidden ? 0.f : ex2(s[mt][nt][e] - lse2[mt][e >> 1]);
            }
        tile_scores<DHP, MT>(dp, dof, vs_tile, key0, nt_valid);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[mt][nt][e] *= dp[mt][nt][e] - dlt[mt][e >> 1];   // dS
        tile_accumulate<DHP, MT>(acc, s, ks_tile, key0, nt_valid);
      }
    }
    __syncthreads();   // the stage is free for the tile after the next
  }
  if (active) store_rows<DHP, MT>(dq + rows * dh, acc, r0, block, dh, sm_scale);
}

// dk/dv on the tensor cores, key-block-major and transposed, so that every
// operand keeps the forward's fragment patterns and no tile is transposed in
// shared memory.  A warp owns MT row tiles of 16 key rows, their k (scaled
// so that scores are base-2 logits) and v fragments in registers, and walks
// the query blocks i = j, j + stride, ... that see key block j; each one's q
// and d_out tiles, lse and delta go through the two-stage cp.async ring.
// Per 32 queries: S^T = K Q^T, P^T = 2^(S^T - lse2[query]), dV += P^T dO,
// dP^T = V dO^T, dS^T = P^T (dP^T - delta[query]), dK += dS^T Q; dk is
// scaled by sm_scale once at the end.  On the diagonal tile a warp starts
// at the query of its first key row and masks that one chunk.  dk and dv
// are written once, by the block that owns their rows: no atomics.  Grid
// (batch*heads, (T / block) * ceil(block / (64 * MT))), heavy (early) key
// blocks first; dynamic shared memory two stages of 2 * block * (DHP + 4)
// + 2 * block floats, and for Dh 64 the block's k and v rows after them (2 *
// 64 MT * (DHP + 4) floats).
template <typename T, int DHP, int MT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
sparse_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ d_out,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int t, int dh,
               int block, int stride, float sm_scale) {
  constexpr int KS = DHP / 8, NT = MMA_KEYS / 8, LD = DHP + MMA_PAD;
  constexpr int WARP_ROWS = 16 * MT, BLOCK_ROWS = MMA_WARPS * WARP_ROWS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = block * LD, stage = 2 * tile + 2 * block;

  const int nsub = (block + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int j = blockIdx.y / nsub, sub = blockIdx.y - j * nsub;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = sub * BLOCK_ROWS + warp * WARP_ROWS;   // the warp's first key row
  const bool active = r0 < block;
  const size_t head_row = (size_t)blockIdx.x * t;
  const size_t keys = head_row + (size_t)j * block;
  const int n_tiles = (t / block - 1 - j) / stride + 1;

  auto stage_query_block = [&](float* s, int i) {
    const size_t rows = head_row + (size_t)i * block;
    stage_tile_async<DHP>(s, q + rows * dh, block, dh);
    stage_tile_async<DHP>(s + tile, d_out + rows * dh, block, dh);
    for (int u = threadIdx.x; u < block / 4; u += blockDim.x) {
      cp_async16(s + 2 * tile + 4 * u, lse + rows + 4 * u);
      cp_async16(s + 2 * tile + block + 4 * u, delta + rows + 4 * u);
    }
    cp_async_commit();
  };
  constexpr bool IN_SMEM = rows_in_smem(DHP);
  float* own = smem + 2 * stage;   // IN_SMEM: this block's k rows, then its v rows
  const int own_first = sub * BLOCK_ROWS, own_rows = min(BLOCK_ROWS, block - own_first);
  if (IN_SMEM) {   // committed with the first query block
    stage_tile_async<DHP>(own, k + (keys + own_first) * dh, own_rows, dh);
    stage_tile_async<DHP>(own + BLOCK_ROWS * LD, v + (keys + own_first) * dh, own_rows, dh);
  }
  stage_query_block(smem, j);

  RowFrags<KS, MT, IN_SMEM> kf, vf;
  const float* mine = own + warp * WARP_ROWS * LD;
  kf.load(k + keys * dh, mine, r0, block, dh, sm_scale * LOG2E);
  vf.load(v + keys * dh, mine + BLOCK_ROWS * LD, r0, block, dh, 1.f);
  float dk_acc[MT][KS][4], dv_acc[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[mt][ks][e] = dv_acc[mt][ks][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {   // the next query block loads under this one's math
      stage_query_block(smem + ((it + 1) & 1) * stage, j + (it + 1) * stride);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* qs_tile = smem + (it & 1) * stage;
      const float* dos_tile = qs_tile + tile;
      const float* lse_s = qs_tile + 2 * tile;
      const float* delta_s = lse_s + block;
      const bool diag = it == 0;   // i == j
      // on the diagonal no query before this warp's first key row sees it
      for (int q0 = diag ? r0 : 0; q0 < block; q0 += MMA_KEYS) {
        const int nt_valid = min(NT, (block - q0) >> 3);
        const bool masked = diag && q0 < r0 + WARP_ROWS - 1;   // some query < some key
        float lse2[NT][2], dlt[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = q0 + min(nt, nt_valid - 1) * 8 + 2 * tg;
          const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 d = *reinterpret_cast<const float2*>(delta_s + c);
          lse2[nt][0] = l.x * LOG2E;
          lse2[nt][1] = l.y * LOG2E;
          dlt[nt][0] = d.x;
          dlt[nt][1] = d.y;
        }
        float s[MT][NT][4], dp[MT][NT][4];
        tile_scores<DHP, MT>(s, kf, qs_tile, q0, nt_valid);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int query = q0 + nt * 8 + 2 * tg + (e & 1);
              const int key = r0 + mt * 16 + g + (e >> 1) * 8;
              const bool hidden = nt >= nt_valid || (masked && query < key);
              s[mt][nt][e] = hidden ? 0.f : ex2(s[mt][nt][e] - lse2[nt][e & 1]);
            }
        tile_accumulate<DHP, MT>(dv_acc, s, dos_tile, q0, nt_valid);
        tile_scores<DHP, MT>(dp, vf, dos_tile, q0, nt_valid);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[mt][nt][e] *= dp[mt][nt][e] - dlt[nt][e & 1];   // dS^T
        tile_accumulate<DHP, MT>(dk_acc, s, qs_tile, q0, nt_valid);
      }
    }
    __syncthreads();   // the stage is free for the query block after the next
  }
  if (active) {
    store_rows<DHP, MT>(dk + keys * dh, dk_acc, r0, block, dh, sm_scale);
    store_rows<DHP, MT>(dv + keys * dh, dv_acc, r0, block, dh, 1.f);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= STATIC_SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DHP>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, float* o,
                       float* lse, int bh, int t, int dh, int block, int stride,
                       float sm_scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)block * DHP * sizeof(float);
  cudaError_t err = allow_smem(sparse_fwd<T, DHP>, smem);
  if (err != cudaSuccess) return err;
  sparse_fwd<T, DHP><<<dim3(bh, t / block), block, smem, stream>>>(
      q, k, v, o, lse, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

template <typename... P>
uintptr_t address_bits(P... p) {
  return ((uintptr_t)p | ...);
}

// whether the tensor-core kernels take the shape (`bits`: the addresses of
// every tensor they read or write, or-ed): else the FMA kernels do.  The
// grid bound is that of one row tile a warp, the tallest grid
bool mma_takes(uintptr_t bits, int t, int dh, int block) {
  return block % 16 == 0 && dh >= 8 && dh % 4 == 0 && bits % 16 == 0
         && (long long)(t / block) * ((block + 63) / 64) <= 65535;
}

// grid and threads of a tensor-core kernel whose warps own MT row tiles of
// 16 rows of a block, 4 warps to a thread block
template <int MT>
void mma_launch_shape(int bh, int t, int block, dim3& grid, int& threads) {
  const int warp_rows = 16 * MT, block_rows = MMA_WARPS * warp_rows;
  const int nsub = (block + block_rows - 1) / block_rows;
  const int row_tiles = (block + warp_rows - 1) / warp_rows;
  grid = dim3(bh, (t / block) * nsub);
  threads = 32 * (row_tiles < MMA_WARPS ? row_tiles : MMA_WARPS);
}

template <typename T, int DHP, int MT>
cudaError_t launch_fwd_mma(const T* q, const T* k, const T* v, float* o,
                           float* lse, int bh, int t, int dh, int block, int stride,
                           float sm_scale, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)block * (DHP + MMA_PAD) * sizeof(float);
  cudaError_t err = allow_smem(sparse_fwd_mma<T, DHP, MT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  int threads;
  mma_launch_shape<MT>(bh, t, block, grid, threads);
  sparse_fwd_mma<T, DHP, MT><<<grid, threads, smem, stream>>>(
      q, k, v, o, lse, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

template <int DHP, int MT>
cudaError_t launch_fwd_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, float* o, float* lse, int bh, int t, int dh,
                          int block, int stride, float sm_scale, cudaStream_t stream) {
  const size_t smem = (size_t)TC_STAGES * 2 * block * bf16tc::row_stride(DHP)
                      * sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(sparse_fwd_tc<DHP, MT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  int threads;
  mma_launch_shape<MT>(bh, t, block, grid, threads);
  sparse_fwd_tc<DHP, MT><<<grid, threads, smem, stream>>>(q, k, v, o, lse, t, dh, block,
                                                          stride, sm_scale);
  return cudaGetLastError();
}

template <typename T, int DHP, int MT>
cudaError_t launch_dq_mma(const T* q, const T* k, const T* v,
                          const float* d_out, const float* lse, const float* delta,
                          T* dq, int bh, int t, int dh, int block, int stride,
                          float sm_scale, cudaStream_t stream) {
  const size_t smem = (4 * (size_t)block + (rows_in_smem(DHP) ? 2 * 64 * MT : 0))
                      * (DHP + MMA_PAD) * sizeof(float);
  cudaError_t err = allow_smem(sparse_dq_mma<T, DHP, MT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  int threads;
  mma_launch_shape<MT>(bh, t, block, grid, threads);
  sparse_dq_mma<T, DHP, MT><<<grid, threads, smem, stream>>>(
      q, k, v, d_out, lse, delta, dq, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

template <typename T, int DHP, int MT>
cudaError_t launch_dkv_mma(const T* q, const T* k, const T* v,
                           const float* d_out, const float* lse, const float* delta,
                           T* dk, T* dv, int bh, int t, int dh, int block,
                           int stride, float sm_scale, cudaStream_t stream) {
  const size_t smem = (2 * (2 * (size_t)block * (DHP + MMA_PAD) + 2 * (size_t)block)
                       + (rows_in_smem(DHP) ? 2 * 64 * MT * (DHP + MMA_PAD) : 0))
                      * sizeof(float);
  cudaError_t err = allow_smem(sparse_dkv_mma<T, DHP, MT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  int threads;
  mma_launch_shape<MT>(bh, t, block, grid, threads);
  sparse_dkv_mma<T, DHP, MT><<<grid, threads, smem, stream>>>(
      q, k, v, d_out, lse, delta, dk, dv, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_dq(const T* q, const T* k, const T* v,
                      const float* d_out, const float* lse, const float* delta,
                      T* dq, int bh, int t, int dh, int block, int stride,
                      float sm_scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)block * DHP * sizeof(float);
  cudaError_t err = allow_smem(sparse_dq<T, DHP>, smem);
  if (err != cudaSuccess) return err;
  sparse_dq<T, DHP><<<dim3(bh, t / block), block, smem, stream>>>(
      q, k, v, d_out, lse, delta, dq, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_dkv(const T* q, const T* k, const T* v,
                       const float* d_out, const float* lse, const float* delta,
                       T* dk, T* dv, int bh, int t, int dh, int block,
                       int stride, float sm_scale, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)block * DHP + 2 * (size_t)block) * sizeof(float);
  cudaError_t err = allow_smem(sparse_dkv<T, DHP>, smem);
  if (err != cudaSuccess) return err;
  sparse_dkv<T, DHP><<<dim3(bh, t / block), block, smem, stream>>>(
      q, k, v, d_out, lse, delta, dk, dv, t, dh, block, stride, sm_scale);
  return cudaGetLastError();
}

// the smallest padded head width that holds dh (the wrapper keeps dh <= 64)
#define FOR_HEAD_DIM(dh, LAUNCH)            \
  ((dh) <= 4 ? LAUNCH(4) : (dh) <= 8 ? LAUNCH(8) : (dh) <= 16 ? LAUNCH(16) \
   : (dh) <= 32 ? LAUNCH(32) : LAUNCH(64))

// the backward's tensor-core kernels: one row tile a warp, since a warp holds
// two operands' fragments (q and d_out, or k and v) and two accumulators for
// Dh 64; dh >= 8 there
#define FOR_MMA_HEAD_DIM(dh, LAUNCH) \
  ((dh) <= 8 ? LAUNCH(8, 1) : (dh) <= 16 ? LAUNCH(16, 1) \
   : (dh) <= 32 ? LAUNCH(32, 1) : LAUNCH(64, 1))

// whether sparse_fwd_tc takes the shape
bool tc_takes(uintptr_t bits, int t, int dh, int block) {
  return mma_takes(bits, t, dh, block) && dh % 8 == 0;
}

// The three launchers, each on q, k, v of element type T: the 3xTF32
// tensor-core kernel where it takes the shape (*variant 0), else the FMA
// kernel (1); the bf16 forward takes sparse_fwd_tc first, where it takes
// the shape (2).  forward_widened is the forward without it: the widening
// bf16 instance, a yardstick.
template <typename T>
cudaError_t forward_widened(const T* q, const T* k, const T* v, float* o, float* lse,
                            int bh, int t, int dh, int block, int stride, float sm_scale,
                            cudaStream_t stream, int* variant) {
  if (mma_takes(address_bits(q, k, v, o), t, dh, block)) {
    *variant = 0;
    // two row tiles a warp halve the splits and shared-memory reads per MMA;
    // one where the registers (Dh 64) or the rows (block 16) do not allow two
#define LAUNCH(DHP, MT) \
  launch_fwd_mma<T, DHP, MT>(q, k, v, o, lse, bh, t, dh, block, stride, sm_scale, stream)
    if (dh > 32) return LAUNCH(64, 1);
    if (block < 32) return dh <= 8 ? LAUNCH(8, 1) : dh <= 16 ? LAUNCH(16, 1) : LAUNCH(32, 1);
    return dh <= 8 ? LAUNCH(8, 2) : dh <= 16 ? LAUNCH(16, 2) : LAUNCH(32, 2);
#undef LAUNCH
  }
  *variant = 1;
#define LAUNCH(DHP) \
  launch_fwd<T, DHP>(q, k, v, o, lse, bh, t, dh, block, stride, sm_scale, stream)
  return FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

template <typename T>
cudaError_t forward(const T* q, const T* k, const T* v, float* o, float* lse, int bh,
                    int t, int dh, int block, int stride, float sm_scale,
                    cudaStream_t stream, int* variant) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tc_takes(address_bits(q, k, v, o), t, dh, block)) {
      *variant = 2;
      // row tiles a warp as sparse_fwd_mma takes them
#define LAUNCH(DHP, MT) \
  launch_fwd_tc<DHP, MT>(q, k, v, o, lse, bh, t, dh, block, stride, sm_scale, stream)
      if (dh > 32) return LAUNCH(64, 1);
      if (block < 32) return dh <= 16 ? LAUNCH(16, 1) : LAUNCH(32, 1);
      return dh <= 16 ? LAUNCH(16, 2) : LAUNCH(32, 2);
#undef LAUNCH
    }
  }
  return forward_widened(q, k, v, o, lse, bh, t, dh, block, stride, sm_scale, stream,
                         variant);
}

template <typename T>
cudaError_t dq_launch(const T* q, const T* k, const T* v, const float* d_out,
                      const float* lse, const float* delta, T* dq, int bh, int t, int dh,
                      int block, int stride, float sm_scale, cudaStream_t stream,
                      int* variant) {
  if (mma_takes(address_bits(q, k, v, d_out, lse, delta, dq), t, dh, block)) {
    *variant = 0;
#define LAUNCH(DHP, MT)                                                                \
  launch_dq_mma<T, DHP, MT>(q, k, v, d_out, lse, delta, dq, bh, t, dh, block, stride, \
                            sm_scale, stream)
    return FOR_MMA_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
  }
  *variant = 1;
#define LAUNCH(DHP) \
  launch_dq<T, DHP>(q, k, v, d_out, lse, delta, dq, bh, t, dh, block, stride, sm_scale, stream)
  return FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

template <typename T>
cudaError_t dkv_launch(const T* q, const T* k, const T* v, const float* d_out,
                       const float* lse, const float* delta, T* dk, T* dv, int bh, int t,
                       int dh, int block, int stride, float sm_scale, cudaStream_t stream,
                       int* variant) {
  if (mma_takes(address_bits(q, k, v, d_out, lse, delta, dk, dv), t, dh, block)) {
    *variant = 0;
#define LAUNCH(DHP, MT)                                                                   \
  launch_dkv_mma<T, DHP, MT>(q, k, v, d_out, lse, delta, dk, dv, bh, t, dh, block, stride, \
                             sm_scale, stream)
    return FOR_MMA_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
  }
  *variant = 1;
#define LAUNCH(DHP)                                                                  \
  launch_dkv<T, DHP>(q, k, v, d_out, lse, delta, dk, dv, bh, t, dh, block, stride,   \
                     sm_scale, stream)
  return FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// The fp32 FMA forward whatever the shape (same arguments as
// sparse_attention_forward): what the forward falls to, and a yardstick for
// the tensor-core kernel at the shapes that one takes.
int sparse_attention_forward_fma(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int bh, int t, int dh, int block,
                                 int stride, float sm_scale, void* stream) {
#define LAUNCH(DHP)                                                                 \
  launch_fwd<float, DHP>((const float*)q, (const float*)k, (const float*)v, (float*)o, \
                         (float*)lse, bh, t, dh, block, stride, sm_scale,           \
                         (cudaStream_t)stream)
  return (int)FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

// The fp32 FMA dq and dk/dv whatever the shape (the arguments of
// sparse_attention_dq / _dkv less `variant`): what those fall to, and
// yardsticks for the tensor-core kernels at the shapes those take.
int sparse_attention_dq_fma(const void* q, const void* k, const void* v,
                            const void* d_out, const void* lse, const void* delta,
                            void* dq, int bh, int t, int dh, int block, int stride,
                            float sm_scale, void* stream) {
#define LAUNCH(DHP)                                                                 \
  launch_dq<float, DHP>((const float*)q, (const float*)k, (const float*)v,          \
                        (const float*)d_out, (const float*)lse, (const float*)delta, \
                        (float*)dq, bh, t, dh, block, stride, sm_scale,             \
                        (cudaStream_t)stream)
  return (int)FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

int sparse_attention_dkv_fma(const void* q, const void* k, const void* v,
                             const void* d_out, const void* lse, const void* delta,
                             void* dk, void* dv, int bh, int t, int dh, int block,
                             int stride, float sm_scale, void* stream) {
#define LAUNCH(DHP)                                                                 \
  launch_dkv<float, DHP>((const float*)q, (const float*)k, (const float*)v,         \
                         (const float*)d_out, (const float*)lse, (const float*)delta, \
                         (float*)dk, (float*)dv, bh, t, dh, block, stride, sm_scale, \
                         (cudaStream_t)stream)
  return (int)FOR_HEAD_DIM(dh, LAUNCH);
#undef LAUNCH
}

// q, k, v, dq, dk, dv: (bh, t, dh) contiguous fp32 (sparse_attention_forward,
// _dq, _dkv) or bf16 (the _bf16 instances) on the device; o, d_out (bh, t,
// dh) and lse, delta (bh, t) contiguous fp32.  1 <= dh <= 64, 1 <= block <=
// 128, t % block == 0, t / block <= 65535, stride >= 1.  Each launches on
// `stream` and returns the cudaError_t of the launch.  Each picks its kernel
// by shape and writes which to *variant: 0 the tensor-core kernel
// (sparse_fwd_mma, sparse_dq_mma, sparse_dkv_mma), 1 the FMA kernel
// (sparse_fwd, sparse_dq, sparse_dkv), 2 the bf16 forward's sparse_fwd_tc.
#define EXPORT(SUFFIX, T)                                                                \
  int sparse_attention_forward##SUFFIX(const void* q, const void* k, const void* v,     \
                                       void* o, void* lse, int bh, int t, int dh,       \
                                       int block, int stride, float sm_scale,           \
                                       void* stream, int* variant) {                    \
    return (int)forward((const T*)q, (const T*)k, (const T*)v, (float*)o, (float*)lse, \
                        bh, t, dh, block, stride, sm_scale, (cudaStream_t)stream,       \
                        variant);                                                       \
  }                                                                                     \
  int sparse_attention_dq##SUFFIX(const void* q, const void* k, const void* v,          \
                                  const void* d_out, const void* lse, const void* delta, \
                                  void* dq, int bh, int t, int dh, int block,           \
                                  int stride, float sm_scale, void* stream,             \
                                  int* variant) {                                       \
    return (int)dq_launch((const T*)q, (const T*)k, (const T*)v, (const float*)d_out,  \
                          (const float*)lse, (const float*)delta, (T*)dq, bh, t, dh,   \
                          block, stride, sm_scale, (cudaStream_t)stream, variant);     \
  }                                                                                     \
  int sparse_attention_dkv##SUFFIX(const void* q, const void* k, const void* v,         \
                                   const void* d_out, const void* lse,                  \
                                   const void* delta, void* dk, void* dv, int bh,       \
                                   int t, int dh, int block, int stride,                \
                                   float sm_scale, void* stream, int* variant) {        \
    return (int)dkv_launch((const T*)q, (const T*)k, (const T*)v, (const float*)d_out, \
                           (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, bh, \
                           t, dh, block, stride, sm_scale, (cudaStream_t)stream,       \
                           variant);                                                    \
  }

EXPORT(, float)
EXPORT(_bf16, bf16)
#undef EXPORT

// The bf16 forward that widens (the 3xTF32 or FMA kernel on widened
// inputs) whatever the shape: a yardstick for sparse_fwd_tc, which the
// port's wrapper never calls (the arguments of sparse_attention_forward_bf16
// less `variant`).
int sparse_attention_forward_bf16_widened(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int bh, int t, int dh,
                                          int block, int stride, float sm_scale,
                                          void* stream) {
  int variant;
  return (int)forward_widened((const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)o,
                              (float*)lse, bh, t, dh, block, stride, sm_scale,
                              (cudaStream_t)stream, &variant);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

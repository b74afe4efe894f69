// bf16 tensor-core building blocks shared by the bf16 attention forwards of
// attention.cu (masked_attention_tc) and sparse_attention.cu
// (sparse_fwd_tc), for Hopper (sm_90a).
//
// Both kernels compute an fp32 softmax(s) v from bf16 q, k, v, as the Pallas
// kernels do once they have widened their bf16 inputs (a bf16 x bf16
// product is exact in fp32):
//   * K and V tiles are staged in bf16 by 16-byte cp.async (8 elements), in
//     a ring of stages so that the next tile loads under the current one's
//     math; a staged row is padded to an odd number of 16-byte units, so
//     the eight rows an ldmatrix phase reads fall on eight different bank
//     groups;
//   * S = Q K^T runs on mma.sync m16n8k16 bf16 -> fp32 with q and k as they
//     are: one MMA per 16 of depth, Q's A fragments in registers, K's B
//     fragments by ldmatrix; sm_scale * log2(e) is applied to the fp32 S;
//   * P V splits the fp32 P into two bf16 planes, p = hi + lo with hi =
//     bf16(p) and lo = bf16(p - hi) (about 16 significant bits of p), and
//     takes one MMA of each against V's bf16 fragment (ldmatrix .trans);
//     the hi and lo products of a 32-key step accumulate apart from zero
//     (chains of 2 MMAs: the tensor core truncates where it accumulates)
//     and are added in fp32 with rounding into the running output;
//   * the online softmax is the fp32 tensor-core kernels': base-2 logits,
//     one ex2 per score, row max over the quad by shuffles, the row sum
//     reduced once at the end.  No atomics: reruns are bit-identical.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row) a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
// a3 = A[g+8][2t+8, 2t+9]; B (16 x 8, col) b0 = B[2t, 2t+1][g], b1 =
// B[2t+8, 2t+9][g]; C (16 x 8) c0, c1 = C[g][2t, 2t+1], c2, c3 =
// C[g+8][2t, 2t+1].  So the C fragments of S's n-tiles 2j and 2j+1 are,
// once rounded, the A fragment of P for keys 16j .. 16j+15: no shuffle.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace bf16tc {

using bf16 = __nv_bfloat16;

constexpr int KEYS = 32;          // keys per online-softmax step
constexpr int NT = KEYS / 8;      // n-tiles of S in a step
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f; // the additive mask of the Pallas kernels
constexpr unsigned FULL = 0xffffffffu;

// elements of a staged row of DHP values: an odd number of 16-byte units
__host__ __device__ constexpr int row_stride(int dhp) { return ((dhp / 8) | 1) * 8; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one instruction; 0 for -inf and for the -1e30 of a masked score
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) = hi + lo in two bf16 planes: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// total_rows x DHP bf16 at dst (rows of row_stride(DHP)) from the rows of
// dh elements at src: rows < valid_rows and units < dh / 8 by cp.async, the
// rest zeros.  dh % 8 == 0 and src 16-byte aligned; all threads take part.
template <int DHP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           int valid_rows, int total_rows, int dh) {
  constexpr int UNITS = DHP / 8, LDS = row_stride(DHP);
  for (int idx = threadIdx.x; idx < total_rows * UNITS; idx += blockDim.x) {
    const int r = idx / UNITS, c = idx - r * UNITS;
    bf16* d = dst + r * LDS + c * 8;
    if (r < valid_rows && c * 8 < dh) cp_async16(d, src + (size_t)r * dh + c * 8);
    else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Q's A fragments for MT row tiles of 16 rows from row 0 at q (rows of dh
// elements); rows >= valid_rows and columns >= dh are zeros
template <int DHP, int MT>
__device__ __forceinline__ void load_q(uint32_t (&a)[DHP / 16][MT][4],
                                       const bf16* __restrict__ q, int valid_rows, int dh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + g + (e & 1) * 8, col = ks * 16 + 2 * t + (e >> 1) * 8;
        a[ks][mt][e] = row < valid_rows && col < dh
            ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * dh + col) : 0u;
      }
}

// One online-softmax step over KEYS staged keys from row key0 of the tiles
// ks (K) and vs (V), rows past last_row read last_row again (their scores
// must be masked to -inf by `mask`).  mask(s, mt, nt, e) turns the fp32 dot
// product of C element e of n-tile nt of row tile mt into a base-2 logit.
template <int DHP, int MT, typename Mask>
__device__ __forceinline__ void step(const uint32_t (&qf)[DHP / 16][MT][4],
                                     const bf16* ks, const bf16* vs, int key0, int last_row,
                                     Mask mask, float (&m)[MT][2], float (&l)[MT][2],
                                     float (&acc)[MT][DHP / 8][4]) {
  constexpr int LDS = row_stride(DHP), KS = DHP / 16, DT = DHP / 8;
  const int lane = threadIdx.x & 31;
  float s[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
  // S = Q K^T: ldmatrix x4 gives b0, b1 of two n-tiles; lanes 16-31 address
  // the second, lanes 8-15 and 24-31 the upper 8 of the 16 columns
#pragma unroll
  for (int ks_ = 0; ks_ < KS; ++ks_)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int row = min(key0 + (2 * np + (lane >> 4)) * 8 + (lane & 7), last_row);
      uint32_t b[4];
      ldsm_x4(b, ks + row * LDS + ks_ * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(s[mt][2 * np], qf[ks_][mt], b[0], b[1]);
        mma(s[mt][2 * np + 1], qf[ks_][mt], b[2], b[3]);
      }
    }
  float alpha[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows g and g + 8
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[mt][nt][e] = mask(s[mt][nt][e], mt, nt, e);
          mx = fmaxf(mx, s[mt][nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
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
  // P V, P in two bf16 planes: k-step j takes S's n-tiles 2j and 2j + 1 as
  // its A fragment; ldmatrix x4 .trans gives b0, b1 of two d n-tiles (lanes
  // 8-15 and 24-31 address keys 8-15, lanes 16-31 the second n-tile)
  float hi[MT][DT][4], lo[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[mt][dt][e] = lo[mt][dt][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split(s[mt][2 * j][0], s[mt][2 * j][1], ph[mt][0], pl[mt][0]);
      split(s[mt][2 * j][2], s[mt][2 * j][3], ph[mt][1], pl[mt][1]);
      split(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1], ph[mt][2], pl[mt][2]);
      split(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3], ph[mt][3], pl[mt][3]);
    }
    const int row = min(key0 + 16 * j + ((lane >> 3) & 1) * 8 + (lane & 7), last_row);
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + row * LDS + (2 * dp + (lane >> 4)) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(hi[mt][2 * dp], ph[mt], b[0], b[1]);
        mma(hi[mt][2 * dp + 1], ph[mt], b[2], b[3]);
        mma(lo[mt][2 * dp], pl[mt], b[0], b[1]);
        mma(lo[mt][2 * dp + 1], pl[mt], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][dt][e] = fmaf(acc[mt][dt][e], alpha[mt][e >> 1], hi[mt][dt][e] + lo[mt][dt][e]);
}

// each row's sum over its quad (rows g and g + 8 of each row tile)
template <int MT>
__device__ __forceinline__ void row_sums(float (&l)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(FULL, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(FULL, l[mt][h], 2);
    }
}

}  // namespace bf16tc

// Masked attention forward for Hopper (sm_90a): fp32 or bf16 q, k, v, fp32
// out.
//
// Replaces the Pallas TPU kernel masked_flash_attention -> _flash_pallas
// (body _attn_kernel) in multimodal_vae_comparison_tpu/ops/pallas/attention.py:
//   out = softmax(q k^T / sqrt(Dh) + bias) v,  bias = 0 or -1e30 per key.
//
// What bounds it on the card: at the models' shapes a head is a few KB, the
// whole call a few to a few hundred MB and at most a few GFLOP.  Small calls
// wait for latency (the launch, the first loads from device memory, every
// dependent step after them); the large ones (SPRITES' axial heads, CUB's
// and VILANRO's decoders over many latents) for device memory.  So every
// route cuts dependent steps and repeated traffic; only the bf16 route with
// a long side uses the tensor cores.
//
// Four routes, picked by shape in forward() and masked_attention_forward_bf16:
//
//   fp32 q, k, v                    bf16 q, k, v
//   ------------                    ------------
//                                   1. tc_bf16    Tq or Tk >= 16 (tc_takes)
//                                   2. short_bf16 Tq, Tk < 16, Dh % 8 == 0,
//                                                 Dh <= 64 (short_takes)
//   3. few_keys  Tk <= 8 and Tq > Tk (few_keys_takes), both types
//   4. resident  the head's K and V fit shared memory (Tk <= 256), both types
//      chunked   every other head, both types
//
// Crossovers (set by H100 A/Bs: kernel_variants.py few_keys and short_bf16,
// chip_smoke.py's "bf16 steps"): the tensor-core kernel from a side of 16,
// where most of its 16-row, 32-key step is filled; the few-keys kernel where
// a head has more query rows than keys and at most 8 keys (the cross-
// attention of the decoders over 1 latent or 5 conditioning tokens).  Heads
// with Tq <= Tk, SPRITES' fp32 8 x 8 axial heads among them, stay on the
// resident kernel, though the few-keys kernel (its yardstick,
// masked_attention_forward_few_keys) ran those 8 x 8 heads faster: moving
// the crossover there is a change of route of its own, with the SPRITES
// paths' checks.  The resident kernel is also
// exported alone (masked_attention_forward_resident, and
// masked_attention_forward_bf16_widened on bf16) as the yardstick the two
// new routes were measured against; the port's wrapper never calls it.
//
// Few-keys path (masked_attention_few_keys; Tk <= FEW_MAX_KEYS).  Where a
// lane scores keys j, j + 32, ... (the resident path), at one key 31 of 32
// lanes score nothing and each group of 4 query rows still pays two 5-level
// shuffle reductions, a write of its probabilities to shared memory and a p v
// loop in which only lanes d < Dh work.  Here a query row maps to Dh / 4
// lanes (2 to 32), each holding 4 dims, so a warp loads q and stores out 512
// consecutive bytes at a time; a row's partial scores join in 1-5 shuffle
// levels, the Tk scores then live in registers (max and sum need no
// shuffle), and out is stored as float4.  K and V (Tk rows a head) and the
// mask are read through L1 and L2, where the other rows of the head find
// them: no staging, no barrier.  What bounds it is device memory: q and out
// stream through once, so q is loaded evict-first (ld.global.cs) to keep K
// and V in L2; a step issues all its K loads before the scores' shuffles and
// all its V loads before the products, since a load waiting behind each
// key's shuffles cost a memory latency a key; an instance per key count
// keeps those loads in registers without spilling; and a persistent grid
// (one wave: as many blocks of 256 threads as fit an SM) gives each warp a
// run of consecutive rows, so that its later steps find the head's K and V
// in L1 and the call pays the launch of at most a wave of blocks; a step
// loads the next one's q before it computes.  Every score is still
// computed from q, so the function (NaN in, NaN out) is the resident
// kernel's; at Tk = 1 a visible key gives exactly v.
//
// Short bf16 path (masked_attention_short_bf16; SPRITES' 8 x 8 T-axis heads
// in bf16).  Widened into the resident kernel, a 1.5 KB head took a block of
// 64 threads, synchronous 8-byte loads widened into float4s, a bias fill and
// a block barrier before its first score: bf16's half of the bytes bought no
// time.  Here a warp owns a head (8 heads a block) and copies its Q, K and V
// as they are with 16-byte cp.async into its own shared memory (K rows
// padded by 16 bytes so the lanes' reads of 8 keys do not share banks),
// waited for by the warp alone; lane (r, j) scores query row r against key j
// (8 lanes a row for Tk <= 8, 16 up to 15), widening on the read, so a row's
// softmax is 3 or 4 shuffle levels; each lane then owns 4 output dims and
// stores them as a float4.  No tensor cores: at 8 x 8 the work is a few
// hundred products a row.
//
// Resident path.  One thread block owns a whole head, or a run of its query
// rows where there are too few heads to fill the card.  Q, K, V and the mask
// bias of the head go to shared memory once, as 16-byte cp.async copies, in
// buffers sized by the call's Dh and Tk.  With the whole key axis resident
// there is no online softmax and one barrier: a warp takes ROWS query rows
// at a time (independent work that hides latency, and every K and V value
// read from shared memory feeds ROWS rows); lane j scores keys j, j + 32,
// ... (KPL of them, a template parameter, scores in registers, as base-2
// logits so that the exponential is one ex2); one max and one sum reduction
// per row; the probabilities go through a per-warp buffer and lane d
// accumulates output dims d, d + 32, ... (SLOTS of them, a template
// parameter: 1 up to Dh 32).  K rows are padded to an odd number of 16-byte
// units so that the lanes' float4 reads of 32 different rows do not collide
// on banks.
//
// Chunked path (Tk > 256, or a head whose K and V do not fit the shared
// memory budget): one block per (head, 8 query rows), a warp per row, K and
// V staged 32 keys at a time with an online softmax over the chunks.
//
// Masking is additive with -1e30 exactly as the TPU kernel does it; masked
// keys are never skipped (but for whole tiles, below), so a row with every
// key masked gives the uniform average of V on every route, as the Pallas
// kernel and the XLA path both give.
//
// Input dtype.  The resident, chunked and few-keys kernels are templates on
// the element type T of q, k and v, instantiated for float and
// __nv_bfloat16.  bf16 is widened to fp32 on its way into registers (exact),
// so the arithmetic after it is the fp32 kernel's and the output is fp32, as
// the Pallas kernel widens its bf16 inputs.  The resident path's vector
// staging moves 4 elements a thread: a 16-byte cp.async for fp32, an 8-byte
// load widened into a float4 for bf16 (synchronous).  Its rule (Dh % 4 == 0
// and 16-byte aligned inputs) keeps every bf16 unit 8-byte aligned, so it
// holds for both types.  The few-keys kernel loads 4 elements a lane at a
// time (16 bytes of fp32, 8 of bf16) where Dh % 4 == 0 and the inputs are
// 16-byte aligned, else element by element.
//
// bf16 tensor-core path (masked_attention_tc, where tc_takes the shape: Tq
// or Tk >= TC_MIN_SIDE, Dh % 8 == 0, Dh <= 64, Tk <= TC_MAX_KEYS, 16-byte
// aligned inputs).  Long padded key axes (CUB's captions: 246 keys, 77 %
// padding) made the resident path slower than SDPA: it scores and sums every
// key, masked or not, with FMAs.  Here a warp owns 16 query rows (a block 4
// warps, 64 rows) and walks the key axis 32 keys a step on bf16 MMAs
// (bf16_tc.cuh): S = Q K^T with q and k as they are, P split into two bf16
// planes for P V, K and V tiles staged in bf16 by cp.async in a three-stage
// ring, which keeps two tiles' loads in flight.  Key tiles whose 32 keys are
// all masked are skipped, where the batch element has a visible key: a
// masked score is s - 1e30, so once a row's max comes from a visible key ex2
// of it is exactly 0 (and a tile before the first visible one is scaled by
// ex2(-1e30 - max) = 0 and forgotten), so the skip changes no bit.  A batch
// element whose keys are all masked skips nothing and gets the uniform
// average of V, as above.  The skip is decided per block from the (B, Tk)
// mask: a warp's ballot per tile, then a list of the live tiles compacted by
// one warp, which the ring walks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_tc.cuh"

namespace {

constexpr int WARP = 32;
constexpr int MAX_DH = 128;
constexpr int DH_SLOTS = MAX_DH / WARP;   // output dims a lane may own
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// resident path
constexpr int ROWS = 4;            // query rows a warp works on at once
constexpr int MAX_WARPS = 16;
constexpr int MAX_KPL = 8;         // keys per lane: Tk <= 256
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr int SM_COUNT = 132;
constexpr int MIN_SPLIT_ROWS = 16; // a head is split no finer than this

// chunked path
constexpr int CHUNK_ROWS = 8;      // query rows (= warps) per block
constexpr int KV_CHUNK = 32;       // keys per shared-memory chunk, one per lane

// bf16 tensor-core path
constexpr int TC_WARPS = 4;        // warps per block, 16 query rows each
constexpr int TC_ROWS = 16 * TC_WARPS;
constexpr int TC_STAGES = 3;       // K and V tiles in flight
constexpr int TC_MIN_SIDE = 16;    // Tq and Tk both shorter: the short bf16 path
constexpr int TC_MAX_KEYS = 8192;  // the bias and tile list fit shared memory

// few-keys path
constexpr int FEW_MAX_KEYS = 8;    // the scores of a row live in registers
constexpr int FEW_THREADS = 256;   // threads per block

// short bf16 path
constexpr int SHORT_WARPS = 8;     // heads per block, one per warp
constexpr int SHORT_MAX_DH = 64;   // a lane owns at most 2 groups of 4 dims
constexpr int SHORT_PAD = 8;       // bf16 elements padding each K row in smem

enum Variant { RESIDENT = 0, CHUNKED = 1, TC_BF16 = 2, FEW_KEYS = 3, SHORT_BF16 = 4 };

__device__ __forceinline__ float warp_max(float x) {
  for (int o = WARP / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = WARP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// 4 consecutive elements at g -> 4 floats at s (16-byte aligned): an async
// copy for fp32; for bf16 an 8-byte load, widened
__device__ __forceinline__ void stage4(float* s, const float* g) { cp_async16(s, g); }
__device__ __forceinline__ void stage4(float* s, const __nv_bfloat16* g) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  *reinterpret_cast<float4*>(s) = make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float component(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Shared-memory plan of the resident path, in floats; every offset is a
// multiple of 4 so that each buffer is 16-byte aligned.
struct ResidentPlan {
  int dh4;      // Dh rounded up to 4: row length of V and Q
  int kstride;  // row stride of K: an odd number of 16-byte units
  int tk4;      // Tk rounded up to 4: rows of V (the tail rows are zero)
  int tkp;      // KPL * 32: length of a row of probabilities
  __host__ __device__ ResidentPlan(int tk, int dh, int kpl)
      : dh4((dh + 3) & ~3), kstride(4 * ((((dh + 3) >> 2)) | 1)),
        tk4((tk + 3) & ~3), tkp(kpl * WARP) {}
  __host__ __device__ size_t floats(int tk, int rows_per_block, int nwarps) const {
    return (size_t)tk * kstride + (size_t)tk4 * dh4 + (size_t)rows_per_block * dh4
           + tkp + (size_t)nwarps * ROWS * tkp;
  }
};

// grid (batch*heads, row splits), up to MAX_WARPS warps; dynamic shared
// memory of ResidentPlan::floats floats.  rows_per_block is a multiple of
// ROWS.  vec: Dh % 4 == 0 and q, k, v are 16-byte aligned.  Dh <= 32 * SLOTS.
template <typename T, int KPL, int SLOTS>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
masked_attention_resident(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ key_mask,  // (B, Tk) or null
                          float* __restrict__ out, int heads, int tq, int tk,
                          int dh, int rows_per_block, float sm_scale, int vec) {
  extern __shared__ float4 smem4[];
  const ResidentPlan plan(tk, dh, KPL);
  const int dh4 = plan.dh4, kstride = plan.kstride, tk4 = plan.tk4, tkp = plan.tkp;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + (size_t)tk * kstride;
  float* qs = vs + (size_t)tk4 * dh4;
  float* bias = qs + (size_t)rows_per_block * dh4;
  float* ps = bias + tkp;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int row_begin = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, tq - row_begin);
  const T* kh = k + (size_t)bh * tk * dh;
  const T* vh = v + (size_t)bh * tk * dh;
  const T* qh = q + ((size_t)bh * tq + row_begin) * dh;

  // stage the head: thread (tr, tc) copies 16-byte unit tc of rows tr,
  // tr + rstep, ...; one division per thread, none per element
  if (vec) {
    const int cpr = dh >> 2;   // 16-byte units per row
    const int tr = threadIdx.x / cpr, tc = 4 * (threadIdx.x - tr * cpr);
    const int rstep = blockDim.x / cpr;
    if (tr < rstep) {
      for (int r = tr; r < tk; r += rstep) {
        stage4(ks + r * kstride + tc, kh + (size_t)r * dh + tc);
        stage4(vs + r * dh4 + tc, vh + (size_t)r * dh + tc);
      }
      for (int r = tr; r < rows; r += rstep)
        stage4(qs + r * dh4 + tc, qh + (size_t)r * dh + tc);
    }
  } else {
    // Dh not a multiple of 4, or unaligned inputs: a warp copies a row, by
    // elements; columns dh .. dh4 - 1 are zero padding
    const int w = threadIdx.x / WARP, nw = blockDim.x / WARP;
    for (int c = threadIdx.x % WARP; c < dh4; c += WARP) {
      const bool real = c < dh;
      for (int r = w; r < tk; r += nw) {
        ks[r * kstride + c] = real ? to_f(kh[(size_t)r * dh + c]) : 0.f;
        vs[r * dh4 + c] = real ? to_f(vh[(size_t)r * dh + c]) : 0.f;
      }
      for (int r = w; r < rows; r += nw)
        qs[r * dh4 + c] = real ? to_f(qh[(size_t)r * dh + c]) : 0.f;
    }
  }
  for (int idx = threadIdx.x; idx < (tk4 - tk) * dh4; idx += blockDim.x)
    vs[tk * dh4 + idx] = 0.f;   // rows Tk .. tk4 - 1: p is 0 there, v must be finite
  for (int j = threadIdx.x; j < tkp; j += blockDim.x)
    bias[j] = j >= tk ? -INFINITY
              : (key_mask == nullptr || key_mask[(size_t)b * tk + j]) ? 0.f : NEG_INF;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int nwarps = blockDim.x / WARP;
  float* pw = ps + (size_t)warp * ROWS * tkp;
  int key_row[KPL];   // this lane's K rows; past Tk it rereads the last one
#pragma unroll
  for (int c = 0; c < KPL; ++c) key_row[c] = min(lane + c * WARP, tk - 1) * kstride;

  for (int r0 = warp * ROWS; r0 < rows; r0 += nwarps * ROWS) {
    // scores: ROWS x KPL per lane, every K value feeding ROWS rows
    const float* qrow[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) qrow[r] = qs + min(r0 + r, rows - 1) * dh4;
    float s[ROWS][KPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[r][c] = 0.f;
    for (int d = 0; d < dh4; d += 4) {
      float4 qv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) qv[r] = *reinterpret_cast<const float4*>(qrow[r] + d);
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + key_row[c] + d);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r][c] += dot4(qv[r], kv);
      }
    }
    // softmax over the whole key axis: one max and one sum per row
    float inv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        s[r][c] = s[r][c] * (sm_scale * LOG2E) + bias[lane + c * WARP];
        mx = fmaxf(mx, s[r][c]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float p = exp2f(s[r][c] - mx);   // 0 for the keys past Tk
        pw[r * tkp + lane + c * WARP] = p;
        sum += p;
      }
      inv[r] = 1.f / warp_sum(sum);
    }
    __syncwarp();
    // p v: lane d owns output dims d, d + 32, ...
    float acc[ROWS][SLOTS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) acc[r][i] = 0.f;
    for (int j = 0; j < tk4; j += 4) {
      float4 pv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        pv[r] = *reinterpret_cast<const float4*>(pw + r * tkp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          const int d = lane + i * WARP;
          if (d < dh) {
            const float vv = vs[(j + jj) * dh4 + d];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r][i] += component(pv[r], jj) * vv;
          }
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float* orow = out + ((size_t)bh * tq + row_begin + r0 + r) * dh;
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int d = lane + i * WARP;
        if (r0 + r < rows && d < dh) orow[d] = acc[r][i] * inv[r];
      }
    }
    __syncwarp();   // pw is rewritten by the next rows
  }
}

// grid (batch*heads, ceil(Tq / CHUNK_ROWS)), CHUNK_ROWS warps; dynamic shared
// memory: K chunk [32][Dh + 1] (+1: lanes read rows, no bank conflicts),
// V chunk [32][Dh], Q [CHUNK_ROWS][Dh], bias [32]
template <typename T>
__global__ void __launch_bounds__(CHUNK_ROWS * WARP)
masked_attention_chunked(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ key_mask,  // (B, Tk) or null
                         float* __restrict__ out, int heads, int tq, int tk,
                         int dh, float sm_scale) {
  extern __shared__ float4 smem4[];
  const int kstride = dh + 1;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + KV_CHUNK * kstride;
  float* qs = vs + KV_CHUNK * dh;
  float* bias = qs + CHUNK_ROWS * dh;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int row = blockIdx.y * CHUNK_ROWS + warp;
  const bool active = row < tq;
  // staging: thread (tr, tc) copies column tc of rows tr, tr + rstep, ...
  const int tr = threadIdx.x / dh, tc = threadIdx.x - tr * dh;
  const int rstep = blockDim.x / dh;

  const T* qrow = q + ((size_t)bh * tq + row) * dh;
  for (int d = lane; d < dh; d += WARP)
    qs[warp * dh + d] = active ? to_f(qrow[d]) * sm_scale : 0.f;

  const T* kh = k + (size_t)bh * tk * dh;
  const T* vh = v + (size_t)bh * tk * dh;
  float acc[DH_SLOTS];
#pragma unroll
  for (int i = 0; i < DH_SLOTS; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < tk; k0 += KV_CHUNK) {
    const int n = min(KV_CHUNK, tk - k0);
    __syncthreads();  // the previous chunk is consumed (and qs is written)
    if (tr < rstep)
      for (int j = tr; j < n; j += rstep) {
        ks[j * kstride + tc] = to_f(kh[(size_t)(k0 + j) * dh + tc]);
        vs[j * dh + tc] = to_f(vh[(size_t)(k0 + j) * dh + tc]);
      }
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      bias[j] = (key_mask == nullptr || key_mask[(size_t)b * tk + k0 + j]) ? 0.f : NEG_INF;
    __syncthreads();
    if (!active) continue;

    float s = -INFINITY;  // lanes past the chunk take no part
    if (lane < n) {
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot += qs[warp * dh + d] * ks[lane * kstride + d];
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
        if (d < dh) acc[i] += pj * vs[j * dh + d];
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

__device__ __forceinline__ void widen8(float* x, const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float4 widen4(const uint2& raw) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 4 consecutive elements at p as fp32, the first n of them (n may be <= 0
// or > 4), the rest 0.  vec: n >= 4 or n <= 0, and p is 16-byte aligned
// (fp32) or 8-byte aligned (bf16).
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec) return n > 0 ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                     n > 3 ? p[3] : 0.f);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int n, bool vec) {
  if (vec) return n > 0 ? widen4(*reinterpret_cast<const uint2*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(n > 0 ? __bfloat162float(p[0]) : 0.f, n > 1 ? __bfloat162float(p[1]) : 0.f,
                     n > 2 ? __bfloat162float(p[2]) : 0.f, n > 3 ? __bfloat162float(p[3]) : 0.f);
}

// load4 of a row that is read once here (q): the loads are marked
// evict-first (ld.global.cs), so that the streaming rows do not push the K
// and V that every row of a head reads out of L2
__device__ __forceinline__ float4 load4_once(const float* p, int n, bool vec) {
  if (vec) return n > 0 ? __ldcs(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  return load4(p, n, false);
}

__device__ __forceinline__ float4 load4_once(const __nv_bfloat16* p, int n, bool vec) {
  if (vec) return n > 0 ? widen4(__ldcs(reinterpret_cast<const uint2*>(p)))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  return load4(p, n, false);
}

// A persistent grid of blocks of FEW_THREADS threads; no shared memory; an
// instance per key count TK (1 .. FEW_MAX_KEYS).  Query row R of the
// flattened (B*H*Tq) rows belongs to LPR consecutive lanes, lane c of them
// owning dims 4c .. 4c + 3 (LPR * 4 >= Dh), so that a warp's loads of q and
// stores of out cover 32 * 16 consecutive bytes; a warp takes WARP / LPR
// rows (a group) a step, through a run of consecutive groups, loading the
// next step's q before it computes this one's.  The TK rows of K and V of
// a head and its mask are read through L1 and L2, where the head's other
// rows find them: every K load of a step is issued before the first score's
// shuffles, every V load before the first product.  rows_total < 2^31.  vec: 16-byte
// aligned q, k, v and Dh % 4 == 0 (4-element loads).
template <typename T, int LPR, int TK>
__global__ void __launch_bounds__(FEW_THREADS)
masked_attention_few_keys(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ key_mask,  // (B, TK) or null
                          float* __restrict__ out, int rows_total, int heads, int tq, int dh,
                          float sm_scale, int vec) {
  constexpr int RPW = WARP / LPR;   // rows a warp takes a step
  const int c = 4 * (threadIdx.x % LPR);   // the lane's first dim
  const int n = dh - c;                    // its dims: min(n, 4)
  const long long warps = (long long)gridDim.x * (FEW_THREADS / WARP);
  const long long warp = (long long)blockIdx.x * (FEW_THREADS / WARP) + threadIdx.x / WARP;
  const int sub = (threadIdx.x % WARP) / LPR;
  const float scale2 = sm_scale * LOG2E;
  // the warp's run of row groups, uniform across it, so every lane runs
  // every step (the shuffles need all 32); consecutive groups mostly share
  // a head, whose K and V the warp then finds in L1
  const long long groups = ((long long)rows_total + RPW - 1) / RPW;
  const long long g_end = groups * (warp + 1) / warps;
  long long g = groups * warp / warps;
  auto row_of = [&](long long group) {   // rows past the end redo the last one
    const long long mine = group * RPW + sub;
    return (int)(mine < rows_total ? mine : rows_total - 1);
  };
  float4 qv = load4_once(q + (size_t)row_of(g) * dh + c, g < g_end ? n : 0, vec);
  for (; g < g_end; ++g) {
    const int row = row_of(g);
    const int bh = row / tq, b = bh / heads;
    const size_t kv0 = (size_t)bh * TK * dh + c;
    float4 kr[TK];
#pragma unroll
    for (int j = 0; j < TK; ++j) kr[j] = load4(k + kv0 + (size_t)j * dh, n, vec);
    const float4 qn = load4_once(q + (size_t)row_of(g + 1) * dh + c, g + 1 < g_end ? n : 0,
                                 vec);
    float s[TK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      float dot = dot4(qv, kr[j]);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      const bool seen = key_mask == nullptr || key_mask[(size_t)b * TK + j];
      s[j] = dot * scale2 + (seen ? 0.f : NEG_INF);
      mx = fmaxf(mx, s[j]);
    }
    float4 vr[TK];
#pragma unroll
    for (int j = 0; j < TK; ++j) vr[j] = load4(v + kv0 + (size_t)j * dh, n, vec);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      s[j] = exp2f(s[j] - mx);
      sum += s[j];
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      acc.x += s[j] * vr[j].x;
      acc.y += s[j] * vr[j].y;
      acc.z += s[j] * vr[j].z;
      acc.w += s[j] * vr[j].w;
    }
    if (g * RPW + sub < rows_total && n > 0) {
      const float inv = 1.f / sum;
      float* orow = out + (size_t)row * dh + c;
      const float4 o = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
      if (dh % 4 == 0) {   // row * dh + c is a multiple of 4
        *reinterpret_cast<float4*>(orow) = o;
      } else {
        orow[0] = o.x;
        if (n > 1) orow[1] = o.y;
        if (n > 2) orow[2] = o.z;
        if (n > 3) orow[3] = o.w;
      }
    }
    qv = qn;
  }
}

// Bytes of shared memory one warp of the short bf16 kernel takes: Q, K (rows
// padded by SHORT_PAD) and V of its head, in bf16.
__host__ __device__ __forceinline__ int short_warp_bytes(int tq, int tk, int dh) {
  return 2 * (tq * dh + tk * (dh + SHORT_PAD) + tk * dh);
}

// grid ceil(B*H / SHORT_WARPS), SHORT_WARPS warps, a warp per head; dynamic
// shared memory SHORT_WARPS * short_warp_bytes.  KL lanes per query row
// (8: Tk <= 8; 16: Tk <= 15), lane (r, j) on key j of row r.  Tq, Tk < 16,
// Dh % 8 == 0, Dh <= SHORT_MAX_DH, q, k, v 16-byte aligned.
template <int KL>
__global__ void __launch_bounds__(SHORT_WARPS * WARP)
masked_attention_short_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const uint8_t* __restrict__ key_mask,  // (B, Tk) or null
                            float* __restrict__ out, int bh_total, int heads, int tq, int tk,
                            int dh, float sm_scale) {
  extern __shared__ uint4 smem_short[];
  constexpr int RPP = WARP / KL;   // query rows a pass
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long bh = (long long)blockIdx.x * SHORT_WARPS + warp;
  if (bh >= bh_total) return;      // the warp waits on nothing but itself
  const int kstride = dh + SHORT_PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(smem_short) + warp * short_warp_bytes(tq, tk, dh));
  __nv_bfloat16* ks = qs + tq * dh;
  __nv_bfloat16* vs = ks + tk * kstride;

  // the head's Q, K and V as they are, 16 bytes a copy
  const int upr = dh / 8;   // 16-byte units a row
  const __nv_bfloat16* qg = q + bh * tq * dh;
  const __nv_bfloat16* kg = k + bh * tk * dh;
  const __nv_bfloat16* vg = v + bh * tk * dh;
  for (int u = lane; u < tq * upr; u += WARP)
    cp_async16(reinterpret_cast<float*>(qs + 8 * u), reinterpret_cast<const float*>(qg + 8 * u));
  for (int u = lane; u < tk * upr; u += WARP) {
    const int r = u / upr, c = 8 * (u - r * upr);
    cp_async16(reinterpret_cast<float*>(ks + r * kstride + c),
               reinterpret_cast<const float*>(kg + 8 * u));
    cp_async16(reinterpret_cast<float*>(vs + 8 * u), reinterpret_cast<const float*>(vg + 8 * u));
  }
  // meanwhile this lane's key and its bias (-inf past Tk: p = 0 there)
  const int j = lane % KL, sub = lane / KL;
  const int b = (int)(bh / heads);
  const float bias = j >= tk ? -INFINITY
                     : (key_mask == nullptr || key_mask[(size_t)b * tk + j]) ? 0.f : NEG_INF;
  const __nv_bfloat16* krow = ks + min(j, tk - 1) * kstride;
  const float scale2 = sm_scale * LOG2E;
  const int groups = dh / 4;   // 4 output dims each
  cp_async_wait_all();
  __syncwarp();

  for (int p0 = 0; p0 < tq; p0 += RPP) {
    const int r = min(p0 + sub, tq - 1);
    const __nv_bfloat16* qrow = qs + r * dh;
    float dot = 0.f;
    for (int d = 0; d < dh; d += 8) {
      float a[8], c[8];
      widen8(a, *reinterpret_cast<const uint4*>(qrow + d));
      widen8(c, *reinterpret_cast<const uint4*>(krow + d));
#pragma unroll
      for (int e = 0; e < 8; ++e) dot += a[e] * c[e];
    }
    const float sc = dot * scale2 + bias;
    float mx = sc;
#pragma unroll
    for (int o = KL / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float p = exp2f(sc - mx);
    float sum = p;
#pragma unroll
    for (int o = KL / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    const float inv = 1.f / sum;
    // every lane of the row takes the row's probabilities
    float pr[KL];
#pragma unroll
    for (int t = 0; t < KL; ++t) pr[t] = __shfl_sync(FULL, p, (lane & ~(KL - 1)) + t);
    const bool store = p0 + sub < tq;
    float* orow = out + (bh * tq + r) * dh;
    for (int g = j; g < groups; g += KL) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < KL; ++t) {
        if (t < tk) {
          const float4 vv = widen4(*reinterpret_cast<const uint2*>(vs + t * dh + 4 * g));
          acc.x += pr[t] * vv.x;
          acc.y += pr[t] * vv.y;
          acc.z += pr[t] * vv.z;
          acc.w += pr[t] * vv.w;
        }
      }
      if (store)
        *reinterpret_cast<float4*>(orow + 4 * g) =
            make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    }
  }
}

// grid (batch*heads, ceil(Tq / TC_ROWS)), TC_WARPS warps; dynamic shared
// memory of tc_smem bytes: TC_STAGES stages of a K and a V tile of KEYS rows
// of bf16, the bias of every key (ntiles * KEYS floats), a flag and the
// list of live tiles (ntiles ints each).  dh % 8 == 0, dh <= DHP, q, k, v
// 16-byte aligned, Tk <= TC_MAX_KEYS.
template <int DHP>
__global__ void __launch_bounds__(TC_WARPS * WARP)
masked_attention_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const uint8_t* __restrict__ key_mask,  // (B, Tk) or null
                    float* __restrict__ out, int heads, int tq, int tk, int dh,
                    float sm_scale) {
  using bf16tc::KEYS;
  constexpr int TILE = KEYS * bf16tc::row_stride(DHP), DT = DHP / 8;
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  const int ntiles = (tk + KEYS - 1) / KEYS;
  float* bias = reinterpret_cast<float*>(ring + TC_STAGES * 2 * TILE);
  int* flag = reinterpret_cast<int*>(bias + ntiles * KEYS);
  int* live = flag + ntiles;
  __shared__ int n_live;

  const int bh = blockIdx.x, b = bh / heads;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = blockIdx.y * TC_ROWS + warp * 16;   // the warp's first query row
  const __nv_bfloat16* kh = k + (size_t)bh * tk * dh;
  const __nv_bfloat16* vh = v + (size_t)bh * tk * dh;

  // Q's fragments first: their loads are in flight during the mask scan
  uint32_t qf[DHP / 16][1][4];
  bf16tc::load_q<DHP, 1>(qf, q + ((size_t)bh * tq + r0) * dh, tq - r0, dh);

  // each key's bias (0, NEG_INF, or -inf past Tk) and which tiles hold a
  // visible key
  int any = 0;
  for (int kt = warp; kt < ntiles; kt += TC_WARPS) {
    const int key = kt * KEYS + lane;
    const bool visible = key < tk && (key_mask == nullptr || key_mask[(size_t)b * tk + key]);
    bias[key] = key >= tk ? -INFINITY : visible ? 0.f : NEG_INF;
    const unsigned ballot = __ballot_sync(FULL, visible);
    if (lane == 0) flag[kt] = ballot != 0u;
    any |= ballot != 0u;
  }
  // skip tiles without a visible key only where the batch element has one
  const bool skip = __syncthreads_or(any);
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < ntiles; base += WARP) {
      const int kt = base + lane;
      const bool keep = kt < ntiles && (!skip || flag[kt]);
      const unsigned ballot = __ballot_sync(FULL, keep);
      if (keep) live[count + __popc(ballot & ((1u << lane) - 1u))] = kt;
      count += __popc(ballot);
    }
    if (lane == 0) n_live = count;
  }
  __syncthreads();
  const int n = n_live;

  auto issue = [&](int i) {   // live tile i into its stage; a group even when empty
    if (i < n) {
      __nv_bfloat16* stage = ring + (i % TC_STAGES) * 2 * TILE;
      const int key0 = live[i] * KEYS, rows = min(KEYS, tk - key0);
      bf16tc::stage_rows<DHP>(stage, kh + (size_t)key0 * dh, rows, KEYS, dh);
      bf16tc::stage_rows<DHP>(stage + TILE, vh + (size_t)key0 * dh, rows, KEYS, dh);
    }
    bf16tc::commit();
  };
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) issue(i);

  float m[1][2] = {{NEG_INF, NEG_INF}}, l[1][2] = {{0.f, 0.f}};
  float acc[1][DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][dt][e] = 0.f;
  const float scale2 = sm_scale * LOG2E;
  for (int i = 0; i < n; ++i) {
    bf16tc::wait<TC_STAGES - 2>();   // live tile i has landed (this thread's copies)
    __syncthreads();                 // everyone's, and tile i - 1's stage is free
    issue(i + TC_STAGES - 1);
    if (r0 < tq) {
      const __nv_bfloat16* ks = ring + (i % TC_STAGES) * 2 * TILE;
      const float* tile_bias = bias + live[i] * KEYS;
      bf16tc::step<DHP, 1>(qf, ks, ks + TILE, 0, KEYS - 1,
                           [&](float s, int, int nt, int e) {
                             return s * scale2 + tile_bias[nt * 8 + 2 * tg + (e & 1)];
                           },
                           m, l, acc);
    }
  }
  bf16tc::row_sums<1>(l);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row < tq) {
      const float inv = 1.f / l[0][h];
      float* orow = out + ((size_t)bh * tq + row) * dh;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + 2 * tg;
        if (col < dh)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[0][dt][2 * h] * inv, acc[0][dt][2 * h + 1] * inv);
      }
    }
  }
}

__global__ void empty_kernel() {}

// How the resident path cuts a call into blocks: rows of a head per block
// (a multiple of ROWS; the whole head where there are heads enough to fill
// the card) and warps per block.  fits is false where K and V of one head
// exceed the shared-memory budget or Tk exceeds MAX_KPL keys per lane.
struct ResidentLaunch {
  bool fits;
  int kpl, rows_per_block, nsplit, nwarps;
  size_t smem;
};

ResidentLaunch plan_resident(int bh, int tq, int tk, int dh) {
  ResidentLaunch r{};
  r.kpl = (tk + WARP - 1) / WARP;
  if (r.kpl > MAX_KPL) return r;
  r.kpl = r.kpl <= 2 ? r.kpl : r.kpl <= 4 ? 4 : 8;   // the instances built
  const ResidentPlan plan(tk, dh, r.kpl);
  const int want = bh >= SM_COUNT ? 1 : (2 * SM_COUNT + bh - 1) / bh;
  const int finest = (tq + MIN_SPLIT_ROWS - 1) / MIN_SPLIT_ROWS;
  int split = want < finest ? want : finest;
  for (;;) {
    r.rows_per_block = ((tq + split - 1) / split + ROWS - 1) / ROWS * ROWS;
    r.nsplit = (tq + r.rows_per_block - 1) / r.rows_per_block;
    const int groups = r.rows_per_block / ROWS;
    r.nwarps = groups < MAX_WARPS ? groups : MAX_WARPS;
    r.smem = plan.floats(tk, r.rows_per_block, r.nwarps) * sizeof(float);
    if (r.smem <= SMEM_BUDGET || r.rows_per_block == ROWS) break;
    split *= 2;   // fewer query rows per block
  }
  r.fits = r.smem <= SMEM_BUDGET && r.nsplit <= 65535;
  return r;
}

template <typename T, int KPL, int SLOTS>
cudaError_t launch_resident(const ResidentLaunch& r, const T* q, const T* k,
                            const T* v, const uint8_t* key_mask, float* out,
                            int bh, int heads, int tq, int tk, int dh,
                            float sm_scale, cudaStream_t stream) {
  if (r.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(masked_attention_resident<T, KPL, SLOTS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)r.smem);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = dh % 4 == 0 && bits % 16 == 0;
  masked_attention_resident<T, KPL, SLOTS>
      <<<dim3(bh, r.nsplit), r.nwarps * WARP, r.smem, stream>>>(
          q, k, v, key_mask, out, heads, tq, tk, dh, r.rows_per_block, sm_scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chunked(const T* q, const T* k, const T* v,
                           const uint8_t* key_mask, float* out, int bh, int heads,
                           int tq, int tk, int dh, float sm_scale, cudaStream_t stream) {
  const size_t smem = ((size_t)KV_CHUNK * (2 * dh + 1) + (size_t)CHUNK_ROWS * dh + KV_CHUNK)
                      * sizeof(float);
  dim3 grid(bh, (tq + CHUNK_ROWS - 1) / CHUNK_ROWS);
  masked_attention_chunked<T><<<grid, CHUNK_ROWS * WARP, smem, stream>>>(
      q, k, v, key_mask, out, heads, tq, tk, dh, sm_scale);
  return cudaGetLastError();
}

// whether masked_attention_tc can take the shape, and whether the bf16
// launcher gives it to it (the crossover)
bool tc_fits(const void* q, const void* k, const void* v, int tk, int dh) {
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  return dh % 8 == 0 && dh <= 64 && tk <= TC_MAX_KEYS && bits % 16 == 0;
}

bool tc_takes(const void* q, const void* k, const void* v, int tq, int tk, int dh) {
  return (tq >= TC_MIN_SIDE || tk >= TC_MIN_SIDE) && tc_fits(q, k, v, tk, dh);
}

template <int DHP>
cudaError_t launch_tc_dhp(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const uint8_t* key_mask, float* out,
                          int bh, int heads, int tq, int tk, int dh, float sm_scale,
                          cudaStream_t stream) {
  const int ntiles = (tk + bf16tc::KEYS - 1) / bf16tc::KEYS;
  const size_t smem = (size_t)TC_STAGES * 2 * bf16tc::KEYS * bf16tc::row_stride(DHP)
                          * sizeof(__nv_bfloat16)
                      + (size_t)ntiles * (bf16tc::KEYS * sizeof(float) + 2 * sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(masked_attention_tc<DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  masked_attention_tc<DHP><<<dim3(bh, (tq + TC_ROWS - 1) / TC_ROWS), TC_WARPS * WARP, smem,
                             stream>>>(q, k, v, key_mask, out, heads, tq, tk, dh, sm_scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const uint8_t* key_mask, float* out, int bh, int heads, int tq, int tk,
                      int dh, float sm_scale, cudaStream_t s) {
  return dh <= 16 ? launch_tc_dhp<16>(q, k, v, key_mask, out, bh, heads, tq, tk, dh, sm_scale, s)
         : dh <= 32 ? launch_tc_dhp<32>(q, k, v, key_mask, out, bh, heads, tq, tk, dh, sm_scale, s)
                    : launch_tc_dhp<64>(q, k, v, key_mask, out, bh, heads, tq, tk, dh, sm_scale, s);
}

// lanes a row of the few-keys kernel: Dh / 4 rounded up to a power of 2,
// at least 2
int few_keys_lanes(int dh) {
  int lpr = 2;
  while (4 * lpr < dh) lpr *= 2;
  return lpr;
}

// its blocks: as many as the rows fill, at most one wave of `per_sm` an SM
// (as many as fit it at once), each striding over the rest
int few_keys_blocks(long long rows, int lpr, int per_sm) {
  const long long fill = (rows * lpr + FEW_THREADS - 1) / FEW_THREADS;
  const long long wave = (long long)SM_COUNT * per_sm;
  return (int)(fill < wave ? fill : wave);
}

bool few_keys_takes(int tq, int tk) { return tk <= FEW_MAX_KEYS && tq > tk; }

// blocks of an instance of the few-keys kernel that fit an SM at once (its
// registers decide), asked of the runtime once
template <typename T, int LPR, int TK>
cudaError_t few_keys_per_sm(int* per_sm) {
  static int cached = 0;
  if (cached == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, masked_attention_few_keys<T, LPR, TK>, FEW_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  *per_sm = cached;
  return cudaSuccess;
}

template <typename T, int TK>
cudaError_t few_keys_per_sm_of(int lpr, int* per_sm) {
  return lpr == 2 ? few_keys_per_sm<T, 2, TK>(per_sm)
         : lpr == 4 ? few_keys_per_sm<T, 4, TK>(per_sm)
         : lpr == 8 ? few_keys_per_sm<T, 8, TK>(per_sm)
         : lpr == 16 ? few_keys_per_sm<T, 16, TK>(per_sm)
                     : few_keys_per_sm<T, 32, TK>(per_sm);
}

template <typename T>
cudaError_t few_keys_per_sm_of(int lpr, int tk, int* per_sm) {
#define K(N) few_keys_per_sm_of<T, N>(lpr, per_sm)
  return tk == 1 ? K(1) : tk == 2 ? K(2) : tk == 3 ? K(3) : tk == 4 ? K(4) : tk == 5 ? K(5)
         : tk == 6 ? K(6) : tk == 7 ? K(7) : K(8);
#undef K
}

template <typename T, int LPR, int TK>
cudaError_t launch_few_keys_lpr(const T* q, const T* k, const T* v, const uint8_t* key_mask,
                                float* out, int bh, int heads, int tq, int dh, float sm_scale,
                                cudaStream_t stream) {
  const long long rows = (long long)bh * tq;
  if (rows >= (1LL << 31)) return cudaErrorInvalidValue;
  int per_sm;
  cudaError_t err = few_keys_per_sm<T, LPR, TK>(&per_sm);
  if (err != cudaSuccess) return err;
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = dh % 4 == 0 && bits % 16 == 0;
  masked_attention_few_keys<T, LPR, TK><<<few_keys_blocks(rows, LPR, per_sm), FEW_THREADS, 0,
                                          stream>>>(q, k, v, key_mask, out, (int)rows, heads,
                                                    tq, dh, sm_scale, vec);
  return cudaGetLastError();
}

// an instance per key count: the registers that hold K and V follow it (one
// instance for up to 8 keys holds 8 at every count, and fewer of its blocks
// fit an SM)
template <typename T, int TK>
cudaError_t launch_few_keys_tk(const T* q, const T* k, const T* v, const uint8_t* key_mask,
                               float* out, int bh, int heads, int tq, int dh, float sm_scale,
                               cudaStream_t s) {
  const int lpr = few_keys_lanes(dh);
#define LAUNCH(LPR) \
  launch_few_keys_lpr<T, LPR, TK>(q, k, v, key_mask, out, bh, heads, tq, dh, sm_scale, s)
  return lpr == 2 ? LAUNCH(2) : lpr == 4 ? LAUNCH(4) : lpr == 8 ? LAUNCH(8)
         : lpr == 16 ? LAUNCH(16) : LAUNCH(32);
#undef LAUNCH
}

// 1 <= tk <= FEW_MAX_KEYS
template <typename T>
cudaError_t launch_few_keys(const T* q, const T* k, const T* v, const uint8_t* key_mask,
                            float* out, int bh, int heads, int tq, int tk, int dh,
                            float sm_scale, cudaStream_t s) {
#define K(N) launch_few_keys_tk<T, N>(q, k, v, key_mask, out, bh, heads, tq, dh, sm_scale, s)
  return tk == 1 ? K(1) : tk == 2 ? K(2) : tk == 3 ? K(3) : tk == 4 ? K(4) : tk == 5 ? K(5)
         : tk == 6 ? K(6) : tk == 7 ? K(7) : K(8);
#undef K
}

// whether masked_attention_short_bf16 takes the shape
bool short_takes(const void* q, const void* k, const void* v, int tq, int tk, int dh) {
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  return tq < TC_MIN_SIDE && tk < TC_MIN_SIDE && dh % 8 == 0 && dh <= SHORT_MAX_DH
         && bits % 16 == 0;
}

size_t short_smem(int tq, int tk, int dh) {
  return (size_t)SHORT_WARPS * short_warp_bytes(tq, tk, dh);
}

cudaError_t launch_short(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const uint8_t* key_mask, float* out, int bh,
                         int heads, int tq, int tk, int dh, float sm_scale, cudaStream_t s) {
  const int blocks = (bh + SHORT_WARPS - 1) / SHORT_WARPS;
  const size_t smem = short_smem(tq, tk, dh);   // at most 46 KB: no attribute needed
  if (tk <= 8)
    masked_attention_short_bf16<8><<<blocks, SHORT_WARPS * WARP, smem, s>>>(
        q, k, v, key_mask, out, bh, heads, tq, tk, dh, sm_scale);
  else
    masked_attention_short_bf16<16><<<blocks, SHORT_WARPS * WARP, smem, s>>>(
        q, k, v, key_mask, out, bh, heads, tq, tk, dh, sm_scale);
  return cudaGetLastError();
}

// The resident kernel where the head fits it, else the chunked one; writes
// which to *variant (0 resident, 1 chunked) and launches on `stream`.
template <typename T>
cudaError_t resident_or_chunked(const T* q, const T* k, const T* v, const uint8_t* mask,
                                float* out, int batch, int heads, int tq, int tk, int dh,
                                float sm_scale, cudaStream_t s, int* variant) {
  const int bh = batch * heads;
  const ResidentLaunch r = plan_resident(bh, tq, tk, dh);
  if (!r.fits) {
    *variant = CHUNKED;
    return launch_chunked<T>(q, k, v, mask, out, bh, heads, tq, tk, dh, sm_scale, s);
  }
  *variant = RESIDENT;
#define LAUNCH(KPL)                                                                  \
  (dh <= WARP ? launch_resident<T, KPL, 1>(r, q, k, v, mask, out, bh, heads, tq, tk, dh, \
                                           sm_scale, s)                             \
              : launch_resident<T, KPL, DH_SLOTS>(r, q, k, v, mask, out, bh, heads, tq, \
                                                  tk, dh, sm_scale, s))
  return r.kpl == 1 ? LAUNCH(1) : r.kpl == 2 ? LAUNCH(2) : r.kpl == 4 ? LAUNCH(4) : LAUNCH(8);
#undef LAUNCH
}

// The fp32 route, and the bf16 launcher's where neither bf16 kernel takes
// the shape: the few-keys kernel (*variant 3), else resident or chunked.
template <typename T>
cudaError_t forward(const T* q, const T* k, const T* v, const uint8_t* mask, float* out,
                    int batch, int heads, int tq, int tk, int dh, float sm_scale,
                    cudaStream_t s, int* variant) {
  if (few_keys_takes(tq, tk)) {
    *variant = FEW_KEYS;
    return launch_few_keys<T>(q, k, v, mask, out, batch * heads, heads, tq, tk, dh, sm_scale,
                              s);
  }
  return resident_or_chunked<T>(q, k, v, mask, out, batch, heads, tq, tk, dh, sm_scale, s,
                                variant);
}

}  // namespace

extern "C" {

// q: (B*H, Tq, Dh), k/v: (B*H, Tk, Dh) contiguous fp32 (masked_attention_forward)
// or bf16 (masked_attention_forward_bf16) on the device; out: (B*H, Tq, Dh)
// contiguous fp32; key_mask: (B, Tk) bool (1 byte) or null.  1 <= Dh <= 128.
// Picks the path by shape, writes which one to *variant (0 resident, 1
// chunked, 2 the bf16 tensor-core kernel, 3 few keys, 4 short bf16),
// launches on `stream` and returns cudaGetLastError().
int masked_attention_forward(const void* q, const void* k, const void* v,
                             const void* key_mask, void* out, int batch,
                             int heads, int tq, int tk, int dh,
                             float sm_scale, void* stream, int* variant) {
  return (int)forward((const float*)q, (const float*)k, (const float*)v,
                      (const uint8_t*)key_mask, (float*)out, batch, heads, tq, tk, dh,
                      sm_scale, (cudaStream_t)stream, variant);
}

// The bf16 launcher: the tensor-core kernel where tc_takes the shape
// (*variant 2), the short kernel where short_takes it (4), else the fp32
// route on bf16 inputs, widened as they are loaded (3, 0 or 1).
int masked_attention_forward_bf16(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* out, int batch,
                                  int heads, int tq, int tk, int dh,
                                  float sm_scale, void* stream, int* variant) {
  const __nv_bfloat16 *qb = (const __nv_bfloat16*)q, *kb = (const __nv_bfloat16*)k,
                      *vb = (const __nv_bfloat16*)v;
  if (tc_takes(q, k, v, tq, tk, dh)) {
    *variant = TC_BF16;
    return (int)launch_tc(qb, kb, vb, (const uint8_t*)key_mask, (float*)out, batch * heads,
                          heads, tq, tk, dh, sm_scale, (cudaStream_t)stream);
  }
  if (short_takes(q, k, v, tq, tk, dh)) {
    *variant = SHORT_BF16;
    return (int)launch_short(qb, kb, vb, (const uint8_t*)key_mask, (float*)out, batch * heads,
                             heads, tq, tk, dh, sm_scale, (cudaStream_t)stream);
  }
  return (int)forward(qb, kb, vb, (const uint8_t*)key_mask, (float*)out, batch, heads, tq, tk,
                      dh, sm_scale, (cudaStream_t)stream, variant);
}

// Yardsticks of the routes, which the port's wrapper never calls (the
// arguments of masked_attention_forward less `variant`): the resident or
// chunked kernel whatever the shape, on fp32 (the route before the few-keys
// kernel) and on bf16 (the widening path, before the short and few-keys
// kernels); the tensor-core kernel wherever it fits (tc_fits; else
// cudaErrorInvalidValue), under TC_MIN_SIDE too.  The few-keys kernel's
// yardstick follows them.
int masked_attention_forward_resident(const void* q, const void* k, const void* v,
                                      const void* key_mask, void* out, int batch, int heads,
                                      int tq, int tk, int dh, float sm_scale, void* stream) {
  int variant;
  return (int)resident_or_chunked((const float*)q, (const float*)k, (const float*)v,
                                  (const uint8_t*)key_mask, (float*)out, batch, heads, tq, tk,
                                  dh, sm_scale, (cudaStream_t)stream, &variant);
}

int masked_attention_forward_bf16_widened(const void* q, const void* k, const void* v,
                                          const void* key_mask, void* out, int batch,
                                          int heads, int tq, int tk, int dh,
                                          float sm_scale, void* stream) {
  int variant;
  return (int)resident_or_chunked((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                  (const __nv_bfloat16*)v, (const uint8_t*)key_mask,
                                  (float*)out, batch, heads, tq, tk, dh, sm_scale,
                                  (cudaStream_t)stream, &variant);
}

int masked_attention_forward_bf16_tc(const void* q, const void* k, const void* v,
                                     const void* key_mask, void* out, int batch,
                                     int heads, int tq, int tk, int dh,
                                     float sm_scale, void* stream) {
  if (!tc_fits(q, k, v, tk, dh)) return (int)cudaErrorInvalidValue;
  return (int)launch_tc((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                        (const __nv_bfloat16*)v, (const uint8_t*)key_mask, (float*)out,
                        batch * heads, heads, tq, tk, dh, sm_scale, (cudaStream_t)stream);
}

// The few-keys kernel wherever it fits (Tk <= FEW_MAX_KEYS; else
// cudaErrorInvalidValue), Tq <= Tk too: the other side of its crossover.
int masked_attention_forward_few_keys(const void* q, const void* k, const void* v,
                                      const void* key_mask, void* out, int batch, int heads,
                                      int tq, int tk, int dh, float sm_scale, void* stream) {
  if (tk > FEW_MAX_KEYS) return (int)cudaErrorInvalidValue;
  return (int)launch_few_keys((const float*)q, (const float*)k, (const float*)v,
                              (const uint8_t*)key_mask, (float*)out, batch * heads, heads, tq,
                              tk, dh, sm_scale, (cudaStream_t)stream);
}

// The chunked kernel whatever the shape: a yardstick for the resident path
// at the shapes the launcher gives to it.  The port's wrapper never calls it.
int masked_attention_forward_chunked(const void* q, const void* k, const void* v,
                                     const void* key_mask, void* out, int batch,
                                     int heads, int tq, int tk, int dh,
                                     float sm_scale, void* stream) {
  return (int)launch_chunked<float>((const float*)q, (const float*)k, (const float*)v,
                             (const uint8_t*)key_mask, (float*)out, batch * heads,
                             heads, tq, tk, dh, sm_scale, (cudaStream_t)stream);
}

// A kernel that does nothing, launched with the grid, block and shared
// memory that the launcher of `bf16` (0: masked_attention_forward, 1:
// masked_attention_forward_bf16 on 16-byte aligned inputs) uses at this
// shape: what one launch costs on the card, the floor under the kernel's
// time.  The resident kernel's launch where `resident` is set, whatever the
// route.
int empty_launch(int batch, int heads, int tq, int tk, int dh, int bf16, int resident,
                 void* stream) {
  const int bh = batch * heads;
  dim3 grid;
  int threads;
  size_t smem = 0;
  const void* aligned = nullptr;
  if (!resident && bf16 && tc_takes(aligned, aligned, aligned, tq, tk, dh)) {
    const int ntiles = (tk + bf16tc::KEYS - 1) / bf16tc::KEYS;
    const int dhp = dh <= 16 ? 16 : dh <= 32 ? 32 : 64;
    grid = dim3(bh, (tq + TC_ROWS - 1) / TC_ROWS);
    threads = TC_WARPS * WARP;
    smem = (size_t)TC_STAGES * 2 * bf16tc::KEYS * bf16tc::row_stride(dhp)
               * sizeof(__nv_bfloat16)
           + (size_t)ntiles * (bf16tc::KEYS * sizeof(float) + 2 * sizeof(int));
  } else if (!resident && bf16 && short_takes(aligned, aligned, aligned, tq, tk, dh)) {
    grid = dim3((bh + SHORT_WARPS - 1) / SHORT_WARPS);
    threads = SHORT_WARPS * WARP;
    smem = short_smem(tq, tk, dh);
  } else if (!resident && few_keys_takes(tq, tk)) {
    const int lpr = few_keys_lanes(dh);
    int per_sm;
    cudaError_t err = bf16 ? few_keys_per_sm_of<__nv_bfloat16>(lpr, tk, &per_sm)
                           : few_keys_per_sm_of<float>(lpr, tk, &per_sm);
    if (err != cudaSuccess) return (int)err;
    grid = dim3(few_keys_blocks((long long)bh * tq, lpr, per_sm));
    threads = FEW_THREADS;
  } else {
    const ResidentLaunch r = plan_resident(bh, tq, tk, dh);
    grid = dim3(bh, r.fits ? r.nsplit : (tq + CHUNK_ROWS - 1) / CHUNK_ROWS);
    threads = r.fits ? r.nwarps * WARP : CHUNK_ROWS * WARP;
    smem = r.fits ? r.smem : 0;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  empty_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

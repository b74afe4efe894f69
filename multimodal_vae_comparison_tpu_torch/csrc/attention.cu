// Masked attention forward for Hopper (sm_90a): fp32 or bf16 q, k, v, fp32
// out.
//
// Replaces the Pallas TPU kernel masked_flash_attention -> _flash_pallas
// (body _attn_kernel) in multimodal_vae_comparison_tpu/ops/pallas/attention.py:
//   out = softmax(q k^T / sqrt(Dh) + bias) v,  bias = 0 or -1e30 per key.
//
// What bounds it on the card: at the model's shapes (Tq = Tk = 45, Dh = 32;
// Tq = 45, Tk = 1, Dh = 8) a head is a few KB, the whole call a few MB and
// tens of MFLOP: a microsecond of either.  What it waits for is latency: the
// launch, the first loads from device memory, and every dependent step
// (barrier, reduction, shuffle) after them.  So the design cuts dependent
// steps and repeated traffic; tensor cores would add nothing.
//
// Resident path (the model's shapes).  One thread block owns a whole head,
// or a run of its query rows where there are too few heads to fill the card.
// Q, K, V and the mask bias of the head go to shared memory once, as 16-byte
// cp.async copies, in buffers sized by the call's Dh and Tk.  With the whole
// key axis resident there is no online softmax and one barrier: a warp takes
// ROWS query rows at a time (independent work that hides latency, and every
// K and V value read from shared memory feeds ROWS rows); lane j scores keys
// j, j + 32, ... (KPL of them, a template parameter, scores in registers,
// as base-2 logits so that the exponential is one ex2); one max and one sum
// reduction per row; the probabilities go through a per-warp buffer and lane
// d accumulates output dims d, d + 32, ... (SLOTS of them, a template
// parameter: 1 up to Dh 32).
// K rows are padded to an odd number of 16-byte units so that the lanes'
// float4 reads of 32 different rows do not collide on banks.
//
// Chunked path (Tk > 256, or a head whose K and V do not fit the shared
// memory budget): one block per (head, 8 query rows), a warp per row, K and
// V staged 32 keys at a time with an online softmax over the chunks.
//
// Masking is additive with -1e30 exactly as the TPU kernel does it; masked
// keys are never skipped, so a row with every key masked gives the uniform
// average of V, as the Pallas kernel and the XLA path both give.
//
// Input dtype.  The resident and chunked kernels are templates on the
// element type T of q, k and v, instantiated for float and __nv_bfloat16.
// bf16 is widened to fp32 as it is staged (exact), so the arithmetic after
// it is the fp32 kernel's and the output is fp32, as the Pallas kernel
// widens its bf16 inputs.  The resident path's vector staging moves 4
// elements a thread: a 16-byte cp.async for fp32, an 8-byte load widened
// into a float4 for bf16 (synchronous).  Its rule (Dh % 4 == 0 and 16-byte
// aligned inputs) keeps every bf16 unit 8-byte aligned, so it holds for both
// types.
//
// bf16 tensor-core path (masked_attention_tc, masked_attention_forward_bf16
// where tc_takes the shape: Tq or Tk >= TC_MIN_SIDE, Dh % 8 == 0, Dh <= 64,
// Tk <= TC_MAX_KEYS, 16-byte aligned inputs).  Long padded key axes (CUB's
// captions: 246 keys, 77 % padding) made the resident path slower than SDPA:
// it scores and sums every key, masked or not, with FMAs.  Here a warp owns
// 16 query rows (a block 4 warps, 64 rows) and walks the key axis 32 keys a
// step on bf16 MMAs (bf16_tc.cuh): S = Q K^T with q and k as they are, P
// split into two bf16 planes for P V, K and V tiles staged in bf16 by
// cp.async in a three-stage ring.  Like the resident path it is bound by
// latency at the models' shapes (a head's bytes and products take well under
// a microsecond of the card), so the ring keeps two tiles' loads in flight.
// Key tiles whose 32 keys are all masked are skipped, where the batch element
// has a visible key: a masked score is s - 1e30, so once a row's max comes
// from a visible key ex2 of it is exactly 0 (and a tile before the first
// visible one is scaled by ex2(-1e30 - max) = 0 and forgotten), so the skip
// changes no bit.  A batch element whose keys are all masked skips nothing
// and gets the uniform average of V, as above.  The skip is decided per block
// from the (B, Tk) mask: a warp's ballot per tile, then a list of the live
// tiles compacted by one warp, which the ring walks.  Where Tq and Tk are
// both under TC_MIN_SIDE the resident path stays: most of a 16-row, 32-key
// step would be empty, and at SPRITES' 8 x 8 axial heads the tensor-core
// kernel took longer than the resident one, where every other bf16 shape of
// the model paths, the flagship's 45 keys and the one-key decoders among
// them, ran faster on it (the A/B of chip_smoke.py's "bf16 steps", which
// times both at every bf16 shape it measures).
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
constexpr int TC_MIN_SIDE = 16;    // Tq and Tk both shorter: the resident path
constexpr int TC_MAX_KEYS = 8192;  // the bias and tile list fit shared memory

enum Variant { RESIDENT = 0, CHUNKED = 1, TC_BF16 = 2 };

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

// Picks the path by shape, writes which one to *variant (0 resident, 1
// chunked) and launches on `stream`.
template <typename T>
cudaError_t forward(const T* q, const T* k, const T* v, const uint8_t* mask, float* out,
                    int batch, int heads, int tq, int tk, int dh, float sm_scale,
                    cudaStream_t s, int* variant) {
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

}  // namespace

extern "C" {

// q: (B*H, Tq, Dh), k/v: (B*H, Tk, Dh) contiguous fp32 (masked_attention_forward)
// or bf16 (masked_attention_forward_bf16) on the device; out: (B*H, Tq, Dh)
// contiguous fp32; key_mask: (B, Tk) bool (1 byte) or null.  1 <= Dh <= 128.
// Picks the path by shape, writes which one to *variant (0 resident, 1
// chunked, 2 the bf16 tensor-core kernel), launches on `stream` and returns
// cudaGetLastError().
int masked_attention_forward(const void* q, const void* k, const void* v,
                             const void* key_mask, void* out, int batch,
                             int heads, int tq, int tk, int dh,
                             float sm_scale, void* stream, int* variant) {
  return (int)forward((const float*)q, (const float*)k, (const float*)v,
                      (const uint8_t*)key_mask, (float*)out, batch, heads, tq, tk, dh,
                      sm_scale, (cudaStream_t)stream, variant);
}

// The bf16 launcher: the tensor-core kernel where tc_takes the shape
// (*variant 2), else the resident or chunked kernel on widened inputs.
int masked_attention_forward_bf16(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* out, int batch,
                                  int heads, int tq, int tk, int dh,
                                  float sm_scale, void* stream, int* variant) {
  if (tc_takes(q, k, v, tq, tk, dh)) {
    *variant = TC_BF16;
    return (int)launch_tc((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                          (const __nv_bfloat16*)v, (const uint8_t*)key_mask, (float*)out,
                          batch * heads, heads, tq, tk, dh, sm_scale, (cudaStream_t)stream);
  }
  return (int)forward((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                      (const __nv_bfloat16*)v, (const uint8_t*)key_mask, (float*)out,
                      batch, heads, tq, tk, dh, sm_scale, (cudaStream_t)stream, variant);
}

// Yardsticks of the bf16 launcher's crossover, which the port's wrapper
// never calls (the arguments of masked_attention_forward_bf16 less
// `variant`): the widening path (resident or chunked on bf16) whatever
// the shape, and the tensor-core kernel wherever it fits (tc_fits; else
// cudaErrorInvalidValue), under TC_MIN_SIDE too.
int masked_attention_forward_bf16_widened(const void* q, const void* k, const void* v,
                                          const void* key_mask, void* out, int batch,
                                          int heads, int tq, int tk, int dh,
                                          float sm_scale, void* stream) {
  int variant;
  return (int)forward((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                      (const __nv_bfloat16*)v, (const uint8_t*)key_mask, (float*)out,
                      batch, heads, tq, tk, dh, sm_scale, (cudaStream_t)stream, &variant);
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
// memory that masked_attention_forward uses at this shape: what one launch
// costs on the card, the floor under the kernel's time.
int empty_launch(int batch, int heads, int tq, int tk, int dh, void* stream) {
  const int bh = batch * heads;
  const ResidentLaunch r = plan_resident(bh, tq, tk, dh);
  dim3 grid(bh, r.fits ? r.nsplit : (tq + CHUNK_ROWS - 1) / CHUNK_ROWS);
  const int threads = r.fits ? r.nwarps * WARP : CHUNK_ROWS * WARP;
  const size_t smem = r.fits ? r.smem : 0;
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

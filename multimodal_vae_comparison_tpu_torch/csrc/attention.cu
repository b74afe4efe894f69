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
// route cuts dependent steps and repeated traffic; the routes with a long
// side run their products on the tensor cores (bf16, and fp32 as 3xTF32).
//
// The routes, picked by shape in forward() and masked_attention_forward_bf16:
//
//   fp32 q, k, v                    bf16 q, k, v
//   ------------                    ------------
//                                   1. few_keys   Tk == 1 < Tq
//                                                 (few_keys_takes_bf16)
//                                   2. tc_bf16    Tq or Tk >= 16 (tc_takes)
//                                   3. short_bf16 Tq, Tk < 16, Dh % 8 == 0,
//                                                 Dh <= 64 (short_takes)
//   4. few_keys  Tk <= 8 (few_keys_takes), both types
//   5. mma       Dh % 4 == 0, 8 <= Dh, 16-byte aligned (mma_takes), where
//                the resident kernel cannot hold the head or Tq and Tk
//                both exceed 16 (mma_over_resident), both types
//   6. resident  the head's K and V fit shared memory (Tk <= 256), both types
//      chunked   every other head, both types
//
// Crossovers (set by H100 A/Bs: kernel_variants.py few_keys, few_keys_bf16,
// short_bf16 and long_keys, chip_smoke.py's "bf16 steps"): the fp32
// tensor-core kernel over the resident one from 17 query rows and 17 keys
// (mma_over_resident); the bf16 tensor-core kernel from
// a side of 16, where most of its 16-row, 32-key step is filled; on fp32 the
// few-keys kernel wherever a head has at most 8 keys (the decoders' cross-
// attention over 1 latent or 5 conditioning tokens, and SPRITES' 8 x 8
// axial heads: 0.190 against the resident kernel's 0.295 ms at
// (61440,2,8,8,32)); on bf16 ahead of the tensor-core kernel only at one key
// (CUB's decoder 0.0070 against 0.0166 ms; at 5 keys the tensor-core kernel
// wins, 0.0170 against 0.0281).  The route past the few-keys kernel is also
// exported alone (masked_attention_forward_resident, and
// masked_attention_forward_bf16_widened on bf16), and the few-keys kernel
// (masked_attention_forward_few_keys, _bf16_few_keys), the resident and the
// fp32 tensor-core kernels (masked_attention_forward_resident_only, _mma)
// and the chunked kernel (_chunked), as the yardsticks of the crossovers;
// the port's wrapper never calls them.
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
// Key-padded heads (CUB's captions, 77 % padding; VILANRO's trajectories,
// 94 %) made the resident kernel score and sum every key, masked or not, at
// 23x its bound over the needed keys.  Under a mask, heads of more than one
// 32-key tile take an instance (SKIP) that leaves out the tiles whose keys
// are all masked, where the batch element has a visible key: before staging,
// every warp reads the element's mask and ballots each tile (live_tiles;
// the same bits in every warp, so no shared memory and no extra barrier), Q
// is copied meanwhile, then only the live tiles' K and V rows; the scores,
// the softmax and p v run over the live tiles only, and never read a dead
// tile's unstaged shared memory.  A dead key's score is s - 1e30, so its
// exponential is exactly 0 once the row's max comes from a visible key: the
// skip changes no bit (the dense instance, exported as
// masked_attention_forward_dense, is the yardstick that shows it, and K and
// V set to NaN in the dead tiles leave the output as it is).  An element
// whose keys are all masked keeps every tile, and so the uniform average of
// V.  Unmasked heads and one-tile heads take the dense instance.  The host
// reads no mask: the plan is the shape's, the instance the mask pointer's.
//
// fp32 tensor-core path (masked_attention_mma; heads past the resident
// kernel's reach, Tk > 256 or K and V over its shared-memory budget, and
// the heads it holds from 17 query rows and 17 keys).  The chunked loop
// below took the long heads at 23x its bound, slower than the plain version
// and SDPA: a block of 8 query rows staged the head's whole K and V through
// synchronous 4-byte loads, two barriers a 32-key chunk, each shared-memory
// read feeding one FMA, a shuffle a key in p v.  This kernel carries over
// sparse_fwd_mma's design (sparse_attention.cu): a block is 4 warps, a warp
// owns 16 query rows, its Q (scaled by log2(e) / sqrt(Dh), so that scores
// are base-2 logits) split into TF32 hi and lo once and kept in registers
// (in shared memory at Dh 128, split at each use: 64 registers more of
// fragments would spill); K and V tiles of 32 keys go through a cp.async
// ring (three stages, two at Dh 128) with rows padded by 4 floats, so the
// fragment reads of K^T and V fall on 32 different banks; S = Q K^T and
// P V run as 3xTF32 mma.sync m16n8k8 (x = hi + lo, lo hi + hi lo + hi hi,
// fp32-grade), the hi hi terms in chains of Dh / 8 (scores) and 4 (a
// tile's P V) MMAs from zero, summed with the cross terms in fp32 (the
// tensor core truncates where it accumulates); the online softmax in base
// 2, one ex2 a score, the row max over the quad by shuffles, the row sum
// reduced once at the end; P straight from the score accumulators (columns
// t, t + 4 taken as the keys 2t, 2t + 1 a thread holds, V's rows read in
// that order: no shuffle).  Dh is padded to DHP in {8, 16, 32, 64, 128}
// with zeros in shared memory.  The key-padding bias is read per tile from
// the (B, Tk) mask; keys past Tk in the last tile get -inf and zero K and V
// rows, so they add exactly 0 even where every key of the element is
// masked.  Dead tiles are skipped as in masked_attention_tc: every warp
// ballots its share of the tiles into a bit a tile in shared memory, and the
// ring and the math walk the set bits, where the element has a visible key.
// No atomics: reruns are bit-identical.  What bounds it on the card: its
// 3xTF32 MMAs issue one after another on a warp's accumulators, so at the
// long heads it runs at 4x its fp32 operation bound (16,2,512,512,32), and
// where the heads give it few blocks (Tq 20) at the latency of its serial
// walk over the key tiles.
//
// Chunked path (the heads past the resident kernel's reach that the mma
// kernel does not take: Dh % 4 != 0, Dh < 8, unaligned inputs): one block
// per (head, 8 query rows), a warp per row, K and V staged 32 keys at a
// time with an online softmax over the chunks; where the element has a
// visible key, chunks whose keys are all masked are left out whole (a
// ballot a warp, the mask read a chunk ahead).
//
// Masking is additive with -1e30 exactly as the TPU kernel does it; masked
// keys are never skipped but in whole tiles whose element has a visible
// key, so a row with every key masked gives the uniform average of V on
// every route, as the Pallas kernel and the XLA path both give.
//
// Input dtype.  The resident, mma, chunked and few-keys kernels are templates on
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
// aligned inputs).  Long key axes (CUB's captions: 246 keys) cost the
// resident path's FMAs a product a key and a lane.  Here a warp owns 16
// query rows (a block 4 warps, 64 rows) and walks the key axis 32 keys a
// step on bf16 MMAs (bf16_tc.cuh): S = Q K^T with q and k as they are, P
// split into two bf16 planes for P V, K and V tiles staged in bf16 by
// cp.async in a three-stage ring, which keeps two tiles' loads in flight.  Key tiles whose 32 keys are
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

// fp32 tensor-core path
constexpr int MMA_WARPS = 4;       // warps per block, 16 query rows each
constexpr int MMA_ROWS = 16 * MMA_WARPS;
constexpr int MMA_KEYS = 32;       // keys per tile: 4 n-tiles of 8
constexpr int MMA_PAD = 4;         // floats added to a staged row
constexpr int MMA_MAX_KEYS = 1 << 22;   // the live-tile bits fit 16 KB of shared memory

// K and V tiles in flight: three, two where a staged tile is 16 KB (Dh 128)
__host__ __device__ constexpr int mma_stages(int dhp) { return dhp > 64 ? 2 : 3; }
// where a warp keeps its split Q fragments: in registers up to Dh 64; at
// Dh 128 (64 registers of fragments more) its rows in shared memory
__host__ __device__ constexpr bool mma_q_in_smem(int dhp) { return dhp > 64; }

enum Variant { RESIDENT = 0, CHUNKED = 1, TC_BF16 = 2, FEW_KEYS = 3, SHORT_BF16 = 4, MMA = 5 };

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

// The 32-key tiles (tile c: keys 32c .. 32c + 31, as the resident path's
// lanes score them) that a batch element needs, as bits: every tile with a
// visible key, or, where the element has none, every tile with a key under
// Tk (its rows are then the uniform average of V).  A tile whose keys are
// all masked adds exactly 0 to its rows' max, sum and p v wherever the
// element has a visible key, so skipping it changes no bit.  Every warp
// computes the same bits from the (B, Tk) mask: a load and a ballot a
// tile, no shared memory and no barrier.
template <int TILES>
__device__ __forceinline__ unsigned live_tiles(const uint8_t* __restrict__ mask_row, int tk,
                                               int lane) {
  static_assert(TILES < 32, "a bit a tile");
  bool visible[TILES];
#pragma unroll
  for (int c = 0; c < TILES; ++c) {   // every load first
    const int key = c * WARP + lane;
    visible[c] = key < tk && mask_row[key];
  }
  unsigned keyed = 0u, seen = 0u;
#pragma unroll
  for (int c = 0; c < TILES; ++c) {
    if (c * WARP < tk) keyed |= 1u << c;
    if (__ballot_sync(FULL, visible[c]) != 0u) seen |= 1u << c;
  }
  return seen != 0u ? seen : keyed;
}

// grid (batch*heads, row splits), up to MAX_WARPS warps; dynamic shared
// memory of ResidentPlan::floats floats.  rows_per_block is a multiple of
// ROWS.  vec: Dh % 4 == 0 and q, k, v are 16-byte aligned.  Dh <= 32 * SLOTS.
// SKIP (a key mask, KPL > 1): leave out the key tiles live_tiles drops, in
// the staging, the scores, the softmax and p v.  Without it the kernel is
// the dense design, every tile computed: the instance unmasked heads take,
// and the yardstick the skipping is held to bit for bit.
template <typename T, int KPL, int SLOTS, bool SKIP>
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
  const int lane = threadIdx.x % WARP;

  // the live tiles (SKIP: Q's copies are in flight while the mask is read,
  // then only the live tiles' K and V rows are staged); whether tile c is
  // live is uniform across the block, so its branches diverge nowhere
  unsigned live = (1u << KPL) - 1u;
  auto tile = [&](int c) { return !SKIP || ((live >> c) & 1u); };

  // stage the head: thread (tr, tc) copies 16-byte unit tc of rows tr,
  // tr + rstep, ...; one division per thread, none per element
  if (vec) {
    const int cpr = dh >> 2;   // 16-byte units per row
    const int tr = threadIdx.x / cpr, tc = 4 * (threadIdx.x - tr * cpr);
    const int rstep = blockDim.x / cpr;
    if (SKIP) {
      if (tr < rstep)
        for (int r = tr; r < rows; r += rstep)
          stage4(qs + r * dh4 + tc, qh + (size_t)r * dh + tc);
      live = live_tiles<KPL>(key_mask + (size_t)b * tk, tk, lane);
    }
    if (tr < rstep) {
      for (int r = tr; r < tk; r += rstep)
        if (tile(r / WARP)) {
          stage4(ks + r * kstride + tc, kh + (size_t)r * dh + tc);
          stage4(vs + r * dh4 + tc, vh + (size_t)r * dh + tc);
        }
      if (!SKIP)
        for (int r = tr; r < rows; r += rstep)
          stage4(qs + r * dh4 + tc, qh + (size_t)r * dh + tc);
    }
  } else {
    // Dh not a multiple of 4, or unaligned inputs: a warp copies a row, by
    // elements; columns dh .. dh4 - 1 are zero padding
    if (SKIP) live = live_tiles<KPL>(key_mask + (size_t)b * tk, tk, lane);
    const int w = threadIdx.x / WARP, nw = blockDim.x / WARP;
    for (int c = lane; c < dh4; c += WARP) {
      const bool real = c < dh;
      for (int r = w; r < tk; r += nw)
        if (tile(r / WARP)) {
          ks[r * kstride + c] = real ? to_f(kh[(size_t)r * dh + c]) : 0.f;
          vs[r * dh4 + c] = real ? to_f(vh[(size_t)r * dh + c]) : 0.f;
        }
      for (int r = w; r < rows; r += nw)
        qs[r * dh4 + c] = real ? to_f(qh[(size_t)r * dh + c]) : 0.f;
    }
  }
  if (tile((tk - 1) / WARP))   // the tail lies in the last key's tile
    for (int idx = threadIdx.x; idx < (tk4 - tk) * dh4; idx += blockDim.x)
      vs[tk * dh4 + idx] = 0.f;   // rows Tk .. tk4 - 1: p is 0 there, v must be finite
  for (int j = threadIdx.x; j < tkp; j += blockDim.x)
    bias[j] = j >= tk ? -INFINITY
              : (key_mask == nullptr || key_mask[(size_t)b * tk + j]) ? 0.f : NEG_INF;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / WARP;
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
        if (!tile(c)) continue;
        const float4 kv = *reinterpret_cast<const float4*>(ks + key_row[c] + d);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r][c] += dot4(qv[r], kv);
      }
    }
    // softmax over the (live) key axis: one max and one sum per row
    float inv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        if (!tile(c)) continue;
        s[r][c] = s[r][c] * (sm_scale * LOG2E) + bias[lane + c * WARP];
        mx = fmaxf(mx, s[r][c]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        if (!tile(c)) continue;
        const float p = exp2f(s[r][c] - mx);   // 0 for the keys past Tk
        pw[r * tkp + lane + c * WARP] = p;
        sum += p;
      }
      inv[r] = 1.f / warp_sum(sum);
    }
    __syncwarp();
    // p v over the (live tiles') value rows: lane d owns output dims d,
    // d + 32, ...  Skipping 4 or 8 tiles, a loop a live tile (CUB's
    // encoder 0.0243 ms against 0.0269 in one loop); 2, one loop that
    // jumps over the dead tile (the flagship's 0.0083 against 0.0089;
    // kernel_variants.py --against, skip_flat_pv)
    float acc[ROWS][SLOTS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) acc[r][i] = 0.f;
    auto pv_rows = [&](int j) {   // value rows j .. j + 3
      float4 pv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pv[r] = *reinterpret_cast<const float4*>(pw + r * tkp + j);
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
    };
    if (SKIP && KPL > 2) {   // a loop a live tile
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        if (!tile(c)) continue;
        const int j_end = min((c + 1) * WARP, tk4);
        for (int j = c * WARP; j < j_end; j += 4) pv_rows(j);
      }
    } else {   // one loop, jumping over a dead tile
      for (int j = 0; j < tk4; j += 4) {
        if (!tile(j / WARP)) {
          j += WARP - 4;
          continue;
        }
        pv_rows(j);
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
// V chunk [32][Dh], Q [CHUNK_ROWS][Dh], bias [32].  skip: where the batch
// element has a visible key, leave out every chunk whose keys are all
// masked (no staging, no scores, no online-softmax step).  That changes no
// bit: a dead chunk before the first live one only scales itself away
// (alpha = e^(-1e30 - m) = 0 there), one after it adds p = 0 at alpha = 1.
// 0: every chunk (the dense yardstick).
template <typename T>
__global__ void __launch_bounds__(CHUNK_ROWS * WARP)
masked_attention_chunked(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ key_mask,  // (B, Tk) or null
                         float* __restrict__ out, int heads, int tq, int tk,
                         int dh, float sm_scale, int skip) {
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
  const uint8_t* mask_row = key_mask == nullptr ? nullptr : key_mask + (size_t)b * tk;

  const T* qrow = q + ((size_t)bh * tq + row) * dh;
  for (int d = lane; d < dh; d += WARP)
    qs[warp * dh + d] = active ? to_f(qrow[d]) * sm_scale : 0.f;
  // whether the batch element has a visible key: only then are dead chunks
  // skipped (with none, every key counts alike: the mean of V)
  int seen = 0;
  if (skip && mask_row != nullptr)
    for (int j = threadIdx.x; j < tk; j += blockDim.x) seen |= mask_row[j];
  const bool skip_dead = __syncthreads_or(seen) != 0;

  const T* kh = k + (size_t)bh * tk * dh;
  const T* vh = v + (size_t)bh * tk * dh;
  float acc[DH_SLOTS];
#pragma unroll
  for (int i = 0; i < DH_SLOTS; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  // each warp ballots the chunk's 32 mask bytes itself (the same answer in
  // every warp, so the block skips as one), loaded a chunk ahead
  bool visible_next = skip_dead && lane < tk && mask_row[lane];
  for (int k0 = 0; k0 < tk; k0 += KV_CHUNK) {
    const int n = min(KV_CHUNK, tk - k0);
    const bool visible = visible_next;
    if (skip_dead)
      visible_next = k0 + KV_CHUNK + lane < tk && mask_row[k0 + KV_CHUNK + lane];
    if (skip_dead && __ballot_sync(FULL, visible) == 0u) continue;
    __syncthreads();  // the previous chunk is consumed (and qs is written)
    if (tr < rstep)
      for (int j = tr; j < n; j += rstep) {
        ks[j * kstride + tc] = to_f(kh[(size_t)(k0 + j) * dh + tc]);
        vs[j * dh + tc] = to_f(vh[(size_t)(k0 + j) * dh + tc]);
      }
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      bias[j] = (mask_row == nullptr || mask_row[k0 + j]) ? 0.f : NEG_INF;
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
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big[n] + small[n] += a b[n] for N accumulator pairs at fp32-grade
// accuracy: big takes the hi hi term, small the two cross terms (2^-11 of
// its size); b[n] = (b0[n], b1[n]) is split here, and each term runs over
// all accumulators before the next, so that consecutive MMAs do not wait
// for each other.  The tensor core truncates toward zero where it
// accumulates, so the caller starts big from zero every few MMAs and adds
// the pieces in fp32.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&big)[N][4], float (&small)[N][4],
                                           const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           const float (&b0)[N], const float (&b1)[N]) {
  uint32_t b0_hi[N], b0_lo[N], b1_hi[N], b1_lo[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_tf32(b0[n], b0_hi[n], b0_lo[n]);
    split_tf32(b1[n], b1_hi[n], b1_lo[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(small[n], a_lo, b0_hi[n], b1_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(small[n], a_hi, b0_lo[n], b1_lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(big[n], a_hi, b0_hi[n], b1_hi[n]);
}

// MMA_KEYS rows of dh elements at g -> rows of DHP + MMA_PAD floats at s,
// 4 elements a copy (stage4: async for fp32, widened for bf16); rows at or
// past `rows` (the keys past Tk) and columns past dh are zeros, so that p = 0
// there multiplies a finite value
template <int DHP, typename T>
__device__ __forceinline__ void stage_key_tile(float* s, const T* __restrict__ g, int rows,
                                               int dh) {
  constexpr int UNITS = DHP / 4, LD = DHP + MMA_PAD;
  for (int idx = threadIdx.x; idx < MMA_KEYS * UNITS; idx += MMA_WARPS * WARP) {
    const int r = idx / UNITS, c = 4 * (idx % UNITS);
    float* dst = s + r * LD + c;
    if (r < rows && c < dh) stage4(dst, g + (size_t)r * dh + c);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Bytes of dynamic shared memory of masked_attention_mma<_, DHP> at tk keys.
__host__ __device__ constexpr size_t mma_smem(int dhp, int tk) {
  return ((size_t)mma_stages(dhp) * 2 * MMA_KEYS * (dhp + MMA_PAD)
          + (mma_q_in_smem(dhp) ? (size_t)MMA_ROWS * (dhp + MMA_PAD) : 0)) * sizeof(float)
         + (size_t)((tk + MMA_KEYS - 1) / MMA_KEYS + 31) / 32 * sizeof(unsigned);
}

// grid (batch*heads, ceil(Tq / MMA_ROWS)), MMA_WARPS warps; dynamic shared
// memory mma_smem(DHP, tk): mma_stages(DHP) stages of a K and a V tile of
// MMA_KEYS rows, the block's Q rows where mma_q_in_smem(DHP), a bit per key
// tile.  dh % 4 == 0, 8 <= dh <= DHP, q, k, v 16-byte aligned, Tk <=
// MMA_MAX_KEYS.  skip: leave out the tiles whose keys are all masked, where
// the batch element has a visible key (0: every tile, the dense yardstick).
template <typename T, int DHP>
__global__ void __launch_bounds__(MMA_WARPS * WARP)
masked_attention_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ key_mask,  // (B, Tk) or null
                     float* __restrict__ out, int heads, int tq, int tk, int dh,
                     float sm_scale, int skip) {
  constexpr int KS = DHP / 8;              // k-steps of q k^T = n-tiles of p v
  constexpr int NT = MMA_KEYS / 8;         // n-tiles of q k^T = k-steps of p v
  constexpr int LD = DHP + MMA_PAD;        // floats of a staged row
  constexpr int TILE = MMA_KEYS * LD;      // floats of a staged K or V tile
  constexpr int STAGES = mma_stages(DHP);
  constexpr bool Q_SMEM = mma_q_in_smem(DHP);
  extern __shared__ float4 smem_mma[];
  float* ring = reinterpret_cast<float*>(smem_mma);
  float* qs = ring + STAGES * 2 * TILE;    // Q_SMEM: the block's query rows
  unsigned* live = reinterpret_cast<unsigned*>(qs + (Q_SMEM ? MMA_ROWS * LD : 0));

  const int bh = blockIdx.x, b = bh / heads;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = blockIdx.y * MMA_ROWS + warp * 16;   // the warp's first query row
  const T* qh = q + (size_t)bh * tq * dh;
  const T* kh = k + (size_t)bh * tk * dh;
  const T* vh = v + (size_t)bh * tk * dh;
  const uint8_t* mask_row = key_mask == nullptr ? nullptr : key_mask + (size_t)b * tk;
  const int ntiles = (tk + MMA_KEYS - 1) / MMA_KEYS;
  const float scale2 = sm_scale * LOG2E;   // scores become base-2 logits

  // Q, scaled and split into TF32 hi and lo once (in registers), or staged
  // scaled (Q_SMEM, split at each use); rows past Tq and columns past dh are
  // zeros.  Its loads are in flight during the mask scan.
  uint32_t q_hi[Q_SMEM ? 1 : KS][4], q_lo[Q_SMEM ? 1 : KS][4];
  float* qw = qs + warp * 16 * LD;
  if constexpr (Q_SMEM) {
    for (int idx = lane; idx < 16 * (DHP / 4); idx += WARP) {
      const int r = idx / (DHP / 4), c = 4 * (idx % (DHP / 4));
      const float4 x = load4(qh + (size_t)(r0 + r) * dh + c, r0 + r < tq ? dh - c : 0, true);
      *reinterpret_cast<float4*>(qw + r * LD + c) =
          make_float4(x.x * scale2, x.y * scale2, x.z * scale2, x.w * scale2);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e & 1) * 8, col = ks * 8 + tg + (e >> 1) * 4;
        const float x = row < tq && col < dh ? to_f(qh[(size_t)row * dh + col]) * scale2 : 0.f;
        split_tf32(x, q_hi[ks][e], q_lo[ks][e]);
      }
  }
  auto q_frag = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    if constexpr (Q_SMEM) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(qw[(g + (e & 1) * 8) * LD + ks * 8 + tg + (e >> 1) * 4], hi[e], lo[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = q_hi[ks][e];
        lo[e] = q_lo[ks][e];
      }
    }
  };

  // which tiles hold a visible key, a bit a tile: warp w ballots the tiles
  // of words w, w + MMA_WARPS, ... (every load of 8 tiles first); the tiles
  // are skipped only where the element has a visible key
  bool skip_dead = false;
  if (skip && mask_row != nullptr) {
    int any = 0;
    for (int w = warp; w * WARP < ntiles; w += MMA_WARPS) {
      unsigned word = 0u;
      for (int c0 = 0; c0 < WARP && (w * WARP + c0) < ntiles; c0 += 8) {
        bool visible[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int key = (w * WARP + c0 + c) * MMA_KEYS + lane;
          visible[c] = key < tk && mask_row[key];
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (__ballot_sync(FULL, visible[c]) != 0u) word |= 1u << (c0 + c);
      }
      if (lane == 0) live[w] = word;
      any |= word != 0u;
    }
    skip_dead = __syncthreads_or(any) != 0;
  }
  // the first tile to walk at or after kt (ntiles: none left); the same
  // answer in every thread
  auto next_tile = [&](int kt) {
    if (!skip_dead) return kt;
    for (int w = kt / WARP; w * WARP < ntiles; ++w) {
      const unsigned word = live[w] & (w == kt / WARP ? ~0u << (kt % WARP) : ~0u);
      if (word != 0u) return w * WARP + __ffs(word) - 1;
    }
    return ntiles;
  };

  // the ring: the i-th walked tile goes to stage i % STAGES; a commit group
  // a tile, empty past the last, so that wait<STAGES - 2> means "tile i
  // has landed"
  int next_kt = next_tile(0), issued = 0;
  auto issue = [&]() {
    if (next_kt < ntiles) {
      float* stage = ring + (issued % STAGES) * 2 * TILE;
      const int key0 = next_kt * MMA_KEYS, rows = min(MMA_KEYS, tk - key0);
      stage_key_tile<DHP>(stage, kh + (size_t)key0 * dh, rows, dh);
      stage_key_tile<DHP>(stage + TILE, vh + (size_t)key0 * dh, rows, dh);
      next_kt = next_tile(next_kt + 1);
      ++issued;
    }
    bf16tc::commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g and g + 8
  float acc[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ks][e] = 0.f;

  for (int i = 0, kt = next_tile(0); kt < ntiles; ++i, kt = next_tile(kt + 1)) {
    bf16tc::wait<STAGES - 2>();   // tile i has landed (this thread's copies)
    __syncthreads();              // everyone's; tile i - 1's stage is free
    issue();
    if (r0 >= tq) continue;       // warp-uniform: a warp past the last row
    const float* ks_tile = ring + (i % STAGES) * 2 * TILE;
    const float* vs_tile = ks_tile + TILE;
    const int key0 = kt * MMA_KEYS;
    // the bias of this thread's keys key0 + 8 nt + 2 tg + j: 0 visible,
    // NEG_INF masked, -inf past Tk (p exactly 0 even where every key of
    // the element is masked); loaded before the products
    float bias[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = key0 + nt * 8 + 2 * tg + j;
        bias[nt][j] = key >= tk ? -INFINITY
                      : (mask_row == nullptr || mask_row[key]) ? 0.f : NEG_INF;
      }

    // S = Q K^T: the hi hi terms chain KS MMAs from zero, the cross terms
    // apart; summed in fp32
    float s[NT][4], s_small[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s_small[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float b0[NT], b1[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kp = ks_tile + (nt * 8 + g) * LD + ks * 8 + tg;
        b0[nt] = kp[0];
        b1[nt] = kp[4];
      }
      uint32_t a_hi[4], a_lo[4];
      q_frag(ks, a_hi, a_lo);
      mma_3xtf32<NT>(s, s_small, a_hi, a_lo, b0, b1);
    }

    // the online softmax in base 2: the row max over the quad by shuffles,
    // one ex2 a score, this thread's share of the row sum
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows g and g + 8
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = (s[nt][e] + s_small[nt][e]) + bias[nt][e & 1];
          mx = fmaxf(mx, s[nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = bf16tc::ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = bf16tc::ex2(s[nt][e] - m_new);
          l[h] += s[nt][e];
        }
    }

    // O = alpha O + P V, the tile's P V summed from zero (chains of NT hi hi
    // MMAs) at most 4 output n-tiles a pass.  The A operand's columns t,
    // t + 4 are taken as the keys 2t, 2t + 1 this thread holds, and V's
    // rows are read in that order: no shuffle.
    constexpr int KG = KS < 4 ? KS : 4;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += KG) {
      float part[KG][4], small[KG][4];
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[kg][e] = small[kg][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t p_hi[4], p_lo[4];
        split_tf32(s[nt][0], p_hi[0], p_lo[0]);
        split_tf32(s[nt][2], p_hi[1], p_lo[1]);
        split_tf32(s[nt][1], p_hi[2], p_lo[2]);
        split_tf32(s[nt][3], p_hi[3], p_lo[3]);
        const float* vp = vs_tile + (nt * 8 + 2 * tg) * LD + g;
        float b0[KG], b1[KG];
#pragma unroll
        for (int kg = 0; kg < KG; ++kg) {
          b0[kg] = vp[(k0 + kg) * 8];
          b1[kg] = vp[LD + (k0 + kg) * 8];
        }
        mma_3xtf32<KG>(part, small, p_hi, p_lo, b0, b1);
      }
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[k0 + kg][e] = fmaf(acc[k0 + kg][e], alpha[e >> 1], part[kg][e] + small[kg][e]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = l[h] + __shfl_xor_sync(FULL, l[h], 1);   // the quad's shares
    l[h] = sum + __shfl_xor_sync(FULL, sum, 2);
    const int row = r0 + g + 8 * h;
    if (row < tq) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      float* orow = out + ((size_t)bh * tq + row) * dh;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int col = ks * 8 + 2 * tg;   // dh % 4 == 0: col < dh covers col + 1
        if (col < dh)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[ks][2 * h] * inv, acc[ks][2 * h + 1] * inv);
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

template <typename T, int KPL, int SLOTS, bool SKIP>
cudaError_t launch_resident_instance(const ResidentLaunch& r, const T* q, const T* k,
                                     const T* v, const uint8_t* key_mask, float* out,
                                     int bh, int heads, int tq, int tk, int dh,
                                     float sm_scale, cudaStream_t stream) {
  if (r.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(masked_attention_resident<T, KPL, SLOTS, SKIP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)r.smem);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int vec = dh % 4 == 0 && bits % 16 == 0;
  masked_attention_resident<T, KPL, SLOTS, SKIP>
      <<<dim3(bh, r.nsplit), r.nwarps * WARP, r.smem, stream>>>(
          q, k, v, key_mask, out, heads, tq, tk, dh, r.rows_per_block, sm_scale, vec);
  return cudaGetLastError();
}

// the skipping instance where a mask can leave a key tile dead (a mask, and
// more than one tile: one tile is always needed), else the dense one
template <typename T, int KPL, int SLOTS>
cudaError_t launch_resident(const ResidentLaunch& r, const T* q, const T* k,
                            const T* v, const uint8_t* key_mask, float* out,
                            int bh, int heads, int tq, int tk, int dh,
                            float sm_scale, int skip, cudaStream_t stream) {
  if (KPL > 1 && skip && key_mask != nullptr)
    return launch_resident_instance<T, KPL, SLOTS, KPL != 1>(r, q, k, v, key_mask, out, bh,
                                                              heads, tq, tk, dh, sm_scale,
                                                              stream);
  return launch_resident_instance<T, KPL, SLOTS, false>(r, q, k, v, key_mask, out, bh, heads,
                                                        tq, tk, dh, sm_scale, stream);
}

template <typename T>
cudaError_t launch_chunked(const T* q, const T* k, const T* v,
                           const uint8_t* key_mask, float* out, int bh, int heads,
                           int tq, int tk, int dh, float sm_scale, int skip,
                           cudaStream_t stream) {
  const size_t smem = ((size_t)KV_CHUNK * (2 * dh + 1) + (size_t)CHUNK_ROWS * dh + KV_CHUNK)
                      * sizeof(float);
  dim3 grid(bh, (tq + CHUNK_ROWS - 1) / CHUNK_ROWS);
  masked_attention_chunked<T><<<grid, CHUNK_ROWS * WARP, smem, stream>>>(
      q, k, v, key_mask, out, heads, tq, tk, dh, sm_scale, skip);
  return cudaGetLastError();
}

// whether masked_attention_mma takes the shape: Dh a multiple of 4 from 8
// to MAX_DH, 16-byte aligned q, k, v, Tk within its live-tile bits and
// Tq within 65,535 blocks of MMA_ROWS rows
bool mma_takes(const void* q, const void* k, const void* v, int tq, int tk, int dh) {
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  return dh % 4 == 0 && dh >= 8 && dh <= MAX_DH && bits % 16 == 0 && tk <= MMA_MAX_KEYS
         && (tq + MMA_ROWS - 1) / MMA_ROWS <= 65535;
}

// The resident -> mma crossover, on the shape (H100 A/B, kernel_variants.py
// long_keys, in turns): where both kernels take a head, the tensor-core
// kernel from 17 query rows and 17 keys (CUB's caption encoders 1.9-2.8x,
// VILANRO's action encoder 1.59x, the flagship's text 1.13x, Enc_VIT
// 1.04x); SPRITES' 16 x 16 heads, which would leave 3 of its block's 4
// warps without rows, stay resident (0.247 against 0.599 ms).
bool mma_over_resident(int tq, int tk) { return tq > 16 && tk > 16; }

// the padded head width of the instance that takes dh
int mma_dhp(int dh) { return dh <= 8 ? 8 : dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }

template <typename T, int DHP>
cudaError_t launch_mma_dhp(const T* q, const T* k, const T* v, const uint8_t* key_mask,
                           float* out, int bh, int heads, int tq, int tk, int dh,
                           float sm_scale, int skip, cudaStream_t stream) {
  const size_t smem = mma_smem(DHP, tk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(masked_attention_mma<T, DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  masked_attention_mma<T, DHP>
      <<<dim3(bh, (tq + MMA_ROWS - 1) / MMA_ROWS), MMA_WARPS * WARP, smem, stream>>>(
          q, k, v, key_mask, out, heads, tq, tk, dh, sm_scale, skip);
  return cudaGetLastError();
}

// where mma_takes the shape
template <typename T>
cudaError_t launch_mma(const T* q, const T* k, const T* v, const uint8_t* key_mask, float* out,
                       int bh, int heads, int tq, int tk, int dh, float sm_scale, int skip,
                       cudaStream_t s) {
#define LAUNCH(DHP) \
  launch_mma_dhp<T, DHP>(q, k, v, key_mask, out, bh, heads, tq, tk, dh, sm_scale, skip, s)
  const int dhp = mma_dhp(dh);
  return dhp == 8 ? LAUNCH(8) : dhp == 16 ? LAUNCH(16) : dhp == 32 ? LAUNCH(32)
         : dhp == 64 ? LAUNCH(64) : LAUNCH(128);
#undef LAUNCH
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

// the few-keys kernel's crossovers (H100 A/Bs: kernel_variants.py few_keys
// and few_keys_bf16): on fp32 (and bf16 that neither bf16 kernel takes)
// every head of at most FEW_MAX_KEYS keys, SPRITES' 8 x 8 axial heads among
// them; on bf16, ahead of the tensor-core kernel, one key under more query
// rows (the decoders' cross-attention to a latent; at 5 keys the
// tensor-core kernel wins)
bool few_keys_takes(int tk) { return tk <= FEW_MAX_KEYS; }

bool few_keys_takes_bf16(int tq, int tk) { return tk == 1 && tq > 1; }

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

// The resident kernel at the plan r (r.fits), its instance by keys a lane
// and head width.
template <typename T>
cudaError_t launch_resident_plan(const ResidentLaunch& r, const T* q, const T* k, const T* v,
                                 const uint8_t* mask, float* out, int bh, int heads, int tq,
                                 int tk, int dh, float sm_scale, int skip, cudaStream_t s) {
#define LAUNCH(KPL)                                                                  \
  (dh <= WARP ? launch_resident<T, KPL, 1>(r, q, k, v, mask, out, bh, heads, tq, tk, dh, \
                                           sm_scale, skip, s)                       \
              : launch_resident<T, KPL, DH_SLOTS>(r, q, k, v, mask, out, bh, heads, tq, \
                                                  tk, dh, sm_scale, skip, s))
  return r.kpl == 1 ? LAUNCH(1) : r.kpl == 2 ? LAUNCH(2) : r.kpl == 4 ? LAUNCH(4) : LAUNCH(8);
#undef LAUNCH
}

// The route past the few-keys kernel: the fp32 tensor-core kernel where it
// takes the shape and the resident kernel cannot hold the head or loses to
// it (mma_over_resident), else the resident kernel where the head fits it,
// else the chunked one; writes which to *variant (5 mma, 0 resident, 1
// chunked) and launches on `stream`.  skip: leave out the all-masked key
// tiles (0: the dense yardstick).  The plan follows the call's shape, never
// its mask: the host reads no mask.
template <typename T>
cudaError_t route_past_few_keys(const T* q, const T* k, const T* v, const uint8_t* mask,
                                float* out, int batch, int heads, int tq, int tk, int dh,
                                float sm_scale, cudaStream_t s, int* variant, int skip = 1) {
  const int bh = batch * heads;
  const ResidentLaunch r = plan_resident(bh, tq, tk, dh);
  if (mma_takes(q, k, v, tq, tk, dh) && (!r.fits || mma_over_resident(tq, tk))) {
    *variant = MMA;
    return launch_mma<T>(q, k, v, mask, out, bh, heads, tq, tk, dh, sm_scale, skip, s);
  }
  if (!r.fits) {
    *variant = CHUNKED;
    return launch_chunked<T>(q, k, v, mask, out, bh, heads, tq, tk, dh, sm_scale, skip, s);
  }
  *variant = RESIDENT;
  return launch_resident_plan<T>(r, q, k, v, mask, out, bh, heads, tq, tk, dh, sm_scale, skip,
                                 s);
}

// The fp32 route, and the bf16 launcher's where neither bf16 kernel takes
// the shape: the few-keys kernel (*variant 3), else route_past_few_keys.
template <typename T>
cudaError_t forward(const T* q, const T* k, const T* v, const uint8_t* mask, float* out,
                    int batch, int heads, int tq, int tk, int dh, float sm_scale,
                    cudaStream_t s, int* variant) {
  if (few_keys_takes(tk)) {
    *variant = FEW_KEYS;
    return launch_few_keys<T>(q, k, v, mask, out, batch * heads, heads, tq, tk, dh, sm_scale,
                              s);
  }
  return route_past_few_keys<T>(q, k, v, mask, out, batch, heads, tq, tk, dh, sm_scale, s,
                                variant);
}

}  // namespace

extern "C" {

// q: (B*H, Tq, Dh), k/v: (B*H, Tk, Dh) contiguous fp32 (masked_attention_forward)
// or bf16 (masked_attention_forward_bf16) on the device; out: (B*H, Tq, Dh)
// contiguous fp32; key_mask: (B, Tk) bool (1 byte) or null.  1 <= Dh <= 128.
// Picks the path by shape, writes which one to *variant (0 resident, 1
// chunked, 2 the bf16 tensor-core kernel, 3 few keys, 4 short bf16, 5 the
// fp32 tensor-core kernel), launches on `stream` and returns
// cudaGetLastError().
int masked_attention_forward(const void* q, const void* k, const void* v,
                             const void* key_mask, void* out, int batch,
                             int heads, int tq, int tk, int dh,
                             float sm_scale, void* stream, int* variant) {
  return (int)forward((const float*)q, (const float*)k, (const float*)v,
                      (const uint8_t*)key_mask, (float*)out, batch, heads, tq, tk, dh,
                      sm_scale, (cudaStream_t)stream, variant);
}

// The bf16 launcher: the few-keys kernel where few_keys_takes_bf16 the
// shape (*variant 3), the tensor-core kernel where tc_takes it (2), the
// short kernel where short_takes it (4), else the fp32 route on bf16
// inputs, widened as they are loaded (3, 0, 5 or 1).
int masked_attention_forward_bf16(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* out, int batch,
                                  int heads, int tq, int tk, int dh,
                                  float sm_scale, void* stream, int* variant) {
  const __nv_bfloat16 *qb = (const __nv_bfloat16*)q, *kb = (const __nv_bfloat16*)k,
                      *vb = (const __nv_bfloat16*)v;
  if (few_keys_takes_bf16(tq, tk)) {
    *variant = FEW_KEYS;
    return (int)launch_few_keys(qb, kb, vb, (const uint8_t*)key_mask, (float*)out,
                                batch * heads, heads, tq, tk, dh, sm_scale,
                                (cudaStream_t)stream);
  }
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
// arguments of masked_attention_forward less `variant`): the route past the
// few-keys kernel (resident, mma or chunked) whatever the shape, on fp32
// (the route before the few-keys kernel) and on bf16 (the widening path,
// before the short and few-keys kernels); the bf16 tensor-core kernel
// wherever it fits (tc_fits; else cudaErrorInvalidValue), under
// TC_MIN_SIDE too.  The few-keys kernel's yardstick follows them.
int masked_attention_forward_resident(const void* q, const void* k, const void* v,
                                      const void* key_mask, void* out, int batch, int heads,
                                      int tq, int tk, int dh, float sm_scale, void* stream) {
  int variant;
  return (int)route_past_few_keys((const float*)q, (const float*)k, (const float*)v,
                                  (const uint8_t*)key_mask, (float*)out, batch, heads, tq, tk,
                                  dh, sm_scale, (cudaStream_t)stream, &variant);
}

int masked_attention_forward_bf16_widened(const void* q, const void* k, const void* v,
                                          const void* key_mask, void* out, int batch,
                                          int heads, int tq, int tk, int dh,
                                          float sm_scale, void* stream) {
  int variant;
  return (int)route_past_few_keys((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
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
// cudaErrorInvalidValue), on fp32 and on bf16: the other side of its
// crossovers.
int masked_attention_forward_few_keys(const void* q, const void* k, const void* v,
                                      const void* key_mask, void* out, int batch, int heads,
                                      int tq, int tk, int dh, float sm_scale, void* stream) {
  if (tk > FEW_MAX_KEYS) return (int)cudaErrorInvalidValue;
  return (int)launch_few_keys((const float*)q, (const float*)k, (const float*)v,
                              (const uint8_t*)key_mask, (float*)out, batch * heads, heads, tq,
                              tk, dh, sm_scale, (cudaStream_t)stream);
}

int masked_attention_forward_bf16_few_keys(const void* q, const void* k, const void* v,
                                           const void* key_mask, void* out, int batch,
                                           int heads, int tq, int tk, int dh, float sm_scale,
                                           void* stream) {
  if (tk > FEW_MAX_KEYS) return (int)cudaErrorInvalidValue;
  return (int)launch_few_keys((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                              (const __nv_bfloat16*)v, (const uint8_t*)key_mask, (float*)out,
                              batch * heads, heads, tq, tk, dh, sm_scale, (cudaStream_t)stream);
}

// The resident, mma or chunked kernel as the fp32 launcher would pick it
// among them, with no key tile skipped: the dense design, the yardstick
// the tile skipping is measured and held bit for bit against.
int masked_attention_forward_dense(const void* q, const void* k, const void* v,
                                   const void* key_mask, void* out, int batch, int heads,
                                   int tq, int tk, int dh, float sm_scale, void* stream) {
  int variant;
  return (int)route_past_few_keys((const float*)q, (const float*)k, (const float*)v,
                                  (const uint8_t*)key_mask, (float*)out, batch, heads, tq, tk,
                                  dh, sm_scale, (cudaStream_t)stream, &variant, 0);
}

// The chunked kernel whatever the shape: a yardstick for the resident and
// mma paths at the shapes the launcher gives to them.  The port's wrapper
// never calls it.
int masked_attention_forward_chunked(const void* q, const void* k, const void* v,
                                     const void* key_mask, void* out, int batch,
                                     int heads, int tq, int tk, int dh,
                                     float sm_scale, void* stream) {
  return (int)launch_chunked<float>((const float*)q, (const float*)k, (const float*)v,
                                    (const uint8_t*)key_mask, (float*)out, batch * heads,
                                    heads, tq, tk, dh, sm_scale, 1, (cudaStream_t)stream);
}

// The two sides of the resident -> mma crossover, which the port's wrapper
// never calls: the fp32 tensor-core kernel wherever it takes the shape
// (mma_takes), and the resident kernel wherever it holds the head
// (plan_resident), each skipping the all-masked key tiles; else
// cudaErrorInvalidValue.
int masked_attention_forward_resident_only(const void* q, const void* k, const void* v,
                                           const void* key_mask, void* out, int batch,
                                           int heads, int tq, int tk, int dh, float sm_scale,
                                           void* stream) {
  const ResidentLaunch r = plan_resident(batch * heads, tq, tk, dh);
  if (!r.fits) return (int)cudaErrorInvalidValue;
  return (int)launch_resident_plan(r, (const float*)q, (const float*)k, (const float*)v,
                                   (const uint8_t*)key_mask, (float*)out, batch * heads, heads,
                                   tq, tk, dh, sm_scale, 1, (cudaStream_t)stream);
}

int masked_attention_forward_mma(const void* q, const void* k, const void* v,
                                 const void* key_mask, void* out, int batch, int heads,
                                 int tq, int tk, int dh, float sm_scale, void* stream) {
  if (!mma_takes(q, k, v, tq, tk, dh)) return (int)cudaErrorInvalidValue;
  return (int)launch_mma((const float*)q, (const float*)k, (const float*)v,
                         (const uint8_t*)key_mask, (float*)out, batch * heads, heads, tq, tk,
                         dh, sm_scale, 1, (cudaStream_t)stream);
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
  // the route the launcher takes, in its order
  const bool tc = bf16 && tc_takes(aligned, aligned, aligned, tq, tk, dh);
  const bool shrt = bf16 && !tc && short_takes(aligned, aligned, aligned, tq, tk, dh);
  const bool few = bf16 ? few_keys_takes_bf16(tq, tk) || (!tc && !shrt && few_keys_takes(tk))
                        : few_keys_takes(tk);
  if (!resident && few) {
    const int lpr = few_keys_lanes(dh);
    int per_sm;
    cudaError_t err = bf16 ? few_keys_per_sm_of<__nv_bfloat16>(lpr, tk, &per_sm)
                           : few_keys_per_sm_of<float>(lpr, tk, &per_sm);
    if (err != cudaSuccess) return (int)err;
    grid = dim3(few_keys_blocks((long long)bh * tq, lpr, per_sm));
    threads = FEW_THREADS;
  } else if (!resident && tc) {
    const int ntiles = (tk + bf16tc::KEYS - 1) / bf16tc::KEYS;
    const int dhp = dh <= 16 ? 16 : dh <= 32 ? 32 : 64;
    grid = dim3(bh, (tq + TC_ROWS - 1) / TC_ROWS);
    threads = TC_WARPS * WARP;
    smem = (size_t)TC_STAGES * 2 * bf16tc::KEYS * bf16tc::row_stride(dhp)
               * sizeof(__nv_bfloat16)
           + (size_t)ntiles * (bf16tc::KEYS * sizeof(float) + 2 * sizeof(int));
  } else if (!resident && shrt) {
    grid = dim3((bh + SHORT_WARPS - 1) / SHORT_WARPS);
    threads = SHORT_WARPS * WARP;
    smem = short_smem(tq, tk, dh);
  } else {
    const ResidentLaunch r = plan_resident(bh, tq, tk, dh);
    if (!resident && mma_takes(aligned, aligned, aligned, tq, tk, dh)
        && (!r.fits || mma_over_resident(tq, tk))) {
      grid = dim3(bh, (tq + MMA_ROWS - 1) / MMA_ROWS);
      threads = MMA_WARPS * WARP;
      smem = mma_smem(mma_dhp(dh), tk);
    } else {
      grid = dim3(bh, r.fits ? r.nsplit : (tq + CHUNK_ROWS - 1) / CHUNK_ROWS);
      threads = r.fits ? r.nwarps * WARP : CHUNK_ROWS * WARP;
      smem = r.fits ? r.smem : 0;
    }
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

// Flash attention over a whole sequence (ViT's and DINOv2's global attention,
// `use_flash`), forward and backward, for Hopper (sm_90a):
//
//   o = softmax(sm_scale · q·kᵀ) · v       per (image, head), keys < N only
//
// Replace: the TPU flash-attention op that hvt/models/vit.py `_attend_flash`
// (line 50) calls, jax/experimental/pallas/ops/tpu/flash_attention.py: the
// forward (the pallas_call at line 758), dK/dV (line 1121) and dQ (line
// 1456). Contract, as hvt calls it: s = q·kᵀ from bf16 operands summed in f32,
// times sm_scale; keys at or past the real N get no weight (hvt pads N to 128
// with segment ids; here the kernels mask instead, so there is no padded
// copy); an online softmax in f32; the unnormalised p rounded to v's dtype
// before p·v (flash_attention.py:471), summed in f32; o in q's dtype; the
// row log-sum-exp kept for the backward. The backward takes D = rowsum(dO∘O)
// in f32 from the caller, as jax computes it outside its kernels
// (flash_attention.py:274), recomputes P from the saved log-sum-exp, and
// rounds P and dS·sm_scale to bf16 before their products, as jax's
// kernels do (lines 900, 918, 1258): no N x N tensor reaches device memory.
// f32 inputs enter the tensor cores rounded to bf16 (the TPU's default
// precision for an f32 product: the wrapper casts them once for the forward
// and dK/dV, the dQ kernel rounds them on its way in) and o, dq, dk, dv come
// out in f32. No atomics: a rerun gives the same bits.
//
// Layout: the forward and dK/dV read q, k and v straight from the packed
// (B, N, 3·D) qkv projection (D = heads·64) and dO from (B, N, D), through
// TMA tensor maps, and write o (B, N, D) and dk, dv into the packed
// (B, N, 3·D) gradient the same way; the dQ kernel takes (image, head, row)
// strides. The log-sum-exp and D are (B·H, N) f32.
//
// What bounds it on the H100 at ViT-B/16's shapes (N = 197, head dim 64):
// the bytes. One forward reads q, k, v and writes o, 8·N·64 bytes an (image,
// head), and does 4·N²·64 FLOP: about 100 FLOP a byte, a third of the card's
// ~295 FLOP/byte balance point for bf16 tensor cores.
//
// Forward and dK/dV (the Hopper design). A block is one warpgroup, two
// blocks an SM, so that one block's loads and softmax overlap the other's
// products. Its thread 0 issues every copy: 3-D TMA boxes of 64 columns (one
// head, 128 bytes) by up to 256 rows of one image, which land in the
// 128-byte swizzle `wgmma` reads; rows past N come back as zeros (TMA's
// out-of-bounds fill), never as the next image's rows; each copy completes
// an mbarrier that the warpgroup waits on. The "outer" operand (the forward's
// 64-row query tile, dK/dV's 64-row key and value tiles) is `wgmma`'s M; the
// "inner" side (keys, or dK/dV's queries) comes in tiles of W rows, W a
// multiple of 16 that the ragged end wastes little of (the plan below: 208
// at N = 197, two of 144 at N = 257). Where the inner side takes at most two
// tiles (N <= 320 forward, N <= 256 for dK/dV) they stay resident: one block
// takes a whole (image, head), loops over its outer tiles, and reads each
// operand of the head once from device memory; the next outer tile loads as
// soon as the products that read the current one retire. Longer sequences
// give a block one outer tile and stream the inner tiles through two
// stages; the blocks of one head are consecutive, so their re-reads of the
// head's inner tiles hit L2. Products: q·kᵀ, and dK/dV's k·qᵀ and v·dOᵀ,
// are m64nWk16 `wgmma`s from shared memory, both operands K-major; p·v,
// Pᵀ·dO and dSᵀ·q take A from registers (the accumulator's layout is the A
// fragments', so P and dS never touch shared memory) and read B MN-major
// (the transpose bit). With W <= 256 the forward's softmax over one tile is
// exact in registers; a second or later tile rescales the row as an online
// softmax. Outputs leave through a swizzled staging tile in shared memory
// by TMA stores, which clip at N. No producer warp or `setmaxnreg`: a
// one-warpgroup block has no other warpgroup to give registers to, and a
// copy costs its issuing thread a few instructions.
//
// dQ (a first, simple design, not yet redone for Hopper): blocks of four warps,
// blockIdx.x = image·H + head, blockIdx.y = a 64-row query tile; each warp
// owns 16 rows. The block loops over 64-row key tiles, double-buffered in
// shared memory by cp.async (zero-filled past N; f32 inputs rounded on the
// way in), 128-byte rows with their 16-byte chunks XOR-swizzled by row for
// ldmatrix, every product mma.sync.m16n8k16.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include "gemm_wgmma.cuh"

namespace hvt {
namespace flash {

constexpr int kD = 64;          // head dim
constexpr int kRows = 64;       // rows of a query or key tile (wgmma's M)
constexpr int kThreads = 128;   // one warpgroup, or dQ's four warps of 16 rows
constexpr int kTile = kRows * kD;  // bf16 elements of one 64-row tile (8 KB)

// ---------------------------------------------------------------------------
// The plan of the Hopper kernels (hvt_torch/ops/flash_attention.py
// `flash_plan` mirrors it, and chip_smoke.py holds the two equal).
// ---------------------------------------------------------------------------
constexpr int kMinInner = 64;         // narrowest inner tile
constexpr int kFwdResident = 256;     // one resident key tile up to this N
constexpr int kFwdStream = 160;       // widest key tile of two stages (two blocks an SM)
constexpr int kDkvChunk = 128;        // widest query chunk of dK/dV (registers)
constexpr int kStaging = 16384;       // one 64 x 64 f32 output tile
constexpr int kBars = 64;             // mbarriers

struct Plan {
  int inner, tiles, outer, blocks_per_head;  // inner tile rows, inner tiles, outer tiles
  int smem;                                  // dynamic shared memory, bytes
};

inline int round16(int x) { return (x + 15) / 16 * 16; }

// The fewest inner tiles of at most `most` rows that cover n, each of the
// same width, a multiple of 16 (at least kMinInner).
inline void inner_tiles(int n, int most, int& tiles, int& width) {
  tiles = (n + most - 1) / most;
  width = round16((n + tiles - 1) / tiles);
  if (width < kMinInner) width = kMinInner;
}

inline Plan fwd_plan(int n) {
  Plan p;
  inner_tiles(n, n <= kFwdResident ? kFwdResident : kFwdStream, p.tiles, p.inner);
  p.outer = (n + kRows - 1) / kRows;
  p.blocks_per_head = p.tiles <= 2 ? 1 : p.outer;
  const int stages = p.tiles < 2 ? 1 : 2;
  // 1024 to align, K and V a stage, the query tile, staging, barriers
  p.smem = 1024 + stages * 2 * p.inner * 128 + kRows * 128 + kStaging + kBars;
  return p;
}

inline Plan dkv_plan(int n) {
  Plan p;
  inner_tiles(n, kDkvChunk, p.tiles, p.inner);
  p.outer = (n + kRows - 1) / kRows;
  p.blocks_per_head = p.tiles <= 2 ? 1 : p.outer;
  const int stages = p.tiles < 2 ? 1 : 2;
  // 1024 to align, q and dO a stage, the key and value tiles, staging, lse
  // and D a stage, barriers
  p.smem = 1024 + stages * 2 * p.inner * 128 + 2 * kRows * 128 + kStaging +
           stages * p.inner * 8 + kBars;
  return p;
}

// ---------------------------------------------------------------------------
// TMA, mbarriers and the async proxy
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
// The one arrival of a phase, with the bytes its copies will bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// A box of `map` at (column, row, image) into dst, completing `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int image) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(image)
      : "memory");
}
// src into the box of `map` at (column, row, image); rows past the map's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col, int row,
                                          int image) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(image)
      : "memory");
}
__device__ __forceinline__ void tma_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The staging tile may be written again: every store has read it.
__device__ __forceinline__ void tma_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes of shared memory made visible to TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x with results below 2^-126 flushed to zero: the special-function
// unit's instruction alone, where exp2f adds a rescale for such results,
// which p and P (summed beside terms near 1 or larger) never need.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void zero_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The accumulator's 8-column groups 2kk and 2kk + 1 as the A fragments of K
// step kk (mma.sync's m16n8k16 layout, which is wgmma's A-from-registers
// layout), rounded to bf16.
template <int R>
__device__ __forceinline__ void acc_to_frags(uint32_t (&a)[R / 8][4], const float (&d)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16x2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The warpgroup's 64 x 64 f32 accumulator, row half h of each thread times
// s[h], into the staging tile in the swizzle of a 128-byte-wide TMA box: one
// 64-column bf16 box, or two 32-column f32 boxes 8 KB apart. Then the box
// (or both) out to `map` at (col, row, image). The caller has waited for the
// staging tile's previous store to be read (tma_wait_read, then a barrier).
__device__ __forceinline__ void store_tile(unsigned char* st, const CUtensorMap* map,
                                           const float (&d)[32], float s_lo, float s_hi, bool f32,
                                           int col, int row, int image) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (threadIdx.x >> 5) + g + 8 * h;
      const float s = h ? s_hi : s_lo, v0 = d[4 * j + 2 * h] * s, v1 = d[4 * j + 2 * h + 1] * s;
      if (f32) {
        const int chunk = 2 * (j & 3) + (t >> 1);
        *reinterpret_cast<float2*>(st + (j >> 2) * 8192 + r * 128 + ((chunk ^ (r & 7)) << 4) +
                                   ((t & 1) << 3)) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(st + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16x2(v0, v1);
      }
    }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store(map, st, col, row, image);
    if (f32) tma_store(map, st + 8192, col + 32, row, image);
    tma_commit();
  }
}

struct FwdArgs {
  int heads, n, tiles, outer, blocks_per_head, out_f32;
  float scale_log2;
};

// ---------------------------------------------------------------------------
// Forward: the outer tile is 64 queries, the inner tiles W keys (and their
// values). lse (natural log) of each row < n to lse[bh·n + row].
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,   // qkv, 64-row boxes
                     const __grid_constant__ CUtensorMap tkv,  // qkv, W-row boxes
                     const __grid_constant__ CUtensorMap to,   // o, 64-row boxes
                     float* __restrict__ lse, FwdArgs a) {
  constexpr int kKV = W * 128;  // bytes of one K or V tile
  unsigned char* const sm = wg_smem_base();
  const int stages = a.tiles < 2 ? 1 : 2;
  unsigned char* const sq = sm + stages * 2 * kKV;
  unsigned char* const st = sq + kRows * 128;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(st + kStaging);  // K/V stage 0, 1; q
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int blk = blockIdx.x, bh = blk / a.blocks_per_head, sub = blk - bh * a.blocks_per_head;
  const int bi = bh / a.heads, hi = bh - bi * a.heads, c = a.heads * kD;
  const int q_first = a.blocks_per_head == 1 ? 0 : sub;
  const int q_end = a.blocks_per_head == 1 ? a.outer : sub + 1;

  auto load_q = [&](int qt) {
    mbar_expect(&bars[2], kRows * 128);
    tma_load(sq, &tq, &bars[2], hi * kD, qt * kRows, bi);
  };
  auto load_kv = [&](int s, int j) {
    mbar_expect(&bars[s], 2 * kKV);
    tma_load(sm + s * 2 * kKV, &tkv, &bars[s], c + hi * kD, j * W, bi);
    tma_load(sm + s * 2 * kKV + kKV, &tkv, &bars[s], 2 * c + hi * kD, j * W, bi);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_q(q_first);
    for (int s = 0; s < stages; ++s) load_kv(s, s);
  }
  __syncthreads();

  const uint32_t q_addr = smem_u32(sq);
  for (int qt = q_first, qi = 0; qt < q_end; ++qt, ++qi) {
    mbar_wait(&bars[2], qi & 1);
    float o[32];
    zero_acc(o);
    // Running max (base 2, of sm_scale·log2(e)·q·k) and sum of this thread's two rows.
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    for (int j = 0; j < a.tiles; ++j) {
      const int s = j & 1;
      mbar_wait(&bars[s], (j >> 1) & 1);
      const uint32_t k_addr = smem_u32(sm + s * 2 * kKV), v_addr = k_addr + kKV;
      float sc[W / 2];
      zero_acc(sc);
      wg_fence_acc(sc);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        Wgmma<W>::mma(sc, wg_desc(q_addr + 32 * kk), wg_desc(k_addr + 32 * kk));
      wg_commit();
      wg_wait();
      wg_fence_acc(sc);
      if (j == a.tiles - 1 && qt + 1 < q_end) {
        __syncthreads();  // every warp's q·kᵀ has retired: the query tile is free
        if (tid == 0) load_q(qt + 1);
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < W / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * W + 8 * jj + 2 * t + (e & 1);
          float& x = sc[4 * jj + e];
          x = key < a.n ? x * a.scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        // A row with no key yet (never at tile 0, which holds key 0) keeps exp2 finite.
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_ftz(m_run[r] - m_use[r]);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        sc[i] = exp2_ftz(sc[i] - m_use[(i >> 1) & 1]);  // masked keys: exp2(-inf) = 0
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + quad_sum(sum[r]);
      uint32_t pa[W / 16][4];
      acc_to_frags<W / 2>(pa, sc);  // p rounded to bf16 (v's dtype) before p·v
      wg_fence_acc(o);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) wgmma64_rs_t(o, pa[kk], wg_desc(v_addr + 2048 * kk));
      wg_commit();
      wg_wait();
      wg_fence_acc(o);
      wg_fence_frag(pa);
      if (j + 2 < a.tiles) {
        __syncthreads();  // every warp's p·v has retired: stage s is free
        if (tid == 0) load_kv(s, j + 2);
      }
    }

    if (tid == 0) tma_wait_read();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qt * kRows + 16 * (tid >> 5) + (lane >> 2) + 8 * r;
        if (row < a.n)
          lse[(long long)bh * a.n + row] = (m_run[r] + log2f(l_run[r])) * 0.6931471805599453f;
      }
    }
    store_tile(st, &to, o, 1.f / l_run[0], 1.f / l_run[1], a.out_f32, hi * kD, qt * kRows, bi);
  }
  if (tid == 0) tma_wait_all();
}

struct DkvArgs {
  int heads, n, tiles, outer, blocks_per_head, out_f32;
  float scale_log2, sm_scale;
};

// ---------------------------------------------------------------------------
// dK, dV: the outer tile is 64 keys (their k and v), the inner chunks W
// queries (their q, dO, lse and D), with the transposed products (rows =
// keys): Pᵀ = exp(sᵀ − lse), dv = Pᵀ·dO, dSᵀ = Pᵀ ∘ (v·dOᵀ − D)·sm_scale,
// dk = dSᵀ·q.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tkv,  // qkv, 64-row boxes
                         const __grid_constant__ CUtensorMap tq,   // qkv, W-row boxes
                         const __grid_constant__ CUtensorMap tdo,  // dO, W-row boxes
                         const __grid_constant__ CUtensorMap tout,  // dqkv, 64-row boxes
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         DkvArgs a) {
  constexpr int kIn = W * 128;  // bytes of one q or dO chunk
  unsigned char* const sm = wg_smem_base();
  const int stages = a.tiles < 2 ? 1 : 2;
  unsigned char* const skv = sm + stages * 2 * kIn;
  unsigned char* const st = skv + 2 * kRows * 128;
  float* const rows = reinterpret_cast<float*>(st + kStaging);  // [stage][lse·log2(e) | D][W]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(rows + stages * 2 * W);  // stage 0, 1; k, v
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int blk = blockIdx.x, bh = blk / a.blocks_per_head, sub = blk - bh * a.blocks_per_head;
  const int bi = bh / a.heads, hi = bh - bi * a.heads, c = a.heads * kD;
  const int k_first = a.blocks_per_head == 1 ? 0 : sub;
  const int k_end = a.blocks_per_head == 1 ? a.outer : sub + 1;

  auto load_kv = [&](int kt) {
    mbar_expect(&bars[2], 2 * kRows * 128);
    tma_load(skv, &tkv, &bars[2], c + hi * kD, kt * kRows, bi);
    tma_load(skv + kRows * 128, &tkv, &bars[2], 2 * c + hi * kD, kt * kRows, bi);
  };
  auto load_chunk = [&](int s, int ch) {
    mbar_expect(&bars[s], 2 * kIn);
    tma_load(sm + s * 2 * kIn, &tq, &bars[s], hi * kD, ch * W, bi);
    tma_load(sm + s * 2 * kIn + kIn, &tdo, &bars[s], hi * kD, ch * W, bi);
  };
  // Query rows past n: zero q and dO (TMA's fill), and zero lse and D, so
  // that Pᵀ·dO and dSᵀ vanish there.
  auto load_rows = [&](int s, int ch) {
    for (int i = tid; i < W; i += kThreads) {
      const int row = ch * W + i;
      const long long at = (long long)bh * a.n + row;
      rows[s * 2 * W + i] = row < a.n ? lse[at] * kLog2e : 0.f;
      rows[s * 2 * W + W + i] = row < a.n ? delta[at] : 0.f;
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_kv(k_first);
    for (int s = 0; s < stages; ++s) load_chunk(s, s);
  }
  for (int s = 0; s < stages; ++s) load_rows(s, s);
  __syncthreads();

  const uint32_t k_addr = smem_u32(skv), v_addr = k_addr + kRows * 128;
  for (int kt = k_first, ki = 0; kt < k_end; ++kt, ++ki) {
    mbar_wait(&bars[2], ki & 1);
    float dv[32], dk[32];
    zero_acc(dv);
    zero_acc(dk);
    for (int ch = 0; ch < a.tiles; ++ch) {
      const int s = ch & 1;
      mbar_wait(&bars[s], (ch >> 1) & 1);
      const uint32_t q_addr = smem_u32(sm + s * 2 * kIn), do_addr = q_addr + kIn;
      const float* const lse2 = rows + s * 2 * W;
      const float* const drow = lse2 + W;
      float sc[W / 2], dp[W / 2];
      zero_acc(sc);
      zero_acc(dp);
      wg_fence_acc(sc);
      wg_fence_acc(dp);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // sᵀ: rows = keys, columns = queries
        Wgmma<W>::mma(sc, wg_desc(k_addr + 32 * kk), wg_desc(q_addr + 32 * kk));
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // (dO·vᵀ)ᵀ
        Wgmma<W>::mma(dp, wg_desc(v_addr + 32 * kk), wg_desc(do_addr + 32 * kk));
      wg_commit();
      wg_wait();
      wg_fence_acc(sc);
      wg_fence_acc(dp);
      if (ch == a.tiles - 1 && kt + 1 < k_end) {
        __syncthreads();  // every warp's k·qᵀ and v·dOᵀ have retired: k and v are free
        if (tid == 0) load_kv(kt + 1);
      }
#pragma unroll
      for (int jj = 0; jj < W / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + (e & 1), i = 4 * jj + e;
          sc[i] = exp2_ftz(sc[i] * a.scale_log2 - lse2[col]);
          dp[i] = sc[i] * ((dp[i] - drow[col]) * a.sm_scale);
        }
      uint32_t pa[W / 16][4], da[W / 16][4];
      acc_to_frags<W / 2>(pa, sc);  // Pᵀ rounded to bf16 (dO's dtype) before Pᵀ·dO
      acc_to_frags<W / 2>(da, dp);  // dSᵀ·sm_scale rounded to bf16 before dSᵀ·q
      wg_fence_acc(dv);
      wg_fence_acc(dk);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) wgmma64_rs_t(dv, pa[kk], wg_desc(do_addr + 2048 * kk));
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) wgmma64_rs_t(dk, da[kk], wg_desc(q_addr + 2048 * kk));
      wg_commit();
      wg_wait();
      wg_fence_acc(dv);
      wg_fence_acc(dk);
      wg_fence_frag(pa);
      wg_fence_frag(da);
      if (ch + 2 < a.tiles) {
        __syncthreads();  // every warp is done with stage s: its products and its rows
        if (tid == 0) load_chunk(s, ch + 2);
        load_rows(s, ch + 2);
        __syncthreads();
      }
    }
    if (tid == 0) tma_wait_read();
    __syncthreads();
    store_tile(st, &tout, dv, 1.f, 1.f, a.out_f32, 2 * c + hi * kD, kt * kRows, bi);
    if (tid == 0) tma_wait_read();
    __syncthreads();
    store_tile(st, &tout, dk, 1.f, 1.f, a.out_f32, c + hi * kD, kt * kRows, bi);
  }
  if (tid == 0) tma_wait_all();
}

// ---------------------------------------------------------------------------
// dQ: strided operands, cp.async tiles, mma.sync.
// ---------------------------------------------------------------------------
struct Layout {  // strides in elements of a (B, H, N, kD) operand
  long long b, h, n;
};

__device__ __forceinline__ long long row_at(const Layout& l, int bi, int hi, int row) {
  return (long long)bi * l.b + (long long)hi * l.h + (long long)row * l.n;
}

// Rows [row0, row0 + kRows) of one (image, head) of an operand into a
// swizzled bf16 tile, rows at or past n as zeros. bf16 rows by cp.async (the
// caller commits), f32 rows rounded to bf16 and stored.
template <typename T>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, const T* __restrict__ base,
                                          const Layout& l, int bi, int hi, int row0, int n) {
  for (int e = threadIdx.x; e < kRows * 8; e += kThreads) {
    const int r = e >> 3, ch = e & 7, row = row0 + r;
    const bool valid = row < n;
    const T* src = base + row_at(l, bi, hi, valid ? row : 0) + 8 * ch;
    bf16* d = dst + swz64(r, 8 * ch);
    if constexpr (sizeof(T) == 2) {
      cp_async16_zfill(d, src, valid);
    } else {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (valid) {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        u = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                       pack_bf16x2(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(d) = u;
    }
  }
}

// A fragments of rows [m0, m0 + 16) of a tile over the four 16-wide k-steps.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile, int m0, int lane) {
  const int row = m0 + (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], tile + swz64(row, 16 * kk + col));
}

// acc (16 x 64) += A (16 x kD) · tileᵀ: the tile's 64 rows are the product's
// columns (B n-major: q·kᵀ, dO·vᵀ).
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane) {
  const int row = (lane & 7) + (lane >> 4) * 8, col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tile + swz64(16 * np + row, 16 * kk + col));
      mma_bf16_16816(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 x kD) += A (16 x 64) · tile: the tile's rows are the reduction
// (B k-major, through ldmatrix.trans: dS·k).
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* tile, int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + swz64(16 * kk + row, 16 * np + col));
      mma_bf16_16816(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// Accumulators (16 x 64, f32) → bf16 A fragments of the next product: two
// adjacent 8-column n-tiles are one 16-wide k-step.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16x2(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16x2(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

// Rows [row0 + m0, +16) of a warp's (16 x kD) accumulators into rows < n of
// an operand.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ base, const Layout& l, int bi, int hi,
                                           int row0, int n, const float (&acc)[8][4], int m0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + m0 + g + 8 * half;
    if (row >= n) continue;
    T* dst = base + row_at(l, bi, hi, row) + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) store2(dst + 8 * nt, acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// One block per (image·head, 64-query tile), looping over key tiles:
//   P = exp(s − lse), dS = P ∘ (dO·vᵀ − D)·sm_scale, dq = dS·k.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Layout in,
    const T* __restrict__ dout, Layout ol, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int heads, int n, float scale_log2,
    float sm_scale) {
  __shared__ __align__(128) bf16 skv[2][2][kTile];  // [buffer][k, v]; q, dO first in buffer 1
  const int bh = blockIdx.x, bi = bh / heads, hi = bh - bi * heads;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, m0 = 16 * (threadIdx.x >> 5), t = lane & 3;
  const int tiles = (n + kRows - 1) / kRows;

  uint32_t qa[4][4], da[4][4], sa[4][4];
  load_tile(skv[1][0], q, in, bi, hi, q0, n);
  load_tile(skv[1][1], dout, ol, bi, hi, q0, n);
  load_tile(skv[0][0], k, in, bi, hi, 0, n);
  load_tile(skv[0][1], v, in, bi, hi, 0, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a(qa, skv[1][0], m0, lane);
  load_a(da, skv[1][1], m0, lane);
  __syncthreads();

  float lse2[2], d_row[2];  // rows past n: zero q and dO, so dS = 0 there
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + m0 + (lane >> 2) + 8 * r;
    const long long at = (long long)bh * n + row;
    lse2[r] = row < n ? lse[at] * kLog2e : 0.f;
    d_row[r] = row < n ? delta[at] : 0.f;
  }

  float dq_acc[8][4], s[8][4], dp[8][4];
  zero(dq_acc);
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) {
      load_tile(skv[buf ^ 1][0], k, in, bi, hi, (j + 1) * kRows, n);
      load_tile(skv[buf ^ 1][1], v, in, bi, hi, (j + 1) * kRows, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    zero(s);
    zero(dp);
    mma_abt(s, qa, skv[buf][0], lane);
    mma_abt(dp, da, skv[buf][1], lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kRows + 8 * nt + 2 * t + (e & 1);
        const float p = key < n ? exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - d_row[e >> 1]) * sm_scale;
      }
    to_a(sa, s);  // dS·sm_scale rounded to bf16 (k's dtype) before dS·k
    mma_ab(dq_acc, sa, skv[buf][0], lane);
    __syncthreads();
  }
  store_rows(dq, in, bi, hi, q0, n, dq_acc, m0, lane);
}

}  // namespace flash
}  // namespace hvt

namespace {

using hvt::flash::DkvArgs;
using hvt::flash::FwdArgs;
using hvt::flash::Layout;
using hvt::flash::Plan;

bool takes(int batch, int heads, int n, int d) {
  return d == hvt::flash::kD && n >= 1 && batch >= 1 && heads >= 1 &&
         (long long)batch * heads * ((n + hvt::flash::kRows - 1) / hvt::flash::kRows) <=
             0x7fffffffLL;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query, so that the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (images, rows, cols) row-major tensor of 2- or 4-byte elements in boxes
// of 128 bytes of one row's columns by box_rows rows of one image, in the
// 128-byte swizzle; rows past `rows` read as zeros and are not written.
bool tensor_map(CUtensorMap* map, const void* base, bool f32, long long images, long long rows,
                long long cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)images};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * elem), (cuuint64_t)(rows * cols * elem)};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

using FwdKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, float*, FwdArgs);
using DkvKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const float*,
                           const float*, DkvArgs);

// The instance of each kernel for an inner tile of w rows, or null.
FwdKernel fwd_kernel(int w) {
  switch (w) {
#define HVT_W(W) \
  case W:        \
    return hvt::flash::flash_fwd_kernel<W>;
    HVT_W(64) HVT_W(80) HVT_W(96) HVT_W(112) HVT_W(128) HVT_W(144) HVT_W(160) HVT_W(176)
    HVT_W(192) HVT_W(208) HVT_W(224) HVT_W(240) HVT_W(256)
#undef HVT_W
  }
  return nullptr;
}

DkvKernel dkv_kernel(int w) {
  switch (w) {
#define HVT_W(W) \
  case W:        \
    return hvt::flash::flash_bwd_dkv_kernel<W>;
    HVT_W(64) HVT_W(80) HVT_W(96) HVT_W(112) HVT_W(128)
#undef HVT_W
  }
  return nullptr;
}

}  // namespace

// The plan of the forward (out[0..4]: key tile rows, key tiles, query tiles,
// blocks an (image, head), dynamic shared memory) and of dK/dV (out[5..9]:
// query chunk rows, chunks, key tiles, blocks an (image, head), shared
// memory) at sequence length n.
extern "C" void hvt_flash_plan(int n, int* out) {
  const Plan f = hvt::flash::fwd_plan(n), b = hvt::flash::dkv_plan(n);
  const int v[10] = {f.inner, f.tiles, f.outer, f.blocks_per_head, f.smem,
                     b.inner, b.tiles, b.outer, b.blocks_per_head, b.smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// Blocks an SM of the forward's (out[0]) and dK/dV's (out[1]) instance at
// sequence length n with their plan's shared memory, as the occupancy
// calculator gives them (registers, shared memory, threads). Returns a
// cudaError_t.
extern "C" int hvt_flash_occupancy(int n, int* out) {
  const Plan f = hvt::flash::fwd_plan(n), b = hvt::flash::dkv_plan(n);
  const FwdKernel fk = fwd_kernel(f.inner);
  const DkvKernel bk = dkv_kernel(b.inner);
  int err = hvt::allow_smem(fk, (size_t)f.smem);
  if (!err) err = hvt::allow_smem(bk, (size_t)b.smem);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fk, hvt::flash::kThreads, f.smem);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], bk, hvt::flash::kThreads, b.smem);
  return err;
}

// qkv (B, N, 3·D) bf16, D = heads·64, 16-byte aligned; o (B, N, D) and lse
// (B·H, N) f32; o in f32 where out_f32, else bf16. d must be 64. Returns a
// cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int hvt_flash_attention_fwd(const void* qkv, void* o, float* lse, int batch, int heads,
                                       int n, int d, float sm_scale, int out_f32, void* stream) {
  if (!takes(batch, heads, n, d)) return -1;
  const Plan p = hvt::flash::fwd_plan(n);
  const long long c = (long long)heads * d;
  CUtensorMap tq, tkv, to;
  if (!tensor_map(&tq, qkv, false, batch, n, 3 * c, hvt::flash::kRows) ||
      !tensor_map(&tkv, qkv, false, batch, n, 3 * c, p.inner) ||
      !tensor_map(&to, o, out_f32 != 0, batch, n, c, hvt::flash::kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{heads, n, p.tiles, p.outer, p.blocks_per_head, out_f32,
                  sm_scale * hvt::kLog2e};
  const FwdKernel kernel = fwd_kernel(p.inner);
  const int err = hvt::allow_smem(kernel, (size_t)p.smem);
  if (err) return err;
  kernel<<<batch * heads * p.blocks_per_head, hvt::flash::kThreads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(tq, tkv, to, lse, a);
  return launched();
}

// dq of the forward above, through (image, head, row) strides in elements:
// q, k, v and dq (sb, sh, sn), dO (ob, oh, on); delta = rowsum(dO∘O) (B·H,
// N) f32; dtype 0 = bf16, 1 = f32 for every operand. Returns as the forward.
extern "C" int hvt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          long long sb, long long sh, long long sn,
                                          const void* dout, long long ob, long long oh,
                                          long long on, const float* lse, const float* delta,
                                          void* dq, int batch, int heads, int n, int d,
                                          float sm_scale, int dtype, void* stream) {
  if (!takes(batch, heads, n, d) || (long long)batch * heads > 0x7fffffffLL ||
      (n + hvt::flash::kRows - 1) / hvt::flash::kRows > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout in{sb, sh, sn}, ol{ob, oh, on};
  const dim3 grid((unsigned)batch * (unsigned)heads,
                  (unsigned)((n + hvt::flash::kRows - 1) / hvt::flash::kRows));
  const float scale_log2 = sm_scale * hvt::kLog2e;
  if (dtype == 0)
    hvt::flash::flash_bwd_dq_kernel<hvt::bf16><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const hvt::bf16*>(q), static_cast<const hvt::bf16*>(k),
        static_cast<const hvt::bf16*>(v), in, static_cast<const hvt::bf16*>(dout), ol, lse,
        delta, static_cast<hvt::bf16*>(dq), heads, n, scale_log2, sm_scale);
  else
    hvt::flash::flash_bwd_dq_kernel<float><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        in, static_cast<const float*>(dout), ol, lse, delta, static_cast<float*>(dq), heads, n,
        scale_log2, sm_scale);
  return launched();
}

// dk and dv of the forward above into the packed dqkv (B, N, 3·D), f32
// where out_f32, else bf16; qkv (B, N, 3·D) and dout (B, N, D) bf16, 16-byte
// aligned; lse, delta (B·H, N) f32. Returns as the forward.
extern "C" int hvt_flash_attention_bwd_dkv(const void* qkv, const void* dout, const float* lse,
                                           const float* delta, void* dqkv, int batch, int heads,
                                           int n, int d, float sm_scale, int out_f32,
                                           void* stream) {
  if (!takes(batch, heads, n, d)) return -1;
  const Plan p = hvt::flash::dkv_plan(n);
  const long long c = (long long)heads * d;
  CUtensorMap tkv, tq, tdo, tout;
  if (!tensor_map(&tkv, qkv, false, batch, n, 3 * c, hvt::flash::kRows) ||
      !tensor_map(&tq, qkv, false, batch, n, 3 * c, p.inner) ||
      !tensor_map(&tdo, dout, false, batch, n, c, p.inner) ||
      !tensor_map(&tout, dqkv, out_f32 != 0, batch, n, 3 * c, hvt::flash::kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const DkvArgs a{heads, n, p.tiles, p.outer, p.blocks_per_head, out_f32,
                  sm_scale * hvt::kLog2e, sm_scale};
  const DkvKernel kernel = dkv_kernel(p.inner);
  const int err = hvt::allow_smem(kernel, (size_t)p.smem);
  if (err) return err;
  kernel<<<batch * heads * p.blocks_per_head, hvt::flash::kThreads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(tkv, tq, tdo, tout, lse, delta, a);
  return launched();
}

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
// row log-sum-exp kept for the backward. The backward needs D =
// rowsum(dO∘O) in f32, which jax computes outside its kernels
// (flash_attention.py:274): here the dQ kernel forms it from O's and dO's
// own values for the query rows it owns and writes it once for dK/dV, which
// runs after it. Both recompute P from the saved log-sum-exp and round P and
// dS·sm_scale to bf16 before their products, as jax's kernels do (lines
// 900, 918, 1258): no N x N tensor reaches device memory. f32 inputs enter
// the tensor cores rounded to bf16 (the TPU's default precision for an f32
// product: the wrapper casts qkv and dO once) and o, dq, dk, dv come out in
// f32; D of f32 inputs sums their f32 values. No atomics, and D summed in a
// fixed order: a rerun gives the same bits.
//
// Layout: the kernels read q, k and v straight from the packed (B, N, 3·D)
// qkv projection (D = heads·64) and dO and O from (B, N, D), through TMA
// tensor maps, and write o (B, N, D) and dq, dk, dv into the packed
// (B, N, 3·D) gradient the same way. The log-sum-exp and D are (B·H, N) f32.
//
// What bounds it on the H100 at ViT-B/16's shapes (N = 197, head dim 64):
// the bytes. One forward reads q, k, v and writes o, 8·N·64 bytes an (image,
// head), and does 4·N²·64 FLOP: about 100 FLOP a byte, a third of the card's
// ~295 FLOP/byte balance point for bf16 tensor cores.
//
// The design, all three kernels. A block is one warpgroup, two blocks an SM,
// so that one block's loads and softmax overlap the other's products. Its
// thread 0 issues every copy: 3-D TMA boxes of 64 columns (one head, 128
// bytes) by up to 256 rows of one image, which land in the 128-byte swizzle
// `wgmma` reads; rows past N come back as zeros (TMA's out-of-bounds fill),
// never as the next image's rows; each copy completes an mbarrier that the
// warpgroup waits on. The "outer" operand (the forward's and dQ's 64-row
// query tile, dK/dV's 64-row key and value tiles) is `wgmma`'s M; the
// "inner" side (keys, or dK/dV's queries) comes in tiles of W rows, W a
// multiple of 16 that the ragged end wastes little of (the plan below: 208
// at N = 197, two of 144 at N = 257). Where the inner side takes at most two
// tiles (N <= 320 forward, N <= 256 for dK/dV and dQ) they stay resident:
// one block takes a whole (image, head), loops over its outer tiles, and
// reads each operand of the head once from device memory; the next outer
// tile loads as soon as the products that read the current one retire.
// Longer sequences give a block one outer tile and stream the inner tiles
// through two stages; the blocks of one head are consecutive, so their
// re-reads of the head's inner tiles hit L2. Products: q·kᵀ, dO·vᵀ, and
// dK/dV's k·qᵀ and v·dOᵀ, are m64nWk16 `wgmma`s from shared memory, both
// operands K-major; p·v, Pᵀ·dO, dSᵀ·q and dS·k take A from registers (the
// accumulator's layout is the A fragments', so P and dS never touch shared
// memory) and read B MN-major (the transpose bit). With W <= 256 the
// forward's softmax over one tile is exact in registers; a second or later
// tile rescales the row as an online softmax. dK/dV and dQ hold two f32
// W-wide products (s and dP) beside their sums, so their W is at most 128
// (registers). Outputs leave through a swizzled staging tile in shared
// memory by TMA stores, which clip at N. No producer warp or `setmaxnreg`: a
// one-warpgroup block has no other warpgroup to give registers to, and a
// copy costs its issuing thread a few instructions.
//
// D in the dQ kernel: before the first dS of a query tile, two threads a
// row each sum 32 of the row's 64 products dO·O in column order, each
// product rounded to f32 and added in turn (no fused multiply-add), and one
// shuffle adds the two halves; the result goes to shared memory for the
// tile's dS and, for rows < N, to the (B·H, N) buffer that dK/dV reads.
// bf16 O arrives by TMA beside the q and dO tiles and D reads both tiles
// from shared memory; f32 O and dO (the f32 route, whose products read
// their bf16 copies) are read for D from the original tensors by plain
// 16-byte loads, issued before the block waits for its tiles.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include "gemm_wgmma.cuh"

namespace hvt {
namespace flash {

constexpr int kD = 64;          // head dim
constexpr int kRows = 64;       // rows of a query or key tile (wgmma's M)
constexpr int kThreads = 128;   // one warpgroup

// ---------------------------------------------------------------------------
// The plan of the Hopper kernels (hvt_torch/ops/flash_attention.py
// `flash_plan` mirrors it, and chip_smoke.py holds the two equal).
// ---------------------------------------------------------------------------
constexpr int kMinInner = 64;         // narrowest inner tile
constexpr int kFwdResident = 256;     // one resident key tile up to this N
constexpr int kFwdStream = 160;       // widest key tile of two stages (two blocks an SM)
constexpr int kDkvChunk = 128;        // widest query chunk of dK/dV (registers)
constexpr int kDqTile = 128;          // widest key tile of dQ (registers)
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

inline Plan dq_plan(int n) {
  Plan p;
  inner_tiles(n, kDqTile, p.tiles, p.inner);
  p.outer = (n + kRows - 1) / kRows;
  p.blocks_per_head = p.tiles <= 2 ? 1 : p.outer;
  const int stages = p.tiles < 2 ? 1 : 2;
  // 1024 to align, K and V a stage, the q, dO and O tiles, staging, D of the
  // query tile, barriers
  p.smem = 1024 + stages * 2 * p.inner * 128 + 3 * kRows * 128 + kStaging + kRows * 4 + kBars;
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
// dQ, and D: the outer tile is 64 queries (their q, dO, O, lse), the inner
// tiles W keys (their k and v): D = rowsum(dO∘O), P = exp(s − lse) with
// keys >= n set to 0, dS = P ∘ (dO·vᵀ − D)·sm_scale, dq = dS·k.
// ---------------------------------------------------------------------------
struct DqArgs {
  int heads, n, tiles, outer, blocks_per_head, out_f32;
  float scale_log2, sm_scale;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// acc + Σ o_i·g_i over the 8 bf16 values of two 16-byte chunks, in order.
__device__ __forceinline__ float dot_chunk(float acc, uint4 o, uint4 g) {
  const uint32_t ow[4] = {o.x, o.y, o.z, o.w}, gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = __fadd_rn(acc, __fmul_rn(bf16_lo(ow[i]), bf16_lo(gw[i])));
    acc = __fadd_rn(acc, __fmul_rn(bf16_hi(ow[i]), bf16_hi(gw[i])));
  }
  return acc;
}

// Half h (columns 32h..32h + 31) of row r's Σ O·dO from the swizzled bf16
// tiles, in column order.
__device__ __forceinline__ float half_dot_tiles(const unsigned char* so, const unsigned char* sdo,
                                                int r, int h) {
  float acc = 0.f;
#pragma unroll
  for (int ch = 4 * h; ch < 4 * h + 4; ++ch) {
    const int at = r * 128 + ((ch ^ (r & 7)) << 4);
    acc = dot_chunk(acc, *reinterpret_cast<const uint4*>(so + at),
                    *reinterpret_cast<const uint4*>(sdo + at));
  }
  return acc;
}

// The same from 32 f32 values each of O and dO in device memory (16-byte aligned).
__device__ __forceinline__ float half_dot_f32(const float* __restrict__ o,
                                              const float* __restrict__ g) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(o) + i);
    const float4 b = __ldg(reinterpret_cast<const float4*>(g) + i);
    acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
    acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
    acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
    acc = __fadd_rn(acc, __fmul_rn(a.w, b.w));
  }
  return acc;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,    // qkv, 64-row boxes
                        const __grid_constant__ CUtensorMap tkv,   // qkv, W-row boxes
                        const __grid_constant__ CUtensorMap tdo,   // dO, 64-row boxes
                        const __grid_constant__ CUtensorMap to,    // bf16 o, 64-row boxes
                        const __grid_constant__ CUtensorMap tout,  // dqkv, 64-row boxes
                        const float* __restrict__ o32, const float* __restrict__ do32,
                        const float* __restrict__ lse, float* __restrict__ delta, DqArgs a) {
  constexpr int kKV = W * 128;  // bytes of one K or V tile
  unsigned char* const sm = wg_smem_base();
  const int stages = a.tiles < 2 ? 1 : 2;
  unsigned char* const sq = sm + stages * 2 * kKV;
  unsigned char* const sdo = sq + kRows * 128;
  unsigned char* const so = sdo + kRows * 128;
  unsigned char* const st = so + kRows * 128;
  float* const sd = reinterpret_cast<float*>(st + kStaging);  // D of the query tile's rows
  uint64_t* const bars = reinterpret_cast<uint64_t*>(sd + kRows);  // K/V stage 0, 1; q, dO, O
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int blk = blockIdx.x, bh = blk / a.blocks_per_head, sub = blk - bh * a.blocks_per_head;
  const int bi = bh / a.heads, hi = bh - bi * a.heads, c = a.heads * kD;
  const int q_first = a.blocks_per_head == 1 ? 0 : sub;
  const int q_end = a.blocks_per_head == 1 ? a.outer : sub + 1;
  const bool f32 = a.out_f32 != 0;

  auto load_q = [&](int qt) {
    mbar_expect(&bars[2], (f32 ? 2 : 3) * kRows * 128);
    tma_load(sq, &tq, &bars[2], hi * kD, qt * kRows, bi);
    tma_load(sdo, &tdo, &bars[2], hi * kD, qt * kRows, bi);
    if (!f32) tma_load(so, &to, &bars[2], hi * kD, qt * kRows, bi);
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

  const uint32_t q_addr = smem_u32(sq), do_addr = smem_u32(sdo);
  const int d_r = tid >> 1, d_h = tid & 1;  // the row and half of it this thread sums D over
  for (int qt = q_first, qi = 0; qt < q_end; ++qt, ++qi) {
    // Rows past n: zero q, dO and O (TMA's fill), zero lse and D, so dS = 0 there.
    float part = 0.f, lse2[2];
    const int d_row = qt * kRows + d_r;
    if (f32 && d_row < a.n) {
      const long long at = ((long long)bi * a.n + d_row) * c + hi * kD + 32 * d_h;
      part = half_dot_f32(o32 + at, do32 + at);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * kRows + 16 * (tid >> 5) + (lane >> 2) + 8 * r;
      lse2[r] = row < a.n ? lse[(long long)bh * a.n + row] * kLog2e : 0.f;
    }
    mbar_wait(&bars[2], qi & 1);
    if (!f32) part = half_dot_tiles(so, sdo, d_r, d_h);
    const float dsum = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if (d_h == 0) {
      sd[d_r] = dsum;
      if (d_row < a.n) delta[(long long)bh * a.n + d_row] = dsum;
    }
    __syncthreads();  // D of every row of the tile is in sd
    float drow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) drow[r] = sd[16 * (tid >> 5) + (lane >> 2) + 8 * r];

    float dq[32];
    zero_acc(dq);
    for (int j = 0; j < a.tiles; ++j) {
      const int s = j & 1;
      mbar_wait(&bars[s], (j >> 1) & 1);
      const uint32_t k_addr = smem_u32(sm + s * 2 * kKV), v_addr = k_addr + kKV;
      float sc[W / 2], dp[W / 2];
      zero_acc(sc);
      zero_acc(dp);
      wg_fence_acc(sc);
      wg_fence_acc(dp);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // s = q·kᵀ
        Wgmma<W>::mma(sc, wg_desc(q_addr + 32 * kk), wg_desc(k_addr + 32 * kk));
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // dP = dO·vᵀ
        Wgmma<W>::mma(dp, wg_desc(do_addr + 32 * kk), wg_desc(v_addr + 32 * kk));
      wg_commit();
      wg_wait();
      wg_fence_acc(sc);
      wg_fence_acc(dp);
      if (j == a.tiles - 1 && qt + 1 < q_end) {
        __syncthreads();  // every warp's q·kᵀ and dO·vᵀ have retired, D is read: the tiles are free
        if (tid == 0) load_q(qt + 1);
      }
#pragma unroll
      for (int jj = 0; jj < W / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * W + 8 * jj + 2 * t + (e & 1), i = 4 * jj + e, r = e >> 1;
          // A key past n gets P = 0 here, not through k's zero fill: its s = 0
          // gives exp2(−lse2), which is inf for a row whose logits all lie
          // below about −88, and inf·0 is NaN in dS·k.
          const float p = key < a.n ? exp2_ftz(sc[i] * a.scale_log2 - lse2[r]) : 0.f;
          dp[i] = p * ((dp[i] - drow[r]) * a.sm_scale);
        }
      uint32_t da[W / 16][4];
      acc_to_frags<W / 2>(da, dp);  // dS·sm_scale rounded to bf16 (k's dtype) before dS·k
      wg_fence_acc(dq);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) wgmma64_rs_t(dq, da[kk], wg_desc(k_addr + 2048 * kk));
      wg_commit();
      wg_wait();
      wg_fence_acc(dq);
      wg_fence_frag(da);
      if (j + 2 < a.tiles) {
        __syncthreads();  // every warp's dS·k has retired: stage s is free
        if (tid == 0) load_kv(s, j + 2);
      }
    }
    if (tid == 0) tma_wait_read();
    __syncthreads();
    store_tile(st, &tout, dq, 1.f, 1.f, a.out_f32, hi * kD, qt * kRows, bi);
  }
  if (tid == 0) tma_wait_all();
}

}  // namespace flash
}  // namespace hvt

namespace {

using hvt::flash::DkvArgs;
using hvt::flash::DqArgs;
using hvt::flash::FwdArgs;
using hvt::flash::Plan;

bool takes(int batch, int heads, int n, int d) {
  return d == hvt::flash::kD && n >= 1 && batch >= 1 && heads >= 1 &&
         (long long)batch * heads * ((n + hvt::flash::kRows - 1) / hvt::flash::kRows) <=
             0x7fffffffLL;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

// The current device's primary context made current in this thread.
// cuTensorMapEncodeTiled fails without one, and a thread whose first
// runtime call needing the context is yet to come has none: autograd runs
// the backward on a thread of its own, where the dQ kernel is the first
// launch. cudaSetDevice binds it (CUDA 12), and costs nothing once bound.
bool bind_context() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
}

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
using DqKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                          const float*, const float*, const float*, float*, DqArgs);

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

DqKernel dq_kernel(int w) {
  switch (w) {
#define HVT_W(W) \
  case W:        \
    return hvt::flash::flash_bwd_dq_kernel<W>;
    HVT_W(64) HVT_W(80) HVT_W(96) HVT_W(112) HVT_W(128)
#undef HVT_W
  }
  return nullptr;
}

// Blocks an SM of `kernel` with plan p's shared memory, into *out.
template <typename K>
int occupancy(K kernel, const Plan& p, int* out) {
  const int err = hvt::allow_smem(kernel, (size_t)p.smem);
  if (err) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, hvt::flash::kThreads, p.smem);
}

}  // namespace

// The plan of the forward (out[0..4]: key tile rows, key tiles, query tiles,
// blocks an (image, head), dynamic shared memory), of dK/dV (out[5..9]:
// query chunk rows, chunks, key tiles, blocks an (image, head), shared
// memory) and of dQ (out[10..14]: key tile rows, key tiles, query tiles,
// blocks an (image, head), shared memory) at sequence length n.
extern "C" void hvt_flash_plan(int n, int* out) {
  const Plan plans[3] = {hvt::flash::fwd_plan(n), hvt::flash::dkv_plan(n),
                         hvt::flash::dq_plan(n)};
  for (int i = 0; i < 3; ++i) {
    const Plan& p = plans[i];
    const int v[5] = {p.inner, p.tiles, p.outer, p.blocks_per_head, p.smem};
    for (int j = 0; j < 5; ++j) out[5 * i + j] = v[j];
  }
}

// Blocks an SM of the forward's (out[0]), dK/dV's (out[1]) and dQ's
// (out[2]) instance at sequence length n with their plan's shared memory, as
// the occupancy calculator gives them (registers, shared memory, threads).
// Returns a cudaError_t.
extern "C" int hvt_flash_occupancy(int n, int* out) {
  const Plan f = hvt::flash::fwd_plan(n), b = hvt::flash::dkv_plan(n), q = hvt::flash::dq_plan(n);
  int err = occupancy(fwd_kernel(f.inner), f, &out[0]);
  if (!err) err = occupancy(dkv_kernel(b.inner), b, &out[1]);
  if (!err) err = occupancy(dq_kernel(q.inner), q, &out[2]);
  return err;
}

// qkv (B, N, 3·D) bf16, D = heads·64, 16-byte aligned; o (B, N, D) and lse
// (B·H, N) f32; o in f32 where out_f32, else bf16. d must be 64. Returns a
// cudaError_t, or -1 for a shape the kernel does not take.
extern "C" int hvt_flash_attention_fwd(const void* qkv, void* o, float* lse, int batch, int heads,
                                       int n, int d, float sm_scale, int out_f32, void* stream) {
  if (!takes(batch, heads, n, d)) return -1;
  if (!bind_context()) return static_cast<int>(cudaErrorInvalidDevice);
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

// dq of the forward above into the q columns of the packed dqkv (B, N,
// 3·D), and D = rowsum(dO∘O) into delta (B·H, N) f32 for dK/dV: qkv16 (B, N,
// 3·D) and dout16 (B, N, D) bf16, the products' operands; o and dout (B, N,
// D) the forward's output and the gradient as the caller has them, f32
// where out_f32 (then D reads them, and dqkv is f32), else bf16 (then dout
// is dout16 and D reads the tiles of o and dout16); all 16-byte aligned;
// lse (B·H, N) f32. Returns as the forward.
extern "C" int hvt_flash_attention_bwd_dq(const void* qkv16, const void* dout16, const void* o,
                                          const void* dout, const float* lse, float* delta,
                                          void* dqkv, int batch, int heads, int n, int d,
                                          float sm_scale, int out_f32, void* stream) {
  if (!takes(batch, heads, n, d)) return -1;
  if (!bind_context()) return static_cast<int>(cudaErrorInvalidDevice);
  const Plan p = hvt::flash::dq_plan(n);
  const long long c = (long long)heads * d;
  const bool f32 = out_f32 != 0;
  CUtensorMap tq, tkv, tdo, to, tout;
  if (!tensor_map(&tq, qkv16, false, batch, n, 3 * c, hvt::flash::kRows) ||
      !tensor_map(&tkv, qkv16, false, batch, n, 3 * c, p.inner) ||
      !tensor_map(&tdo, dout16, false, batch, n, c, hvt::flash::kRows) ||
      !tensor_map(&to, f32 ? dout16 : o, false, batch, n, c, hvt::flash::kRows) ||  // unread for f32
      !tensor_map(&tout, dqkv, f32, batch, n, 3 * c, hvt::flash::kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const DqArgs a{heads, n, p.tiles, p.outer, p.blocks_per_head, out_f32,
                 sm_scale * hvt::kLog2e, sm_scale};
  const DqKernel kernel = dq_kernel(p.inner);
  const int err = hvt::allow_smem(kernel, (size_t)p.smem);
  if (err) return err;
  kernel<<<batch * heads * p.blocks_per_head, hvt::flash::kThreads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(
      tq, tkv, tdo, to, tout, f32 ? static_cast<const float*>(o) : nullptr,
      f32 ? static_cast<const float*>(dout) : nullptr, lse, delta, a);
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
  if (!bind_context()) return static_cast<int>(cudaErrorInvalidDevice);
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

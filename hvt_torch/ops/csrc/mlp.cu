// The MLP half of the fused SwinV2 block, both directions, both sites, on
// tiled tensor-core kernels that take C at run time (one library):
//
//   hvt_mlp_half_fwd:         out = x + s·LN(fc2(GELU(fc1 x))), or the branch alone
//   hvt_mlp_half_chunked_fwd: the branch and its pre-LN sum rounded to x's
//                             dtype, for the chunked backward
//   hvt_mlp_half_bwd:         gradients of out (or of the branch alone),
//                             recomputing the forward from x
//   hvt_mlp_half_chunked_bwd: gradients of the branch
//                             LN(Σₖ gelu(x·W1ₖ + b1ₖ)·W2ₖ + b2) given g, from x
//                             and the saved pre-LN sum `pre`
//
// Replace: hvt/ops/fused_halves_pallas.py `_mlp_forward` (pallas_call at
// line 338, body `_mlp_fwd_kernel`), `_mlp_chunked_forward` (pallas_call at
// line 592, body `_mlp_chunk_fwd_kernel`), `_mlp_backward` (pallas_call at
// line 371, body `_mlp_bwd_kernel`) and `_mlp_chunk_backward` (pallas_call
// at line 627, body `_mlp_chunk_bwd_kernel`) with its caller
// `_mlp_chunked_bwd` (659): one launch here computes what hvt's K calls and
// the XLA sum after them compute.
//
// Arithmetic contract, hvt's: every product rounds its operands to bf16 and
// accumulates in f32 (_dot/_dot_t, the weight gradients included); GELU and
// its derivative by the A&S erf polynomial; LayerNorm and its backward in
// f32.
//  * Forward (`_mlp_fwd_kernel`): h = gelu(x·W1ᵀ + b1) rounded to bf16 (the
//    next product's operand), the pre-LN sum h·W2ᵀ + b2 in f32, LayerNorm
//    of it and x + s·y rounded once. The chunked site (`_mlp_chunk_fwd_kernel`)
//    is the same chain over the whole 4C: hvt adds the K chunks' products in
//    an f32 VMEM scratch across its grid steps, fc2 here adds them in f32
//    registers across its K slices, so the result does not depend on K; the
//    pre-LN sum is also stored rounded to x's dtype, and the LayerNorm runs
//    on the unrounded sum, as hvt's.
//  * Unchunked (`_mlp_bwd_kernel`): nothing of the forward is saved; the
//    pre-LN sum is recomputed from x and stays f32; the branch runs on s·g
//    kept in f32; dx = g + dpre·W1 is rounded to x's dtype once where the
//    residual is fused, and dpre·W1 alone is rounded once where it is not.
//  * Chunked (`_mlp_chunk_bwd_kernel`): the LayerNorm statistics come from
//    the saved `pre`, rounded to x's dtype by the forward; each chunk's dx
//    partial dpreₖ·W1ₖ is rounded to x's dtype, the partials are summed in
//    f32 and the sum is rounded once more.
//
// What bounds them on the H100. The forward does 2 products of 2·T·C·4C
// FLOP, 16·T·C² (0.359 ms a SwinV2-T forward at batch 64 at 989 TFLOP/s)
// for 4·T·C bytes of x and out; the chain below adds h's round trip (16
// bytes per token-channel, written and read in bf16) and the f32 pre-LN
// sum's (8): 30 bytes per token-channel with x read twice, 2.75 GB or 0.82
// ms a SwinV2-T forward at 3.35 TB/s, the design's byte floor. fc1 does
// 0.8·C FLOP per byte of x and h (77 at C = 96, 614 at 768): stages 1-2 are
// bound by h's round trip, stages 3-4 by the products. The unchunked backward does
// 7 products of 2·T·C·4C FLOP (fc1 twice, fc2, dh, dx, dW1, dW2): 56·T·C²,
// 2.5e11 per SwinV2-T launch at batch 128 (0.25 ms at 989 TFLOP/s), against
// some 70·T·C bytes through device memory (x, g, dx, h, dpre, dout and the
// f32 pre-LN sum; 0.13 ms at 3.35 TB/s). The chunked one does 5 (the saved
// pre stands in for fc1's first pass and fc2).
//
// Design. The TPU kernels keep the (rows, 4C) hidden activation in VMEM
// and add the weight gradients into VMEM across a sequential grid; a
// Hopper block has 227 KB of shared memory and blocks run in no order. A
// kernel that keeps h on chip owns a few rows and re-reads all of W1 and W2
// (16·C² bytes) for them, and its tile grows with C. So both directions are
// chains of kernels whose tiles do not grow with C (C is a run-time
// argument), each product on a tiled core with 128-row output tiles, so
// that each weight slice serves 128 rows. The forward (forward-named
// kernels, so that a profile tells them apart from the backward's):
//   1. `mlp_fwd_fc1_kernel`: h (T, 4C) = bf16(gelu(x·W1ᵀ + b1)), the same
//      device code as the backward's step 1, so that the backward's
//      recompute of h equals the forward's bit for bit;
//   2. `mlp_fwd_fc2_kernel`: pre (T, C) = h·W2ᵀ + b2 in f32;
//   3. `ln_resid_fwd_kernel` (gemm_tc.cuh), one warp a row: LayerNorm of
//      pre, x + s·y rounded once (and the bf16 pre-LN sum, chunked site).
// fc1 and fc2, in both directions, run on gemm_wgmma.cuh's warpgroup core
// (wgmma from shared memory, 128 x 128 tiles, fc2's 96 or 64 columns wide
// where C is not a multiple of 128; K in 64-wide swizzled slices through a
// three-stage cp.async ring). The backward's other products run on
// gemm_tc.cuh's core (128 x 64 output tiles, 128 x 128 for dx and grad_tn
// where their columns are a multiple of 128; K in slices of 32 through a
// three-stage cp.async ring, ldmatrix and ldmatrix.trans into mma.sync).
// The operands of the weight-gradient products pass through device memory
// in bf16, which the contract rounds them to anyway. The backward:
//   1. (unchunked) `mlp_bwd_fc1_kernel`: h = gelu(x·W1ᵀ + b1), stored bf16;
//   2. (unchunked) `mlp_bwd_fc2_kernel`: pre = h·W2ᵀ + b2, stored f32 in the
//      dpre buffer, which step 4 writes only after step 3 has read it;
//   3. `mlp_bwd_ln_kernel`, one warp per row: the LayerNorm statistics of
//      pre (f32, or the saved bf16 one), dout = _ln_bwd(s·g, normed, inv,
//      lns) stored bf16, and per block the column sums [db2 | dlns | dlnb]
//      (bound by bytes: 8·T·C of them, the f32 pre, g and dout);
//   4. `mlp_bwd_hidden_kernel`, per (128 rows, 64 hidden units): fc1 again
//      and dh = dout·W2 in one stream over C, dpre = dh·gelu′(pre₁) stored
//      bf16 (and h, on the chunked site), per block the column sums of dpre
//      (db1). Recomputing fc1 costs one product; storing pre₁ in f32 would
//      write and read 16·T·C bytes more;
//   5. `mlp_bwd_dx_kernel`, per (128 rows, 64 or 128 channels): dpre·W1
//      over the 4C hidden units, the residual's pass-through g added before
//      the one rounding (unchunked), or each chunk's partial rounded (chunked);
//   6. dW1 = Σ dpreᵀx and dW2 = Σ doutᵀh by grad_tn (gemm_tc.cuh), dW2 as
//      the transpose of hᵀ·dout so that both products tile the 4C dim by 128.
// Partials are summed by sum_parts in a fixed order: every result is
// deterministic (no atomics).
#include "gemm_wgmma.cuh"

namespace hvt {

constexpr int kLnRows = 64;  // rows of a LayerNorm-backward block: 8 per warp

inline bool mlp_width_ok(int T, int C) { return T > 0 && ln_width_ok(C); }

// ---------------------------------------------------------------------------
// fc1 and fc2, shared by both directions
// ---------------------------------------------------------------------------

// fc1 and fc2 run on gemm_wgmma.cuh's warpgroup core, 128-row output
// tiles, two blocks an SM (73-97 KB of shared memory each).
//
// hid (T, 4C) = bf16(gelu(x·W1ᵀ + b1)) over the block's tile, rows
// blockIdx.y·kWgBM.., hidden units blockIdx.x·kFc1Cols..: grid (4C /
// kFc1Cols, row tiles); 4C is a multiple of 128 wherever C is one of 32.
// The epilogue is bound by its instructions at C = 96-384 (16,384 GELUs a
// block against 2-6 K slices of products), so it takes gelu_as_fast and
// sends h out through shared memory in 16-byte pieces (wg_store_bf16):
// each of the two cut fc1's time at those widths on the H100.
constexpr int kFc1Cols = 128;

__device__ __forceinline__ void fc1_tile(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                         const float* __restrict__ b1, bf16* __restrict__ hid,
                                         int T, int C) {
  const int HID = 4 * C, n0 = blockIdx.x * kFc1Cols, m0 = blockIdx.y * kWgBM;
  float acc[kFc1Cols / 2];
  wg_gemm_nt<kFc1Cols>(acc, x, T, w1, HID, C, m0, n0);
  wg_store_bf16<kFc1Cols>(
      acc,
      [&](int c, float v0, float v1) {
        return pack_bf16x2(gelu_as_fast(v0 + b1[n0 + c]), gelu_as_fast(v1 + b1[n0 + c + 1]));
      },
      hid, HID, m0, n0, T);
}

__global__ void __launch_bounds__(kWgThreads, 2)
mlp_fwd_fc1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, bf16* __restrict__ hid, int T, int C) {
  fc1_tile(x, w1, b1, hid, T, C);
}

// The backward's step 1: the forward's h again, under the backward's name.
__global__ void __launch_bounds__(kWgThreads, 2)
mlp_bwd_fc1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, bf16* __restrict__ hid, int T, int C) {
  fc1_tile(x, w1, b1, hid, T, C);
}

// pre (T, C) = h·W2ᵀ + b2 in f32 over the block's tile: grid (ceil(C / BN),
// row tiles); columns past C are masked.
template <int BN>
__device__ __forceinline__ void fc2_tile(const bf16* __restrict__ hid, const bf16* __restrict__ w2,
                                         const float* __restrict__ b2, float* __restrict__ pre,
                                         int T, int C) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kWgBM;
  float acc[BN / 2];
  wg_gemm_nt<BN>(acc, hid, T, w2, C, 4 * C, m0, n0);
  wg_pairs<BN>(acc, m0, n0, [&](int row, int col, float v0, float v1) {
    if (row < T && col < C)
      *reinterpret_cast<float2*>(pre + (size_t)row * C + col) =
          make_float2(v0 + b2[col], v1 + b2[col + 1]);
  });
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
mlp_fwd_fc2_kernel(const bf16* __restrict__ hid, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ pre, int T, int C) {
  fc2_tile<BN>(hid, w2, b2, pre, T, C);
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
mlp_bwd_fc2_kernel(const bf16* __restrict__ hid, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ pre, int T, int C) {
  fc2_tile<BN>(hid, w2, b2, pre, T, C);
}

// fc2's output tile widths; the caller picks one for C (fused_halves_cuda's
// fc2_cols: SwinV2-T's C = 96 and 192 take 96, no masked columns).
inline bool fc2_cols_ok(int bn) { return bn == 64 || bn == 96 || bn == 128; }

template <int BN, bool kFwd>
int launch_fc2(const bf16* hid, const bf16* w2, const float* b2, float* pre, int T, int C,
               cudaStream_t st) {
  auto fc2 = kFwd ? &mlp_fwd_fc2_kernel<BN> : &mlp_bwd_fc2_kernel<BN>;
  if (int err = allow_smem(fc2, wg_smem<BN>())) return err;
  fc2<<<dim3((C + BN - 1) / BN, (T + kWgBM - 1) / kWgBM), kWgThreads, wg_smem<BN>(), st>>>(
      hid, w2, b2, pre, T, C);
  return (int)cudaGetLastError();
}

// fc1 into hid and fc2 into pre (f32) for x (T, C), fc2 in tiles of bn
// columns, under the forward's names (kFwd) or the backward's.
template <bool kFwd>
int launch_fc(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
              bf16* hid, float* pre, int bn, int T, int C, cudaStream_t st) {
  if (!fc2_cols_ok(bn)) return -1;
  auto fc1 = kFwd ? &mlp_fwd_fc1_kernel : &mlp_bwd_fc1_kernel;
  if (int err = allow_smem(fc1, wg_smem<kFc1Cols>())) return err;
  fc1<<<dim3(4 * C / kFc1Cols, (T + kWgBM - 1) / kWgBM), kWgThreads, wg_smem<kFc1Cols>(), st>>>(
      x, w1, b1, hid, T, C);
  if (int err = (int)cudaGetLastError()) return err;
  if (bn == 128) return launch_fc2<128, kFwd>(hid, w2, b2, pre, T, C, st);
  if (bn == 96) return launch_fc2<96, kFwd>(hid, w2, b2, pre, T, C, st);
  return launch_fc2<64, kFwd>(hid, w2, b2, pre, T, C, st);
}

// Step 3, one warp per row of pre (T, C) and g: the row's LayerNorm
// statistics (two-pass, eps 1e-5, as _ln_fwd), normed, and with gs = s·g in
// f32 (s[row / tpi], or 1 where s is null) dout = (gs·lns − mean(gs·lns) −
// normed·mean(gs·lns·normed))·inv (_ln_bwd), stored bf16. Lane l holds the
// columns l + 32v, v < C/32 <= kV: kV, the registers a lane keeps a row in,
// is the smallest of 4, 8, 16 and 32 that holds C, so narrow rows leave
// room for more warps in flight. Each warp sums its rows' dout, gs·normed
// and gs per column in its own row of shared memory; the block adds the 8
// rows in order into part[block] = [db2 | dlns | dlnb] (3C floats).
template <typename PreT, int kV>
__global__ void __launch_bounds__(kLnThreads)
mlp_bwd_ln_kernel(const PreT* __restrict__ pre, const bf16* __restrict__ gout,
                  const float* __restrict__ lns, const float* __restrict__ s, int tpi,
                  bf16* __restrict__ dout, float* __restrict__ part, int T, int C) {
  extern __shared__ __align__(16) unsigned char ln_smem[];
  float* const sums = reinterpret_cast<float*>(ln_smem);  // [warp][3][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nv = C / 32;
  float* const cs = sums + warp * 3 * C;
  for (int i = lane; i < 3 * C; i += 32) cs[i] = 0.f;
  for (int r = warp; r < kLnRows; r += kLnThreads / 32) {
    const int row = blockIdx.x * kLnRows + r;
    if (row >= T) break;
    const float sc = s != nullptr ? s[row / tpi] : 1.f;
    const size_t base = (size_t)row * C + lane;
    float p[kV], gs[kV];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) {
        p[v] = to_f32(pre[base + 32 * v]);
        gs[v] = sc * to_f32(gout[base + 32 * v]);
        sum += p[v];
      }
    const float mu = warp_sum(sum) / C;
    float var = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) {
        p[v] -= mu;
        var += p[v] * p[v];
      }
    const float inv = rsqrtf(warp_sum(var) / C + 1e-5f);
    float a = 0.f, m = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) {
        p[v] *= inv;  // normed
        const float gn = gs[v] * lns[32 * v + lane];
        a += gn;
        m += gn * p[v];
      }
    a = warp_sum(a) / C;
    m = warp_sum(m) / C;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) {
        const int col = 32 * v + lane;
        const float d = (gs[v] * lns[col] - a - p[v] * m) * inv;
        cs[col] += d;
        cs[C + col] += gs[v] * p[v];
        cs[2 * C + col] += gs[v];
        dout[base + 32 * v] = __float2bfloat16(d);
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += kLnThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kLnThreads / 32; ++w) t += sums[w * 3 * C + i];
    part[(size_t)blockIdx.x * 3 * C + i] = t;
  }
}

inline size_t ln_smem_bytes(int C) { return sizeof(float) * (kLnThreads / 32) * 3 * C; }

// Step 4, per (kBM rows, kBN hidden units h0..); grid (4C / kBN, row tiles):
// pre₁ = x·W1[h0..]ᵀ + b1 and dh = dout·W2[:, h0..], both over C in one
// stream; dpre = dh·gelu′(pre₁) goes out bf16 to (T, 4C), h = gelu(pre₁) too
// where hid is given, and the block's column sums of dpre (f32, its valid
// rows) to part[blockIdx.y][h0..].
constexpr int kHiddenStage = 2 * kTileAR + tile_br<kBN>() + tile_bk<kBN>();
constexpr size_t kHiddenSmem = sizeof(bf16) * kGemmStages * kHiddenStage;

__global__ void __launch_bounds__(kGemmThreads, 2)
mlp_bwd_hidden_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ dout, bf16* __restrict__ hid,
                      bf16* __restrict__ dpre, float* __restrict__ part, int T, int C) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  __shared__ float red[2][kBN];
  bf16* const sm = reinterpret_cast<bf16*>(gemm_smem);
  const int HID = 4 * C, h0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  float pa[4][4][4] = {}, da[4][4][4] = {};
  gemm_pipeline(
      C / kBK,
      [&](int s, int st) {
        bf16* d = sm + st * kHiddenStage;
        const int k0 = s * kBK;
        load_rows_k<kBM>(d, x, C, m0, T, k0);
        load_rows_k<kBM>(d + kTileAR, dout, C, m0, T, k0);
        load_rows_k<kBN>(d + 2 * kTileAR, w1, C, h0, HID, k0);
        load_k_rows<kBN>(d + 2 * kTileAR + tile_br<kBN>(), w2, HID, k0, C, h0, HID);
      },
      [&](int, int st) {
        const bf16* d = sm + st * kHiddenStage;
        tile_mma<false, false, kBN>(pa, d, d + 2 * kTileAR);
        tile_mma<false, true, kBN>(da, d + kTileAR, d + 2 * kTileAR + tile_br<kBN>());
      });
  float cs[4][2] = {};
  tile_pairs<kBN>(m0, h0, [&](int i, int j, int e, int row, int col) {
    if (row >= T) return;
    float gd0, gd1;
    const float h_0 = gelu_as(pa[i][j][e] + b1[col], &gd0);
    const float h_1 = gelu_as(pa[i][j][e + 1] + b1[col + 1], &gd1);
    const float d0 = da[i][j][e] * gd0, d1 = da[i][j][e + 1] * gd1;
    cs[j][0] += d0;
    cs[j][1] += d1;
    const size_t off = (size_t)row * HID + col;
    *reinterpret_cast<uint32_t*>(dpre + off) = pack_bf16x2(d0, d1);
    if (hid != nullptr) *reinterpret_cast<uint32_t*>(hid + off) = pack_bf16x2(h_0, h_1);
  });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < 4) red[warp >> 1][32 * (warp & 1) + 8 * j + 2 * lane + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < kBN)
    part[(size_t)blockIdx.y * HID + h0 + threadIdx.x] = red[0][threadIdx.x] + red[1][threadIdx.x];
}

// Step 5, per (kBM rows, BN channels c0..); grid (ceil(C / BN), row tiles):
// dpre·W1[:, c0..] over the 4C hidden units. kChunked: each chunk of hk
// units' f32 sum is rounded to bf16 and added to an f32 total, rounded once
// more at the store (BN = 64, the total's registers beside the sum's).
// Otherwise the sum, plus g where g is given (the fused residual's
// pass-through), is rounded once at the store.
template <int BN>
constexpr size_t dx_smem() { return sizeof(bf16) * kGemmStages * (kTileAR + tile_bk<BN>()); }

template <bool kChunked, int BN>
__global__ void __launch_bounds__(kGemmThreads)
mlp_bwd_dx_kernel(const bf16* __restrict__ dpre, const bf16* __restrict__ w1,
                  const bf16* __restrict__ gout, bf16* __restrict__ dx, int T, int C, int hk) {
  static_assert(!kChunked || BN == kBN, "the chunked sum's registers fit beside 64 columns");
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  constexpr int kStage = kTileAR + tile_bk<BN>();
  bf16* const sm = reinterpret_cast<bf16*>(gemm_smem);
  const int HID = 4 * C, c0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  float acc[4][BN / 16][4] = {};
  float tot[kChunked ? 4 : 1][BN / 16][4] = {};
  gemm_pipeline(
      HID / kBK,
      [&](int s, int st) {
        bf16* d = sm + st * kStage;
        load_rows_k<kBM>(d, dpre, HID, m0, T, s * kBK);
        load_k_rows<BN>(d + kTileAR, w1, C, s * kBK, HID, c0, C);
      },
      [&](int s, int st) {
        tile_mma<false, true, BN>(acc, sm + st * kStage, sm + st * kStage + kTileAR);
        if constexpr (kChunked) {
          if ((s + 1) * kBK % hk == 0) {  // the end of a chunk: its partial, rounded, joins the total
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < BN / 16; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  tot[i][j][e] += round_bf16(acc[i][j][e]);
                  acc[i][j][e] = 0.f;
                }
          }
        }
      });
  tile_pairs<BN>(m0, c0, [&](int i, int j, int e, int row, int col) {
    if (row >= T || col >= C) return;
    const size_t off = (size_t)row * C + col;
    float y0, y1;
    if constexpr (kChunked) {
      y0 = tot[i][j][e];
      y1 = tot[i][j][e + 1];
    } else {
      y0 = acc[i][j][e];
      y1 = acc[i][j][e + 1];
      if (gout != nullptr) {
        const float2 gv = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(gout + off));
        y0 += gv.x;
        y1 += gv.y;
      }
    }
    *reinterpret_cast<uint32_t*>(dx + off) = pack_bf16x2(y0, y1);
  });
}

// Steps 3-6, shared by both sites: the LayerNorm backward on `pre`, the
// hidden kernel, dx and the weight gradients. dsmall = [db1 | db2 | dlns |
// dlnb]; part_ln ceil(T / kLnRows)·3C and part_h ceil(T / kBM)·4C floats.
template <typename PreT>
int mlp_bwd_tail(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                 const float* lns, const PreT* pre, const float* s, int tpi, const bf16* g,
                 bool resid, bf16* dx, float* dw1, float* dw2, float* dsmall, bf16* hid,
                 bool store_h, bf16* dpre, bf16* dout, float* part_ln, float* part_h,
                 float* wpart, int splits1, int splits2, int hk, int T, int C, cudaStream_t st) {
  const int HID = 4 * C, row_tiles = (T + kBM - 1) / kBM;
  int err;

  auto ln = C <= 128   ? mlp_bwd_ln_kernel<PreT, 4>
            : C <= 256 ? mlp_bwd_ln_kernel<PreT, 8>
            : C <= 512 ? mlp_bwd_ln_kernel<PreT, 16>
                       : mlp_bwd_ln_kernel<PreT, kMaxV>;
  const int ln_blocks = (T + kLnRows - 1) / kLnRows;
  if ((err = allow_smem(ln, ln_smem_bytes(C)))) return err;
  ln<<<ln_blocks, kLnThreads, ln_smem_bytes(C), st>>>(pre, g, lns, s, tpi, dout, part_ln, T, C);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(part_ln, ln_blocks, 3LL * C, dsmall + HID, st))) return err;

  if ((err = allow_smem(mlp_bwd_hidden_kernel, kHiddenSmem))) return err;
  mlp_bwd_hidden_kernel<<<dim3(HID / kBN, row_tiles), kGemmThreads, kHiddenSmem, st>>>(
      x, w1, b1, w2, dout, store_h ? hid : nullptr, dpre, part_h, T, C);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(part_h, row_tiles, HID, dsmall, st))) return err;

  const bf16* gx = resid ? g : nullptr;
  if (hk < HID) {
    mlp_bwd_dx_kernel<true, kBN><<<dim3((C + kBN - 1) / kBN, row_tiles), kGemmThreads,
                                   dx_smem<kBN>(), st>>>(dpre, w1, nullptr, dx, T, C, hk);
  } else if (tile_cols(C) == 128) {
    if ((err = allow_smem(mlp_bwd_dx_kernel<false, 128>, dx_smem<128>()))) return err;
    mlp_bwd_dx_kernel<false, 128><<<dim3(C / 128, row_tiles), kGemmThreads, dx_smem<128>(), st>>>(
        dpre, w1, gx, dx, T, C, hk);
  } else {
    mlp_bwd_dx_kernel<false, kBN><<<dim3((C + kBN - 1) / kBN, row_tiles), kGemmThreads,
                                    dx_smem<kBN>(), st>>>(dpre, w1, gx, dx, T, C, hk);
  }
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = grad_tn(dpre, x, dw1, wpart, splits1, T, HID, C, false, st))) return err;
  return grad_tn(hid, dout, dw2, wpart, splits2, T, HID, C, true, st);
}

}  // namespace hvt

// x, out (T, C) bf16, 16-byte aligned; w1 (4C, C), w2 (C, 4C) bf16; b1, b2,
// lns, lnb f32; s f32 (s null: the branch alone, no residual; s[row / tpi]
// scales row's branch). Scratch: hid (T, 4C) bf16 and pre (T, C) f32. fc2
// in output tiles of bn2 columns. C a multiple of 32 up to 1024. Returns a
// cudaError_t, or -1.
extern "C" int hvt_mlp_half_fwd(const void* x, const void* w1, const float* b1, const void* w2,
                                const float* b2, const float* lns, const float* lnb,
                                const float* s, int tpi, void* out, void* hid, float* pre,
                                int bn2, int t, int c, void* stream) {
  using namespace hvt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mlp_width_ok(t, c)) return -1;
  const bf16* xb = static_cast<const bf16*>(x);
  if (int err = launch_fc<true>(xb, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2),
                                b2, static_cast<bf16*>(hid), pre, bn2, t, c, st))
    return err;
  return ln_resid_fwd(pre, lns, lnb, xb, s, tpi, static_cast<bf16*>(out), nullptr, t, c, st);
}

// The chunked MLP's forward: the same chain over the whole 4C, no residual.
// x, out, pre_out (T, C) bf16: out the branch, pre_out the pre-LN sum
// rounded once. Scratch and the rest as hvt_mlp_half_fwd's.
extern "C" int hvt_mlp_half_chunked_fwd(const void* x, const void* w1, const float* b1,
                                        const void* w2, const float* b2, const float* lns,
                                        const float* lnb, void* out, void* pre_out, void* hid,
                                        float* pre, int bn2, int t, int c, void* stream) {
  using namespace hvt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mlp_width_ok(t, c)) return -1;
  if (int err = launch_fc<true>(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                                static_cast<const bf16*>(w2), b2, static_cast<bf16*>(hid), pre,
                                bn2, t, c, st))
    return err;
  return ln_resid_fwd(pre, lns, lnb, nullptr, nullptr, 1, static_cast<bf16*>(out),
                      static_cast<bf16*>(pre_out), t, c, st);
}

// Dynamic shared memory of a block of fc1 and fc2 (both directions) and of
// the forward's LayerNorm pass, bytes: kernel 0 fc1, 1 fc2 in tiles of bn2
// columns, 2 the LayerNorm pass; -1 for another kernel or tile width.
extern "C" int hvt_mlp_fwd_smem(int kernel, int bn2) {
  using namespace hvt;
  if (kernel == 1 && !fc2_cols_ok(bn2)) return -1;
  const size_t bytes[] = {wg_smem<kFc1Cols>(),
                          bn2 == 128 ? wg_smem<128>() : bn2 == 96 ? wg_smem<96>() : wg_smem<64>(),
                          0};
  return kernel >= 0 && kernel < 3 ? (int)bytes[kernel] : -1;
}

// x, g, dx (T, C) bf16; w1 (4C, C), w2 (C, 4C) bf16; b1, b2, lns, s f32 (s
// null: no fused residual; s[row / tpi] scales row's branch). Outputs:
// dw1 (4C, C), dw2 (C, 4C) and dsmall = [db1 (4C) | db2 | dlns | dlnb] f32.
// Scratch: hid, dpre (T, 4C) and dout (T, C) bf16, the f32 pre-LN sum
// (T, C) living in dpre's buffer until the hidden kernel writes it;
// part_ln ceil(T/64)·3C and part_h ceil(T/128)·4C floats; wpart
// max(splits)·4C·C floats (unused where both splits are 1). fc2 recomputed
// in tiles of bn2 columns, as the forward. C a multiple of 32 up to 1024.
// Returns a cudaError_t, or -1.
extern "C" int hvt_mlp_half_bwd(const void* x, const void* w1, const float* b1, const void* w2,
                                const float* b2, const float* lns, const float* s, int tpi,
                                const void* g, void* dx, float* dw1, float* dw2, float* dsmall,
                                void* hid, void* dpre, void* dout, float* part_ln,
                                float* part_h, float* wpart, int splits1, int splits2, int bn2,
                                int t, int c, void* stream) {
  using namespace hvt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mlp_width_ok(t, c)) return -1;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  bf16* hb = static_cast<bf16*>(hid);
  float* pre = static_cast<float*>(dpre);
  if (int err = launch_fc<false>(xb, w1b, b1, w2b, b2, hb, pre, bn2, t, c, st)) return err;
  return mlp_bwd_tail(xb, w1b, b1, w2b, lns, static_cast<const float*>(pre), s, tpi,
                      static_cast<const bf16*>(g), s != nullptr, static_cast<bf16*>(dx), dw1, dw2,
                      dsmall, hb, false, static_cast<bf16*>(dpre), static_cast<bf16*>(dout),
                      part_ln, part_h, wpart, splits1, splits2, 4 * c, t, c, st);
}

// x, pre, g, dx (T, C) bf16; w1 (4C, C), w2 (C, 4C) bf16; b1, lns f32; hk
// hidden units per chunk (a multiple of 32 dividing 4C). Outputs and
// scratch as hvt_mlp_half_bwd's, without b2, s and the f32 pre-LN sum.
// Returns a cudaError_t, or -1.
extern "C" int hvt_mlp_half_chunked_bwd(const void* x, const void* w1, const float* b1,
                                        const void* w2, const float* lns, const void* pre,
                                        const void* g, void* dx, float* dw1, float* dw2,
                                        float* dsmall, void* hid, void* dpre, void* dout,
                                        float* part_ln, float* part_h, float* wpart, int splits1,
                                        int splits2, int hk, int t, int c, void* stream) {
  using namespace hvt;
  if (!mlp_width_ok(t, c) || hk <= 0 || hk % kBK || (4 * c) % hk) return -1;
  return mlp_bwd_tail(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                      static_cast<const bf16*>(w2), lns, static_cast<const bf16*>(pre), nullptr,
                      1, static_cast<const bf16*>(g), false, static_cast<bf16*>(dx), dw1, dw2,
                      dsmall, static_cast<bf16*>(hid), true, static_cast<bf16*>(dpre),
                      static_cast<bf16*>(dout), part_ln, part_h, wpart, splits1, splits2, hk, t,
                      c, static_cast<cudaStream_t>(stream));
}

// out (m, n) f32 = aᵀ·b for a (t, m) and b (t, n) bf16, or its transpose
// (n, m) where trans, over `splits` token slices (part: splits·m·n floats
// where splits > 1). m and n multiples of 8. Returns a cudaError_t, or -1.
extern "C" int hvt_grad_tn(const void* a, const void* b, float* out, float* part, int splits,
                           int t, int m, int n, int trans, void* stream) {
  return hvt::grad_tn(static_cast<const hvt::bf16*>(a), static_cast<const hvt::bf16*>(b), out,
                      part, splits, t, m, n, trans != 0, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a block of the backward's own kernels at width
// c, bytes: kernel 0 the LayerNorm backward, 1 hidden, 2 dx (unchunked), 3
// grad_tn with c columns; -1 for another kernel. Its fc1 and fc2 are the
// forward's (hvt_mlp_fwd_smem).
extern "C" int hvt_mlp_bwd_smem(int kernel, int c) {
  using namespace hvt;
  const bool wide = tile_cols(c) == 128;
  const size_t bytes[] = {ln_smem_bytes(c), kHiddenSmem, wide ? dx_smem<128>() : dx_smem<kBN>(),
                          wide ? grad_tn_smem<128>() : grad_tn_smem<kBN>()};
  return kernel >= 0 && kernel < 4 ? (int)bytes[kernel] : -1;
}

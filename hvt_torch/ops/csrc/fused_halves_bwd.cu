// The fused SwinV2 block halves, backward (training on fuse: true):
//
//   hvt_mlp_half_bwd:            gradients of out = x + s·LN(fc2(GELU(fc1 x)))
//   hvt_attention_half_nhwc_bwd: gradients of out = x + s·LN(proj(attn(qkv(window(x)))))
//
// Replace: hvt/ops/fused_halves_pallas.py `_mlp_backward` (pallas_call at
// line 371, body `_mlp_bwd_kernel`) and `_attn_backward_nhwc` (pallas_call
// at line 1386, body `_attn_bwd_kernel_nhwc` -> `_attn_half_bwd_body` ->
// `_heads_bwd_from_cache`).
//
// Arithmetic contract, hvt's _dot/_dot_t: every product, the weight-gradient
// products included, rounds its operands to bf16 and accumulates in f32;
// LayerNorm and its backward, GELU and its derivative (the A&S erf) run in
// f32 and the attention core to f32 accuracy (tensor cores on bf16 pieces,
// below); dx is rounded to x's dtype once, at the store;
// weight, bias and LayerNorm-parameter gradients stay f32. As in hvt, the
// attention half rounds s·g to bf16 before its branch backward and the MLP
// half keeps s·g in f32. Nothing of the forward is saved: both recompute it
// from x, as the TPU kernels do.
//
// What bounds them on the H100: the operations. The MLP half does
// 12·T·C·4C FLOP (1.78e11 per SwinV2-T launch at batch 128, 0.18 ms at
// 989 TFLOP/s) against 6·T·C bytes of bf16 x, g and dx; the attention half
// (24·C² + 10·N·C)·T FLOP. Both sit far above the bf16 balance point.
//
// Design. The TPU kernels add the weight gradients into VMEM across a
// sequential grid; Hopper's blocks run in no order, and per-row-block
// partials of whole weight gradients would be ~1.9 GB at every stage (T·C²
// is constant). Since the contract rounds both operands of every
// weight-gradient product to bf16, the row kernels write those operands to
// device memory in bf16 — h, dpre and dout (MLP); the attention output,
// dproj and dqkv (attention) — and `grad_tn_kernel`, a tensor-core AᵀB over
// the tokens split into a fixed number of slices, forms each weight
// gradient, `sum_parts_kernel` summing the slices in a fixed order. Bias,
// LayerNorm-parameter, dz and dscale gradients reduce the same way: one f32
// partial per block, summed in a fixed order. Every result is deterministic
// (no atomics).
//  * MLP (3 kernels + reductions): `mlp_half_bwd_rows_kernel` owns 32 rows.
//    Pass 1 is the forward (mlp_fc_chunks), then the LayerNorm backward
//    gives dout (bf16 in shared memory and to device memory). Pass 2 streams
//    the 4C hidden dim in chunks of 32 again: fc1 recomputed, GELU and
//    GELU′, dh = dout·W2 chunk, dpre = dh·GELU′ (h and dpre stored bf16),
//    and dx += dpre·W1 chunk accumulated in registers; the epilogue adds the
//    pass-through g. Then dW1 = Σ dpreᵀx and dW2 = Σ doutᵀh.
//  * Attention (4 kernels + reductions; fused_halves_bwd.cuh, templated on
//    the token layout, which attention_half.cu builds on pre-partitioned
//    windows). The attention core's recompute and backward run on tensor
//    cores at f32 accuracy (attention_fwd_tc.cuh, attention_bwd_tc.cuh): q,
//    k, v and dao enter as three bf16 pieces each, P and the scaled dS as
//    bf16 hi + lo halves, the normalisation folded out of the products.
//    `attn_half_bwd_ao_kernel` (one block of 4 warps per chunk of windows,
//    window id and head) recomputes the head's q|k|v on tensor cores, C
//    streamed in slices by cp.async, and its attention output, which it
//    stores (bf16) at the tokens' own rows. `attn_half_bwd_proj_kernel`
//    (32 token rows at a time) forms proj from it and the LayerNorm
//    backward gives dproj. `attn_half_bwd_core_kernel` (blocks as the first
//    kernel's) recomputes q|k|v and dao = dproj·Wproj_h in one stream over
//    C and runs the core's backward: dqkv goes out in bf16, the chunk's dz
//    and dscale stay in registers. `attn_half_bwd_dx_kernel` forms dx = g +
//    dqkv·Wqkv per row. The first and third kernels' tiles do not grow with
//    C, which they take at run time. All per-token buffers are indexed by
//    the token's own NHWC position, so nothing is rolled or partitioned,
//    and dx, the un-rolled map, needs no scatter. Then dWqkv = Σ dqkvᵀx
//    and dWproj = Σ dprojᵀ·attn_out.
//  Rows 49-63 of a window's 64-row tensor-core tile are zeros and are
//  never stored, so they reach no gradient.
#include "fused_halves_bwd.cuh"

namespace hvt {

// ---------------------------------------------------------------------------
// MLP half
// ---------------------------------------------------------------------------

template <int C>
struct MlpBwdSmem {
  using F = MlpSmem<C>;
  static constexpr int BM = F::BM, HC = F::HC, LDX = F::LDX;
  static constexpr size_t x = 0;
  static constexpr size_t w1 = x + align16(sizeof(bf16) * BM * LDX);
  // W2's chunk tile; between the passes, the 2·3·C f32 column sums
  static constexpr size_t w2 = w1 + align16(sizeof(bf16) * HC * LDX);
  static constexpr size_t p = w2 + align16(sizeof(bf16) * C * kLDK);  // hidden, then dpre chunk
  static constexpr size_t dout = p + align16(sizeof(bf16) * BM * kLDK);
  static constexpr size_t red = dout + align16(sizeof(bf16) * BM * LDX);
  static constexpr size_t bytes = red + sizeof(float) * 128;
  static_assert(sizeof(bf16) * C * kLDK >= sizeof(float) * 6 * C, "column sums fit W2's tile");
};

// Rows of x (T, C); g the upstream gradient; s (B,) per-image scales over
// tpi rows each, or null (no fused residual: out = branch). Writes dx, h,
// dpre (T, 4C) and dout (T, C) in bf16, and per block the f32 column sums
// [db1 (4C) | db2 | dlns | dlnb] to part[block].
template <int C>
__global__ void __launch_bounds__(kThreads)
mlp_half_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ lns,
                         const float* __restrict__ s, int tpi, const bf16* __restrict__ gout,
                         bf16* __restrict__ dx, bf16* __restrict__ hid, bf16* __restrict__ dpre,
                         bf16* __restrict__ dout, float* __restrict__ part, int T) {
  using L = MlpBwdSmem<C>;
  constexpr int BM = L::BM, HC = L::HC, LDX = L::LDX, HID = 4 * C, NT = C / 32;
  extern __shared__ uint4 smem_u4[];
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::x);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::w1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::w2);
  float* colacc = reinterpret_cast<float*>(smem + L::w2);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  bf16* Ds = reinterpret_cast<bf16*>(smem + L::dout);
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  float* bpart = part + (size_t)blockIdx.x * 7 * C;

  copy_rows(Xs, LDX, BM, C, [&](int r) -> const bf16* {
    return row0 + r < T ? x + (size_t)(row0 + r) * C : nullptr;
  });

  // ---- pass 1: the forward to the pre-LN sum, then the LayerNorm backward ----
  {
    float acc[NT][4];
    mlp_fc_chunks<C>(acc, Xs, W1s, W2s, Ps, w1, b1, w2);
    __syncthreads();  // W2's tile becomes the column sums
    for (int i = threadIdx.x; i < 6 * C; i += kThreads) colacc[i] = 0.f;
    __syncthreads();
    auto grad = [&](int r, int col) -> float2 {
      const int row = row0 + r;
      if (row >= T) return make_float2(0.f, 0.f);
      const float sc = s != nullptr ? s[row / tpi] : 1.f;  // s·g kept in f32, as hvt
      const bf16* gr = gout + (size_t)row * C + col;
      return make_float2(sc * to_f32(gr[0]), sc * to_f32(gr[1]));
    };
    ln_bwd_epilogue<NT>(acc, b2, lns, red, colacc, grad, [&](int r, int col, float d0, float d1) {
      const uint32_t v = pack_bf16x2(d0, d1);
      *reinterpret_cast<uint32_t*>(Ds + r * LDX + col) = v;
      if (row0 + r < T) *reinterpret_cast<uint32_t*>(dout + (size_t)(row0 + r) * C + col) = v;
    });
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * C; i += kThreads)
      bpart[4 * C + i] = colacc[i] + colacc[3 * C + i];
  }

  // ---- pass 2, per hidden chunk: fc1, GELU′, dh = dout·W2, dpre, dx += dpre·W1 ----
  float dxa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dxa[j][0] = dxa[j][1] = dxa[j][2] = dxa[j][3] = 0.f;
  for (int h0 = 0; h0 < HID; h0 += HC) {
    __syncthreads();  // the previous chunk (or the column sums) is done with W1s, W2s, Ps, red
    copy_rows(W1s, LDX, HC, C, [&](int r) { return w1 + (size_t)(h0 + r) * C; });
    copy_rows(W2s, kLDK, C, HC, [&](int r) { return w2 + (size_t)r * HID + h0; });
    __syncthreads();

    // warp (wm, wn): rows 16·wm.., hidden cols 8·wn.. of the chunk
    float pa[1][4] = {{0.f, 0.f, 0.f, 0.f}}, da[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    warp_mma<1, C>(pa, Xs + wm * 16 * LDX, LDX, 16, W1s + wn * 8 * LDX, LDX);
    warp_mma_kn<1, C>(da, Ds + wm * 16 * LDX, LDX, 16, W2s + wn * 8, kLDK);
    const int col = wn * 8 + 2 * t;
    const float bb[2] = {b1[h0 + col], b1[h0 + col + 1]};
    float hv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float gd;
      hv[e] = gelu_as(pa[0][e] + bb[e & 1], &gd);
      dv[e] = da[0][e] * gd;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + g + 8 * half;
      const uint32_t pv = pack_bf16x2(dv[2 * half], dv[2 * half + 1]);
      *reinterpret_cast<uint32_t*>(Ps + r * kLDK + col) = pv;
      if (row0 + r < T) {
        const size_t off = (size_t)(row0 + r) * HID + h0 + col;
        *reinterpret_cast<uint32_t*>(hid + off) = pack_bf16x2(hv[2 * half], hv[2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dpre + off) = pv;
      }
    }
    // db1: the chunk's column sums of dpre (f32) over the block's rows
    float c0s = dv[0] + dv[2], c1s = dv[1] + dv[3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      c0s += __shfl_xor_sync(0xffffffffu, c0s, o);
      c1s += __shfl_xor_sync(0xffffffffu, c1s, o);
    }
    if (g == 0) { red[wm * 32 + col] = c0s; red[wm * 32 + col + 1] = c1s; }
    __syncthreads();
    if (threadIdx.x < HC) bpart[h0 + threadIdx.x] = red[threadIdx.x] + red[32 + threadIdx.x];
    warp_mma_kn<NT, HC>(dxa, Ps + wm * 16 * kLDK, kLDK, 16, W1s + wn * (C / 4), LDX);
  }

  // dx = g + dpre·W1 (the residual's pass-through), rounded once
  const int c0 = wn * (C / 4) + 2 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 16 + g + 8 * half;
      if (row >= T) continue;
      const size_t off = (size_t)row * C + c0 + j * 8;
      float y0 = dxa[j][2 * half], y1 = dxa[j][2 * half + 1];
      if (s != nullptr) {
        y0 += to_f32(gout[off]);
        y1 += to_f32(gout[off + 1]);
      }
      *reinterpret_cast<uint32_t*>(dx + off) = pack_bf16x2(y0, y1);
    }
  }
}

template <int C>
int launch_mlp_bwd(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const float* lns, const float* s, int tpi, const void* g,
                   void* dx, float* dw1, float* dw2, float* dsmall, void* hid, void* dpre,
                   void* dout, float* part, float* wpart, int splits1, int splits2, int T,
                   cudaStream_t st) {
  using L = MlpBwdSmem<C>;
  auto kernel = mlp_half_bwd_rows_kernel<C>;
  int err = allow_smem(kernel, L::bytes);
  if (err) return err;
  const int blocks = (T + L::BM - 1) / L::BM;
  kernel<<<blocks, kThreads, L::bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, lns, s, tpi, static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), static_cast<bf16*>(hid), static_cast<bf16*>(dpre),
      static_cast<bf16*>(dout), part, T);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(part, blocks, 7LL * C, dsmall, st))) return err;
  if ((err = grad_tn(static_cast<const bf16*>(dpre), static_cast<const bf16*>(x), dw1, wpart,
                     splits1, T, 4 * C, C, st)))
    return err;
  return grad_tn(static_cast<const bf16*>(dout), static_cast<const bf16*>(hid), dw2, wpart,
                 splits2, T, C, 4 * C, st);
}

}  // namespace hvt

// Widths built: SwinV2-T's four stages here; fused_halves_bwd_base.cu
// defines SwinV2-B's before including this file. The MLP half's backward
// takes HVT_MLP_WIDTHS: hvt never sends a C = 1024 block to it in training
// (fits_vmem routes that width to the chunked MLP), and its row kernel's
// layout would not fit 227 KB there. Another width returns -1.
#ifndef HVT_WIDTHS
#define HVT_WIDTHS(F) F(96) F(192) F(384) F(768)
#define HVT_MLP_WIDTHS(F) HVT_WIDTHS(F)
#endif

// x, g, dx (T, C) bf16; w1 (4C, C), w2 (C, 4C) bf16; b1, b2, lns, s f32 (s
// null: no fused residual). Outputs: dw1 (4C, C), dw2 (C, 4C) and dsmall =
// [db1 (4C) | db2 | dlns | dlnb] f32. Scratch: hid, dpre (T, 4C) and dout
// (T, C) bf16; part ceil(T/32)·7C floats; wpart max(splits)·4C·C floats
// (unused where both splits are 1). Returns a cudaError_t, or -1.
extern "C" int hvt_mlp_half_bwd(const void* x, const void* w1, const float* b1, const void* w2,
                                const float* b2, const float* lns, const float* s, int tpi,
                                const void* g, void* dx, float* dw1, float* dw2, float* dsmall,
                                void* hid, void* dpre, void* dout, float* part, float* wpart,
                                int splits1, int splits2, int t, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC)                                                                          \
  case CC:                                                                                    \
    return hvt::launch_mlp_bwd<CC>(x, w1, b1, w2, b2, lns, s, tpi, g, dx, dw1, dw2, dsmall,  \
                                   hid, dpre, dout, part, wpart, splits1, splits2, t, st);
    HVT_MLP_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

// x, g, dx (B, H, W, C) bf16, un-rolled (the shift is folded into the
// window gather); wqkv (3C, C), wproj (C, C) bf16; bqkv, scale (heads),
// z (nwz, heads, N, N), bproj, lns, s f32 (s null: no fused residual).
// Outputs f32: dwqkv (3C, C), dwproj (C, C), dsmall = [dbqkv (3C) | dbproj
// | dlns | dlnb], dscale (heads), dz (nwz, heads, N, N). Scratch: ao, dproj
// (T, C) and dqkv (T, 3C) bf16; part_b chunks·nwz·3C,
// dz_part chunks·nwz·heads·N·N, ds_part chunks·nwz·heads floats; wpart
// max(splits)·3C·C floats; part_a ceil(T/proj_rows)·3C floats, T = B·H·W.
// Chunk k of the tensor-core kernels covers windows u·nwz + wz for u in
// [k·per_block, min((k+1)·per_block, B·nW/nwz)); the proj kernel's blocks
// take proj_rows rows each (a multiple of 32).
extern "C" int hvt_attention_half_nhwc_bwd(
    const void* x, const void* wqkv, const float* bqkv, const float* scale, const float* z,
    int nwz, const void* wproj, const float* bproj, const float* lns, const float* s,
    const void* g, void* dx, float* dwqkv, float* dwproj, float* dsmall, float* dscale,
    float* dz, void* ao, void* dproj, void* dqkv, float* part_a, float* part_b, float* dz_part,
    float* ds_part, float* wpart, int per_block, int chunks, int proj_rows, int splits_qkv,
    int splits_proj, int b, int h, int w, int c, int heads, int ws, int shift, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC)                                                                            \
  case CC:                                                                                      \
    return hvt::launch_attn_bwd<CC>(x, wqkv, bqkv, scale, z, nwz, wproj, bproj, lns, s, g, dx, \
                                    dwqkv, dwproj, dsmall, dscale, dz, ao, dproj, dqkv, part_a, \
                                    part_b, dz_part, ds_part, wpart, per_block, chunks,         \
                                    proj_rows, splits_qkv, splits_proj, b,                      \
                                    hvt::NhwcWindows{h, w, ws, shift}, heads, st);
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

// Dynamic shared memory a block of the attention half's backward kernels
// takes at width c (both layouts): kernel 0 the attention output, 1 the
// core, 2 proj and the LayerNorm backward; -1 for a width not built here.
extern "C" int hvt_attention_half_bwd_smem(int kernel, int c) {
  if (kernel == 0) return (int)hvt::AoSmem::bytes;
  if (kernel == 1) return (int)hvt::CoreSmem::bytes;
  switch (c) {
#define HVT_CASE(CC) \
  case CC:           \
    return (int)hvt::proj_smem_bytes<CC>();
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

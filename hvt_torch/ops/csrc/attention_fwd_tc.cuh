// The cosine attention core's forward for one (window, head) on tensor
// cores: the math of cosine_attention (common.cuh),
//   out = softmax(scale·q̂k̂ᵀ + z)·v,   q̂ = q·rsqrt(Σq² + 1e-24), k̂ likewise,
// with both products on mma.sync.m16n8k16 (bf16 operands, f32 accumulation).
//
// Shapes: N <= 64 tokens padded to kTcRows = 64 (four 16-row tiles), head
// dim kTcHeadDim = 32. Padded keys get -inf logits (zero probability), padded
// rows a zero P and are never stored.
//
// Precision plan (the backward's, attention_bwd_tc.cuh):
//   * The normalisation is folded out of the product: cos_ij =
//     (q_i·k_j)·invQ_i·invK_j, so bf16 q and k enter the tensor cores as
//     they are and cos is an exact product summed in f32. f32 inputs enter
//     as three bf16 pieces, and cos takes the six piece products down to
//     2^-26 (p0p0, p0p1, p1p0, p1p1, p0p2, p2p0): the logit scale (up to 100)
//     multiplies its error. The norms take the three-piece sum.
//   * P, computed and normalised in f32, meets v in one of two ways, by
//     contract. Kept f32 (the packed kernels, and any f32 v): split into bf16
//     halves hi = bf16(P), lo = bf16(P − hi), hi·v + lo·v for bf16 v, hi·p0 +
//     hi·p1 + lo·p0 for f32 v (about 2^-17 relative). Rounded to v's dtype
//     (hvt's split-q/k/v kernel on bf16 v, `attn.astype(v.dtype)`): hi
//     alone, one product, exactly hvt's rounding.
//
// Work split: 4 warps, each owning 16 query rows for the whole window. A
// warp computes its rows' logits into accumulator fragments, takes the
// softmax in registers (a row lives in one quad: max and sum are two
// shuffles), and feeds P to P·v as A fragments taken straight from the
// logit accumulators: two adjacent 8-key n-tiles of the logits are one
// 16-key k-step of P·v. v is read through ldmatrix.trans (its rows are
// keys, and a B fragment's pairs run along the keys).
#pragma once

#include "attention_tc.cuh"

namespace hvt {

// The forward of one (window, head), all kTcThreads threads of the block
// taking part (it synchronises the block once, after the norms).
//   x:       this window's inputs, tc_pieces<T>() x 3 tiles (q, k, v) of
//            kTcRows x kTcHeadDim bf16 (swz32): piece 0 of each, then for
//            f32 inputs pieces 1 and 2; rows at or beyond n are zero. For
//            bf16 the warp's own 16 rows of q are overwritten at the end
//            (the output's staging for 16-byte stores).
//   inv:     2 x kTcRows f32 scratch (invQ, invK).
//   zs:      kTcRows x kTcZLd f32 (tc_load_z): this window id's and head's
//            bias(+mask) times log2(e), -inf at or beyond row or column n.
//   out_row(row): the address of output row `row` (< n), kTcHeadDim values
//            of T, 16-byte aligned.
// kRoundP rounds P to bf16 once before P·v (bf16 inputs only).
// On return other warps may still read x: the caller synchronises before it
// overwrites x or inv.
template <typename T, bool kRoundP, typename RowFn>
__device__ __forceinline__ void attention_window_fwd_tc(bf16* __restrict__ x,
                                                        float* __restrict__ inv, int n, float sc,
                                                        const float* __restrict__ zs,
                                                        RowFn out_row) {
  constexpr int kParts = tc_pieces<T>();
  constexpr bool kSplit = kParts == 3;
  constexpr int kB = kSplit ? 2 : 1;  // pieces of v that meet P
  static_assert(!(kRoundP && kSplit), "P is rounded to v's dtype, so only for bf16 v");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4 row addresses: (a_row, a_col) for A fragments and k-major B
  // (.trans), (b_row, b_col) for n-major B.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  auto tile = [&](int part, int op) { return x + (part * 3 + op) * kTcTile; };

  tc_inverse_norms<kParts, 3>(x, inv);  // invQ, invK
  __syncthreads();

  // ---- S = q·kᵀ for query rows r0 = 16·warp + g and r1 = r0 + 8 of this lane
  const int m0 = 16 * warp, r0 = m0 + g, r1 = r0 + 8;
  float S[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[nt][e] = 0.f;
  {
    uint32_t qa[kParts][2][4];
#pragma unroll
    for (int part = 0; part < kParts; ++part)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_x4(qa[part][ks], tile(part, 0) + swz32(m0 + a_row, 16 * ks + a_col));
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t kb[kParts][4];
#pragma unroll
        for (int part = 0; part < kParts; ++part)
          ldsm_x4(kb[part], tile(part, 1) + swz32(16 * np + b_row, 16 * ks + b_col));
        // piece products (i, j), smallest first: for f32 inputs (2, 0),
        // (0, 2), (1, 1), (1, 0), (0, 1), then (0, 0)
        constexpr int kTerms = kSplit ? 6 : 1;
        constexpr int kI[6] = {0, 0, 1, 1, 0, 2}, kJ[6] = {0, 1, 0, 1, 2, 0};
#pragma unroll
        for (int term = kTerms - 1; term >= 0; --term) {
          const int i = kI[term], j = kJ[term];
          mma_bf16_16816(S[2 * np], qa[i][ks], kb[j][0], kb[j][1]);
          mma_bf16_16816(S[2 * np + 1], qa[i][ks], kb[j][2], kb[j][3]);
        }
      }
  }

  // ---- P = softmax(scale·cos + z) per row, in base 2, normalised in registers
  const float iq0 = inv[r0], iq1 = inv[r1], sc2 = sc * kLog2e;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = 8 * nt + 2 * t;
    const float2 ik = *reinterpret_cast<const float2*>(inv + kTcRows + j);
    const float2 z0 = *reinterpret_cast<const float2*>(zs + r0 * kTcZLd + j);
    const float2 z1 = *reinterpret_cast<const float2*>(zs + r1 * kTcZLd + j);
    S[nt][0] = fmaf(sc2, S[nt][0] * (iq0 * ik.x), z0.x);  // log2(e)·logit, -inf where padded
    S[nt][1] = fmaf(sc2, S[nt][1] * (iq0 * ik.y), z0.y);
    S[nt][2] = fmaf(sc2, S[nt][2] * (iq1 * ik.x), z1.x);
    S[nt][3] = fmaf(sc2, S[nt][3] * (iq1 * ik.y), z1.y);
    mx0 = fmaxf(mx0, fmaxf(S[nt][0], S[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(S[nt][2], S[nt][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (mx0 == -INFINITY) mx0 = 0.f;  // a padded row: every P is 0
  if (mx1 == -INFINITY) mx1 = 0.f;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    S[nt][0] = exp2f(S[nt][0] - mx0);
    S[nt][1] = exp2f(S[nt][1] - mx0);
    S[nt][2] = exp2f(S[nt][2] - mx1);
    S[nt][3] = exp2f(S[nt][3] - mx1);
    s0 += S[nt][0] + S[nt][1];
    s1 += S[nt][2] + S[nt][3];
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  const float is0 = s0 > 0.f ? 1.f / s0 : 0.f, is1 = s1 > 0.f ? 1.f / s1 : 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    S[nt][0] *= is0;
    S[nt][1] *= is0;
    S[nt][2] *= is1;
    S[nt][3] *= is1;
  }

  // ---- out = P·v: k-step kk (keys 16·kk..) takes its A fragment from the
  // accumulators of n-tiles 2·kk and 2·kk + 1
  float acc[4][4];
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c4][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float(&pa)[4] = S[2 * kk];
    const float(&pb)[4] = S[2 * kk + 1];
    uint32_t ah[4], al[4];
    if constexpr (kRoundP) {
      ah[0] = pack_bf16x2(pa[0], pa[1]);
      ah[1] = pack_bf16x2(pa[2], pa[3]);
      ah[2] = pack_bf16x2(pb[0], pb[1]);
      ah[3] = pack_bf16x2(pb[2], pb[3]);
    } else {
      split_bf16x2(pa[0], pa[1], ah[0], al[0]);
      split_bf16x2(pa[2], pa[3], ah[1], al[1]);
      split_bf16x2(pb[0], pb[1], ah[2], al[2]);
      split_bf16x2(pb[2], pb[3], ah[3], al[3]);
    }
#pragma unroll
    for (int cp = 0; cp < 2; ++cp) {  // output columns 16·cp..
      uint32_t b[kB][4];
#pragma unroll
      for (int part = 0; part < kB; ++part)
        ldsm_x4_t(b[part], tile(part, 2) + swz32(16 * kk + a_row, 16 * cp + a_col));
      if constexpr (!kRoundP) {
        mma_bf16_16816(acc[2 * cp], al, b[0][0], b[0][1]);
        mma_bf16_16816(acc[2 * cp + 1], al, b[0][2], b[0][3]);
      }
      if constexpr (kSplit) {
        mma_bf16_16816(acc[2 * cp], ah, b[1][0], b[1][1]);
        mma_bf16_16816(acc[2 * cp + 1], ah, b[1][2], b[1][3]);
      }
      mma_bf16_16816(acc[2 * cp], ah, b[0][0], b[0][1]);
      mma_bf16_16816(acc[2 * cp + 1], ah, b[0][2], b[0][3]);
    }
  }

  // ---- store, rounded once to T: f32 pairs straight out (a quad writes a
  // row's 32 contiguous bytes of each 8-column tile); bf16 staged through
  // the warp's own q rows, then 16-byte stores (a row's 64 bytes from 4 lanes)
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = 8 * c4 + 2 * t;
      if (r0 < n) *reinterpret_cast<float2*>(out_row(r0) + col) = make_float2(acc[c4][0], acc[c4][1]);
      if (r1 < n) *reinterpret_cast<float2*>(out_row(r1) + col) = make_float2(acc[c4][2], acc[c4][3]);
    }
  } else {
    bf16* const ot = tile(0, 0);  // q rows m0.. are read by this warp alone, and no longer
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = 8 * c4 + 2 * t;
      *reinterpret_cast<uint32_t*>(ot + swz32(r0, col)) = pack_bf16x2(acc[c4][0], acc[c4][1]);
      *reinterpret_cast<uint32_t*>(ot + swz32(r1, col)) = pack_bf16x2(acc[c4][2], acc[c4][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + 8 * i + (lane >> 2), ch = lane & 3;
      if (row < n)
        *reinterpret_cast<uint4*>(out_row(row) + 8 * ch) =
            *reinterpret_cast<const uint4*>(ot + swz32(row, 8 * ch));
    }
  }
}

}  // namespace hvt

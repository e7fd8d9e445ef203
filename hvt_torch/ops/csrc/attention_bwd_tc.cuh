// The cosine attention core's backward for one (window, head) on tensor
// cores: the math of hvt's packed_heads_backward (window_attention_cuda.py's
// plain version), with all five products on mma.sync.m16n8k16 (bf16
// operands, f32 accumulation) at f32 accuracy:
//   q̂ = q·rsqrt(Σq² + 1e-24), k̂ likewise, cos = q̂k̂ᵀ, P = softmax(scale·cos + z)
//   dv = Pᵀ·dO,  dS = P ⊙ (dO·vᵀ − rowsum(dO·vᵀ ⊙ P)),  dz += dS, dscale += Σ dS ⊙ cos
//   dq̂ = scale·dS·k̂, dk̂ = scale·dSᵀ·q̂, dq = (dq̂ − q̂⟨dq̂, q̂⟩)·rsqrt(Σq² + 1e-24), dk likewise.
//
// Shapes: N <= 64 tokens padded to kTcRows = 64 (four 16-row tiles), head
// dim kTcHeadDim = 32. Padded keys get -inf logits, padded rows zero P and
// dS, so the padding adds nothing.
//
// Precision plan (f32 results from bf16 operands):
//   * The normalisation is folded out of the products:
//       cos_ij = (q_i·k_j)·invQ_i·invK_j,  dq̂ = scale·(dS·diag(invK))·k,
//       dk̂ = scale·(diag(invQ)·dS)ᵀ·q,
//     so bf16 q, k, v and dO enter the tensor cores as they are, and cos, dP
//     (hence P, dS, dz and dscale) are exact products summed in f32.
//   * P and the scaled dS, computed in f32, are split into bf16 halves
//     hi = bf16(x), lo = bf16(x − hi) and multiplied as hi·b + lo·b:
//     relative error about 2^-17.
//   * f32 inputs are split into three bf16 pieces (x = p0 + p1 + p2 to
//     about 2^-26). cos and dP take the six products of pieces down to that
//     order (p0p0, p0p1, p1p0, p1p1, p0p2, p2p0), so the logits, which the
//     logit scale (up to 100) multiplies, keep f32 accuracy; the norms and
//     the norm's backward take the three-piece sum; P and the scaled dS meet
//     the first two pieces (hi·p0 + hi·p1 + lo·p0). Two pieces would leave
//     the inputs 2^-18 off, which the scale makes 5-7e-5 of the gradients.
//
// Work split: 4 warps. In the first half each warp owns 16 query rows: it
// computes their cos and dP (accumulator fragments), the softmax and dS in
// registers (row sums are quad shuffles), adds dS into the caller's dz
// fragment (a lane holds the same (i, j) elements in every window, so the
// caller sums windows with no shared memory and no atomics), then dq̂ from
// dS·diag(invK) held as A fragments. In the second half each warp owns 16
// key rows: dv = Pᵀ·dO and dk̂ read P and the scaled dS back from shared
// memory through ldmatrix.trans. Operand tiles live in shared memory with
// their 16-byte chunks XOR-swizzled by row, so ldmatrix and the fragment
// stores are free of bank conflicts.
#pragma once

#include "attention_tc.cuh"

namespace hvt {

// The backward of one (window, head), all kTcThreads threads of the block
// taking part (it synchronises the block inside).
//   x:     this window's inputs, kParts x 4 tiles (q, k, v, dO) of kTcRows x
//          kTcHeadDim bf16 (swz32): piece 0 of each, then for kParts = 3
//          (f32 inputs) pieces 1 and 2; rows at or beyond n are zero. Read only.
//   ps:    2 x kTcRows x kTcRows bf16 scratch (swz64), high and low parts of
//          P, then of diag(invQ)·dS.
//   inv:   2 x kTcRows f32 scratch (invQ, invK).
//   zs:    kTcRows x kTcZLd f32: the bias(+mask) of this window and head
//          times log2(e), -inf at or beyond row or column n (the softmax runs
//          in base 2: exp2(log2(e)·(scale·cos + z) − max)).
//   dz:    the lane's dS fragment sum (rows 16·warp + lane/4 (+8), columns
//          8·tile + 2·(lane%4) (+1)); dscale: the lane's Σ dS ⊙ cos.
//   store(op, row, col, v0, v1): op 0 dq, 1 dk, 2 dv at (row, col), (row, col + 1).
// On return every read of x and ps may still be in flight in other warps:
// the caller synchronises before it overwrites either.
template <int kParts, typename StoreFn>
__device__ __forceinline__ void attention_window_bwd_tc(const bf16* __restrict__ x,
                                                        bf16* __restrict__ ps,
                                                        float* __restrict__ inv, int n, float sc,
                                                        const float* __restrict__ zs,
                                                        float (&dz)[8][4], float& dscale,
                                                        StoreFn store) {
  static_assert(kParts == 1 || kParts == 3, "bf16 inputs, or f32 inputs in three pieces");
  constexpr bool kSplit = kParts == 3;
  constexpr int kB = kSplit ? 2 : 1;  // input pieces that meet P and the scaled dS
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4 row addresses: (a_row, a_col) for A fragments and k-major B
  // (.trans), (b_row, b_col) for n-major B and k-major A (.trans).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  auto tile = [&](int part, int op) { return x + (part * 4 + op) * kTcTile; };
  bf16* const ph = ps;
  bf16* const pl = ps + kTcRows * kTcRows;

  tc_inverse_norms<kParts, 4>(x, inv);  // invQ, invK
  __syncthreads();

  // dx = (scale·acc − x·inv²·⟨scale·acc, x⟩)·inv for the 16 rows row0.. of
  // x = q (op 0) or k (op 1), handed to store.
  auto finish = [&](float (&acc)[4][4], int op, int row0) {
    const int ra = row0 + g, rb = ra + 8;
    const float ia = inv[op * kTcRows + ra], ib = inv[op * kTcRows + rb];
    float xa[4][2], xb[4][2], da = 0.f, db = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = 8 * c4 + 2 * t;
      float2 va = make_float2(0.f, 0.f), vb = va;
#pragma unroll
      for (int part = kParts - 1; part >= 0; --part) {  // the pieces' sum, smallest first
        const float2 pa =
            unpack_bf16x2(*reinterpret_cast<const uint32_t*>(tile(part, op) + swz32(ra, col)));
        const float2 pb =
            unpack_bf16x2(*reinterpret_cast<const uint32_t*>(tile(part, op) + swz32(rb, col)));
        va.x += pa.x; va.y += pa.y; vb.x += pb.x; vb.y += pb.y;
      }
      xa[c4][0] = va.x; xa[c4][1] = va.y; xb[c4][0] = vb.x; xb[c4][1] = vb.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c4][e] *= sc;
      da += acc[c4][0] * va.x + acc[c4][1] * va.y;
      db += acc[c4][2] * vb.x + acc[c4][3] * vb.y;
    }
    da = quad_sum(da) * ia * ia;
    db = quad_sum(db) * ib * ib;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = 8 * c4 + 2 * t;
      if (ra < n)
        store(op, ra, col, (acc[c4][0] - xa[c4][0] * da) * ia, (acc[c4][1] - xa[c4][1] * da) * ia);
      if (rb < n)
        store(op, rb, col, (acc[c4][2] - xb[c4][0] * db) * ib, (acc[c4][3] - xb[c4][1] * db) * ib);
    }
  };

  // acc[c] (16 key rows j0.. x 32 columns) += Aᵀ·B where A = ps (hi and lo,
  // rows = queries, columns = keys) and B = the tile `op` (rows = queries).
  auto key_rows_product = [&](float (&acc)[4][4], int op, int j0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, ph + swz64(16 * kk + b_row, j0 + b_col));
      ldsm_x4_t(al, pl + swz64(16 * kk + b_row, j0 + b_col));
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        uint32_t b[kB][4];
#pragma unroll
        for (int part = 0; part < kB; ++part)
          ldsm_x4_t(b[part], tile(part, op) + swz32(16 * kk + a_row, 16 * cp + a_col));
        mma_bf16_16816(acc[2 * cp], ah, b[0][0], b[0][1]);
        mma_bf16_16816(acc[2 * cp + 1], ah, b[0][2], b[0][3]);
        mma_bf16_16816(acc[2 * cp], al, b[0][0], b[0][1]);
        mma_bf16_16816(acc[2 * cp + 1], al, b[0][2], b[0][3]);
        if constexpr (kSplit) {
          mma_bf16_16816(acc[2 * cp], ah, b[1][0], b[1][1]);
          mma_bf16_16816(acc[2 * cp + 1], ah, b[1][2], b[1][3]);
        }
      }
    }
  };

  // ---- query rows r0 = 16·warp + g and r1 = r0 + 8 of this lane
  const int m0 = 16 * warp, r0 = m0 + g, r1 = r0 + 8;
  float S[8][4], dP[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[nt][e] = dP[nt][e] = 0.f;
  {  // S = q·kᵀ, dP = dO·vᵀ
    uint32_t qa[kParts][2][4], ga[kParts][2][4];
#pragma unroll
    for (int part = 0; part < kParts; ++part)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        ldsm_x4(qa[part][ks], tile(part, 0) + swz32(m0 + a_row, 16 * ks + a_col));
        ldsm_x4(ga[part][ks], tile(part, 3) + swz32(m0 + a_row, 16 * ks + a_col));
      }
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t kb[kParts][4], vb[kParts][4];
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          ldsm_x4(kb[part], tile(part, 1) + swz32(16 * np + b_row, 16 * ks + b_col));
          ldsm_x4(vb[part], tile(part, 2) + swz32(16 * np + b_row, 16 * ks + b_col));
        }
        // piece products (i, j), largest first: (0, 0), then for f32 inputs
        // (0, 1), (1, 0), (1, 1), (0, 2), (2, 0)
        constexpr int kTerms = kSplit ? 6 : 1;
        constexpr int kI[6] = {0, 0, 1, 1, 0, 2}, kJ[6] = {0, 1, 0, 1, 2, 0};
#pragma unroll
        for (int term = kTerms - 1; term >= 0; --term) {
          const int i = kI[term], j = kJ[term];
          mma_bf16_16816(S[2 * np], qa[i][ks], kb[j][0], kb[j][1]);
          mma_bf16_16816(S[2 * np + 1], qa[i][ks], kb[j][2], kb[j][3]);
          mma_bf16_16816(dP[2 * np], ga[i][ks], vb[j][0], vb[j][1]);
          mma_bf16_16816(dP[2 * np + 1], ga[i][ks], vb[j][2], vb[j][3]);
        }
      }
  }

  // cos, then P = softmax(scale·cos + z) per row (a row lives in one quad)
  const float iq0 = inv[r0], iq1 = inv[r1], sc2 = sc * kLog2e;
  float P[8][4];
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = 8 * nt + 2 * t;
    const float2 ik = *reinterpret_cast<const float2*>(inv + kTcRows + j);
    const float2 z0 = *reinterpret_cast<const float2*>(zs + r0 * kTcZLd + j);
    const float2 z1 = *reinterpret_cast<const float2*>(zs + r1 * kTcZLd + j);
    S[nt][0] *= iq0 * ik.x;
    S[nt][1] *= iq0 * ik.y;
    S[nt][2] *= iq1 * ik.x;
    S[nt][3] *= iq1 * ik.y;
    P[nt][0] = fmaf(sc2, S[nt][0], z0.x);  // log2(e)·logit, -inf where padded
    P[nt][1] = fmaf(sc2, S[nt][1], z0.y);
    P[nt][2] = fmaf(sc2, S[nt][2], z1.x);
    P[nt][3] = fmaf(sc2, S[nt][3], z1.y);
    mx0 = fmaxf(mx0, fmaxf(P[nt][0], P[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(P[nt][2], P[nt][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (mx0 == -INFINITY) mx0 = 0.f;  // a padded row: every P is 0
  if (mx1 == -INFINITY) mx1 = 0.f;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    P[nt][0] = exp2f(P[nt][0] - mx0);
    P[nt][1] = exp2f(P[nt][1] - mx0);
    P[nt][2] = exp2f(P[nt][2] - mx1);
    P[nt][3] = exp2f(P[nt][3] - mx1);
    s0 += P[nt][0] + P[nt][1];
    s1 += P[nt][2] + P[nt][3];
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  const float is0 = s0 > 0.f ? 1.f / s0 : 0.f, is1 = s1 > 0.f ? 1.f / s1 : 0.f;
  float rs0 = 0.f, rs1 = 0.f;  // Σ_j dP ⊙ P
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    P[nt][0] *= is0;
    P[nt][1] *= is0;
    P[nt][2] *= is1;
    P[nt][3] *= is1;
    rs0 += dP[nt][0] * P[nt][0] + dP[nt][1] * P[nt][1];
    rs1 += dP[nt][2] * P[nt][2] + dP[nt][3] * P[nt][3];
  }
  rs0 = quad_sum(rs0);
  rs1 = quad_sum(rs1);
  // dS = P ⊙ (dP − rowsum) into dP; dz, dscale; P's halves to ps
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ds = P[nt][e] * (dP[nt][e] - (e < 2 ? rs0 : rs1));
      dP[nt][e] = ds;
      dz[nt][e] += ds;
      dscale += ds * S[nt][e];
    }
    const int col = 8 * nt + 2 * t;
    uint32_t hi, lo;
    split_bf16x2(P[nt][0], P[nt][1], hi, lo);
    *reinterpret_cast<uint32_t*>(ph + swz64(r0, col)) = hi;
    *reinterpret_cast<uint32_t*>(pl + swz64(r0, col)) = lo;
    split_bf16x2(P[nt][2], P[nt][3], hi, lo);
    *reinterpret_cast<uint32_t*>(ph + swz64(r1, col)) = hi;
    *reinterpret_cast<uint32_t*>(pl + swz64(r1, col)) = lo;
  }

  {  // dq̂/scale = (dS·diag(invK))·k, the A fragments straight from dS's accumulators
    float acc[4][4];
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c4][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 ka = *reinterpret_cast<const float2*>(inv + kTcRows + 16 * kk + 2 * t);
      const float2 kb = *reinterpret_cast<const float2*>(inv + kTcRows + 16 * kk + 8 + 2 * t);
      uint32_t ah[4], al[4];
      split_bf16x2(dP[2 * kk][0] * ka.x, dP[2 * kk][1] * ka.y, ah[0], al[0]);
      split_bf16x2(dP[2 * kk][2] * ka.x, dP[2 * kk][3] * ka.y, ah[1], al[1]);
      split_bf16x2(dP[2 * kk + 1][0] * kb.x, dP[2 * kk + 1][1] * kb.y, ah[2], al[2]);
      split_bf16x2(dP[2 * kk + 1][2] * kb.x, dP[2 * kk + 1][3] * kb.y, ah[3], al[3]);
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        uint32_t b[kB][4];
#pragma unroll
        for (int part = 0; part < kB; ++part)
          ldsm_x4_t(b[part], tile(part, 1) + swz32(16 * kk + a_row, 16 * cp + a_col));
        mma_bf16_16816(acc[2 * cp], ah, b[0][0], b[0][1]);
        mma_bf16_16816(acc[2 * cp + 1], ah, b[0][2], b[0][3]);
        mma_bf16_16816(acc[2 * cp], al, b[0][0], b[0][1]);
        mma_bf16_16816(acc[2 * cp + 1], al, b[0][2], b[0][3]);
        if constexpr (kSplit) {
          mma_bf16_16816(acc[2 * cp], ah, b[1][0], b[1][1]);
          mma_bf16_16816(acc[2 * cp + 1], ah, b[1][2], b[1][3]);
        }
      }
    }
    finish(acc, 0, m0);
  }
  __syncthreads();  // P is in ps

  // ---- key rows 16·warp..: dv = Pᵀ·dO
  const int j0 = 16 * warp;
  {
    float acc[4][4];
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c4][e] = 0.f;
    key_rows_product(acc, 3, j0);
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int col = 8 * c4 + 2 * t;
      if (j0 + g < n) store(2, j0 + g, col, acc[c4][0], acc[c4][1]);
      if (j0 + g + 8 < n) store(2, j0 + g + 8, col, acc[c4][2], acc[c4][3]);
    }
  }
  __syncthreads();  // every read of P is done
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {  // diag(invQ)·dS over P in ps
    const int col = 8 * nt + 2 * t;
    uint32_t hi, lo;
    split_bf16x2(dP[nt][0] * iq0, dP[nt][1] * iq0, hi, lo);
    *reinterpret_cast<uint32_t*>(ph + swz64(r0, col)) = hi;
    *reinterpret_cast<uint32_t*>(pl + swz64(r0, col)) = lo;
    split_bf16x2(dP[nt][2] * iq1, dP[nt][3] * iq1, hi, lo);
    *reinterpret_cast<uint32_t*>(ph + swz64(r1, col)) = hi;
    *reinterpret_cast<uint32_t*>(pl + swz64(r1, col)) = lo;
  }
  __syncthreads();
  {  // dk̂/scale = (diag(invQ)·dS)ᵀ·q
    float acc[4][4];
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c4][e] = 0.f;
    key_rows_product(acc, 0, j0);
    finish(acc, 1, j0);
  }
}

}  // namespace hvt

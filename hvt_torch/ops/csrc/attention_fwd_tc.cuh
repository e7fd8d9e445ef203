// The cosine attention core's forward for one (window, head) on tensor
// cores, and attention_fwd_tc_kernel, which runs it per (chunk of images,
// window id, head) for window_attention.cu's two forwards and the retired
// attention branch (swin_block.cu): the math of cosine_attention (common.cuh),
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

// ---- the kernel: one block per (chunk of images, window id, head)

template <typename T>
constexpr size_t tc_fwd_smem_bytes() {
  return sizeof(bf16) * 2 * tc_pieces<T>() * 3 * kTcTile +
         sizeof(float) * (kTcRows * kTcZLd + 2 * kTcRows);
}

inline bool tc_forward_takes(int n, int d) { return n >= 1 && n <= kTcRows && d == kTcHeadDim; }

// q, k, v in the layout `in`, out in `ot`; window w (< nwb) has window id
// w mod nwz, and the chunk's image b covers window b·nwz + wz; rows 16-byte
// aligned. Blocks an SM: as many as shared memory admits, 5 in bf16 (43.5 KB
// each; the cap leaves 102 registers a thread, ptxas uses 80-88) and 2 in
// f32 (92.7 KB each; 140 registers).
template <typename T, bool kRoundP>
__global__ void __launch_bounds__(kTcThreads, sizeof(T) == 4 ? 2 : 5)
attention_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        HeadTiles in, const float* __restrict__ scale, const float* __restrict__ z,
                        int nwz, T* __restrict__ out, HeadTiles ot, int nwb, int per_block, int n,
                        int heads) {
  constexpr int kParts = tc_pieces<T>(), kStage = kParts * 3 * kTcTile;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* const stages = reinterpret_cast<bf16*>(tc_smem);
  float* const zs = reinterpret_cast<float*>(stages + 2 * kStage);
  float* const inv = zs + kTcRows * kTcZLd;

  const int wz = blockIdx.x % nwz, chunk = blockIdx.x / nwz, h = blockIdx.y;
  // the images b with window b·nwz + wz < nwb (the last image may be partial)
  const int b0 = chunk * per_block, b_end = min(b0 + per_block, (nwb - wz + nwz - 1) / nwz);
  if (b0 >= b_end) return;
  const float sc = scale[h];
  tc_load_z(zs, z + ((size_t)wz * heads + h) * n * n, n);  // the same for every window of the chunk
  tc_zero_pad_rows(stages, 2 * kParts * 3, n);  // the loads below write rows < n only
  auto load = [&](int b, int s) {
    const int w = b * nwz + wz;
    tc_load_tiles<T, 3>(stages + s * kStage, n, [&](int op, int row) {
      return (op == 0 ? q : op == 1 ? k : v) + in.at(w, h, row);
    });
  };

  load(b0, 0);
  for (int b = b0; b < b_end; ++b) {
    const int s = (b - b0) & 1;
    // the other buffer was last read in the previous window, which ended in a barrier
    if (b + 1 < b_end) load(b + 1, s ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();  // window b's group has landed
    __syncthreads();
    const int w = b * nwz + wz;
    attention_window_fwd_tc<T, kRoundP>(stages + s * kStage, inv, n, sc, zs,
                                        [&](int row) { return out + ot.at(w, h, row); });
    __syncthreads();  // this window's buffers and inv are free
  }
}

template <typename T, bool kRoundP>
int launch_attention_fwd_tc(const void* q, const void* k, const void* v, HeadTiles in,
                            const float* scale, const float* z, int nwz, void* out, HeadTiles ot,
                            int nwb, int n, int heads, int per_block, int chunks,
                            cudaStream_t stream) {
  const size_t smem = tc_fwd_smem_bytes<T>();
  auto kernel = attention_fwd_tc_kernel<T, kRoundP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(chunks * nwz, heads), kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), in, scale, z,
      nwz, static_cast<T*>(out), ot, nwb, per_block, n, heads);
  return (int)cudaGetLastError();
}

}  // namespace hvt

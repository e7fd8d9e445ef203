// The backward of the MLP half with its hidden dim in K chunks (training
// blocks whose unchunked MLP does not fit hvt's fused budget: SwinV2-B's
// C = 1024 stage):
//
//   hvt_mlp_half_chunked_bwd: every gradient of the branch
//                             LN(Σₖ gelu(x·W1ₖ + b1ₖ)·W2ₖ + b2) given g, from x
//                             and the saved pre-LN sum `pre`
//
// Its forward, hvt_mlp_half_chunked_fwd, is the unchunked MLP kernel storing
// `pre` as well (fused_halves.cu, kPre).
//
// Replaces: hvt/ops/fused_halves_pallas.py `_mlp_chunk_backward` (pallas_call
// at line 627, body `_mlp_chunk_bwd_kernel`) with its caller
// `_mlp_chunked_bwd` (659): one launch here computes what hvt's K calls and
// the XLA sum after them compute.
//
// Arithmetic contract, hvt's: every product rounds its operands to bf16 and
// accumulates in f32 (_dot/_dot_t, the weight gradients included); GELU and
// its derivative by the A&S erf polynomial; LayerNorm and its backward in
// f32. The forward stores the pre-LN sum rounded to x's dtype, and the
// backward re-derives the LayerNorm statistics from that rounded sum, not
// from a recomputed fc2. Each chunk's dx partial dpreₖ·W1ₖ is rounded to
// x's dtype, the partials are summed in f32 and the sum is rounded once
// more: K enters the result only through that rounding.
//
// What bounds it on the H100: the operations. At SwinV2-B's stage 4 in
// training (T = 6,272 at batch 128, C = 1,024) it does 10·T·C·4C = 2.63e11
// FLOP (fc1 recomputed, dh, dx, dW1 and dW2; the saved pre stands in for
// fc2: 0.266 ms at 989 TFLOP/s), against some 64 MB of bf16 activations,
// f32 weight gradients and bf16 weights.
//
// Design. The unchunked backward's row kernel would hold x, W1 and W2
// slices, the dout tile and, for the chunk roundings, a second (32 x C) f32
// dx sum; at C = 1024 that is about 283 KB of shared memory and 256
// accumulators a thread. So the work is split into kernels whose tiles do
// not grow with C, each an mma.sync product over 64 x 64 output tiles:
//   1. `chunked_ln_bwd_kernel`, one warp per row: the LayerNorm statistics
//      of the saved pre, dout = _ln_bwd(g, normed, inv, lns) (f32, stored
//      bf16) and per-block column sums of dout, g·normed and g;
//   2. `chunked_hidden_kernel`, per (64 rows, 64 hidden units): fc1
//      recomputed and dh = dout·W2ᵀ, two products over C; then h =
//      gelu(pre₁), dpre = dh·gelu′(pre₁) (h and dpre stored bf16) and
//      per-block column sums of dpre (db1);
//   3. `chunked_dx_kernel`, per (64 rows, 64 channels): dpre·W1 over the
//      4C hidden units, its f32 sum rounded to bf16 at the end of each
//      chunk of 4C/K units and added to an f32 total, rounded at the store;
//   4. dW1 = Σ dpreᵀx and dW2 = Σ doutᵀh by grad_tn (fused_halves_bwd.cuh),
//      and the column sums' partials by sum_parts, both in a fixed order.
// Every result is deterministic (no atomics). h, dpre (T, 4C) and dout
// (T, C) pass through device memory in bf16, as in the unchunked backward:
// they are the weight-gradient products' operands, which the contract
// rounds to bf16 anyway.
// This first version is simple: no cp.async/TMA pipeline and scalar gathers
// of k-major operands; wgmma is later work.
#include "fused_halves_bwd.cuh"

namespace hvt {

constexpr int kLnRows = 64;  // rows of chunked_ln_bwd_kernel's block: 8 per warp
constexpr int kTile = 64;    // rows and columns of the hidden and dx kernels' output tile
constexpr int kLDT = kTile + 8;  // row stride of a k-major (32 x 64) weight tile

// One warp per row of pre (T, C) and g: the row's LayerNorm statistics
// (two-pass, eps 1e-5, as _ln_fwd), normed, dout = (gn − mean(gn) −
// normed·mean(gn·normed))·inv with gn = g·lns (_ln_bwd), stored bf16. Lane l
// owns the column pairs 2l + 64v. Each warp sums its rows' dout, g·normed and
// g per column in its own row of shared memory; the block adds the 8 rows in
// order into part[block] = [db2 | dlns | dlnb] (3C floats).
template <int C>
__global__ void __launch_bounds__(kThreads)
chunked_ln_bwd_kernel(const bf16* __restrict__ pre, const bf16* __restrict__ gout,
                      const float* __restrict__ lns, bf16* __restrict__ dout,
                      float* __restrict__ part, int T) {
  constexpr int V = C / 64;
  extern __shared__ uint4 smem_u4[];
  float* sums = reinterpret_cast<float*>(smem_u4);  // [warp][3][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = sums + warp * 3 * C;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      cs[q * C + 64 * v + 2 * lane] = 0.f;
      cs[q * C + 64 * v + 2 * lane + 1] = 0.f;
    }
  for (int r = warp; r < kLnRows; r += kThreads / 32) {
    const int row = blockIdx.x * kLnRows + r;
    if (row >= T) break;
    float p[V][2], gg[V][2];
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const size_t off = (size_t)row * C + 64 * v + 2 * lane;
      const __nv_bfloat162 pv = *reinterpret_cast<const __nv_bfloat162*>(pre + off);
      const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(gout + off);
      p[v][0] = __low2float(pv); p[v][1] = __high2float(pv);
      gg[v][0] = __low2float(gv); gg[v][1] = __high2float(gv);
      s += p[v][0] + p[v][1];
    }
    const float mu = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v][0] -= mu; p[v][1] -= mu;
      var += p[v][0] * p[v][0] + p[v][1] * p[v][1];
    }
    const float inv = rsqrtf(warp_sum(var) / C + 1e-5f);
    float a = 0.f, m = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[v][e] *= inv;  // normed
        const float gn = gg[v][e] * lns[64 * v + 2 * lane + e];
        a += gn;
        m += gn * p[v][e];
      }
    a = warp_sum(a) / C;
    m = warp_sum(m) / C;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = 64 * v + 2 * lane;
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        d[e] = (gg[v][e] * lns[col + e] - a - p[v][e] * m) * inv;
        cs[col + e] += d[e];
        cs[C + col + e] += gg[v][e] * p[v][e];
        cs[2 * C + col + e] += gg[v][e];
      }
      *reinterpret_cast<uint32_t*>(dout + (size_t)row * C + col) = pack_bf16x2(d[0], d[1]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += sums[w * 3 * C + i];
    part[(size_t)blockIdx.x * 3 * C + i] = t;
  }
}

// Per (64 rows, 64 hidden units h0..): pre₁ = x·W1[h0..]ᵀ + b1 and dh =
// dout·W2[:, h0..], both over C in slices of 32; h = gelu(pre₁) and dpre =
// dh·gelu′(pre₁) go out bf16 to (T, 4C), and the block's column sums of dpre
// (f32, its valid rows) to part[blockIdx.y][h0..]. Warps 4 (rows) x 2
// (columns), each a 16 x 32 tile.
__global__ void __launch_bounds__(kThreads)
chunked_hidden_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ dout, bf16* __restrict__ hid,
                      bf16* __restrict__ dpre, float* __restrict__ part, int T, int C) {
  __shared__ __align__(16) bf16 Xs[kTile * kLDK];
  __shared__ __align__(16) bf16 W1s[kTile * kLDK];
  __shared__ __align__(16) bf16 Ds[kTile * kLDK];
  __shared__ __align__(16) bf16 W2s[kKS * kLDT];
  __shared__ float red[4][kTile];
  const int HID = 4 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
  auto rows_of = [&](const bf16* base, int ld, int k0) {
    return [=](int r) -> const bf16* {
      return row0 + r < T ? base + (size_t)(row0 + r) * ld + k0 : nullptr;
    };
  };
  float pa[4][4], da[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[j][e] = da[j][e] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kKS) {
    __syncthreads();
    copy_rows(Xs, kLDK, kTile, kKS, rows_of(x, C, k0));
    copy_rows(Ds, kLDK, kTile, kKS, rows_of(dout, C, k0));
    copy_rows(W1s, kLDK, kTile, kKS, [&](int r) { return w1 + (size_t)(h0 + r) * C + k0; });
    copy_rows(W2s, kLDT, kKS, kTile, [&](int r) { return w2 + (size_t)(k0 + r) * HID + h0; });
    __syncthreads();
    warp_mma<4, kKS>(pa, Xs + wm * 16 * kLDK, kLDK, 16, W1s + wn * 32 * kLDK, kLDK);
    warp_mma_kn<4, kKS>(da, Ds + wm * 16 * kLDK, kLDK, 16, W2s + wn * 32, kLDT);
  }
  float cs[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + 2 * t;
    const float bb[2] = {b1[h0 + col], b1[h0 + col + 1]};
    cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 16 + g + 8 * half;
      float hv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float gd;
        hv[e] = gelu_as(pa[j][2 * half + e] + bb[e], &gd);
        dv[e] = row < T ? da[j][2 * half + e] * gd : 0.f;
        cs[j][e] += dv[e];
      }
      if (row < T) {
        const size_t off = (size_t)row * HID + h0 + col;
        *reinterpret_cast<uint32_t*>(hid + off) = pack_bf16x2(hv[0], hv[1]);
        *reinterpret_cast<uint32_t*>(dpre + off) = pack_bf16x2(dv[0], dv[1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], o);
    }
    if (g == 0) { red[wm][col] = cs[j][0]; red[wm][col + 1] = cs[j][1]; }
  }
  __syncthreads();
  if (threadIdx.x < kTile)
    part[(size_t)blockIdx.y * HID + h0 + threadIdx.x] =
        red[0][threadIdx.x] + red[1][threadIdx.x] + red[2][threadIdx.x] + red[3][threadIdx.x];
}

// Per (64 rows, 64 channels c0..): dx = Σₖ bf16(dpre[:, chunk k]·W1[chunk k, c0..]),
// the products over the 4C hidden units in slices of 32, each chunk's f32
// sum (hk units) rounded to bf16 and added to an f32 total, which is
// rounded once more at the store. Warps 4 (rows) x 2 (columns).
__global__ void __launch_bounds__(kThreads)
chunked_dx_kernel(const bf16* __restrict__ dpre, const bf16* __restrict__ w1,
                  bf16* __restrict__ dx, int T, int C, int hk) {
  __shared__ __align__(16) bf16 Ps[kTile * kLDK];
  __shared__ __align__(16) bf16 W1s[kKS * kLDT];
  const int HID = 4 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
  float acc[4][4], tot[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = tot[j][e] = 0.f;
  for (int k0 = 0; k0 < HID; k0 += kKS) {
    __syncthreads();
    copy_rows(Ps, kLDK, kTile, kKS, [&](int r) -> const bf16* {
      return row0 + r < T ? dpre + (size_t)(row0 + r) * HID + k0 : nullptr;
    });
    copy_rows(W1s, kLDT, kKS, kTile, [&](int r) { return w1 + (size_t)(k0 + r) * C + c0; });
    __syncthreads();
    warp_mma_kn<4, kKS>(acc, Ps + wm * 16 * kLDK, kLDK, 16, W1s + wn * 32, kLDT);
    if ((k0 + kKS) % hk == 0) {  // the end of a chunk: its partial, rounded, joins the total
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[j][e] += round_bf16(acc[j][e]);
          acc[j][e] = 0.f;
        }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = c0 + wn * 32 + j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 16 + g + 8 * half;
      if (row < T)
        *reinterpret_cast<uint32_t*>(dx + (size_t)row * C + col) =
            pack_bf16x2(tot[j][2 * half], tot[j][2 * half + 1]);
    }
  }
}

template <int C>
int launch_chunked_bwd(const void* x, const void* w1, const float* b1, const void* w2,
                       const float* lns, const void* pre, const void* g, void* dx, float* dw1,
                       float* dw2, float* dsmall, void* hid, void* dpre, void* dout,
                       float* part_ln, float* part_h, float* wpart, int splits1, int splits2,
                       int hk, int T, cudaStream_t st) {
  constexpr int HID = 4 * C;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hb = static_cast<bf16*>(hid);
  bf16* pb = static_cast<bf16*>(dpre);
  bf16* db = static_cast<bf16*>(dout);
  int err;

  auto ln = chunked_ln_bwd_kernel<C>;
  const size_t smem_ln = sizeof(float) * (kThreads / 32) * 3 * C;
  if ((err = allow_smem(ln, smem_ln))) return err;
  const int ln_blocks = (T + kLnRows - 1) / kLnRows;
  ln<<<ln_blocks, kThreads, smem_ln, st>>>(static_cast<const bf16*>(pre),
                                           static_cast<const bf16*>(g), lns, db, part_ln, T);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(part_ln, ln_blocks, 3LL * C, dsmall + HID, st))) return err;

  const int row_tiles = (T + kTile - 1) / kTile;
  chunked_hidden_kernel<<<dim3(HID / kTile, row_tiles), kThreads, 0, st>>>(
      xb, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), db, hb, pb, part_h, T,
      C);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(part_h, row_tiles, HID, dsmall, st))) return err;

  chunked_dx_kernel<<<dim3(C / kTile, row_tiles), kThreads, 0, st>>>(
      pb, static_cast<const bf16*>(w1), static_cast<bf16*>(dx), T, C, hk);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = grad_tn(pb, xb, dw1, wpart, splits1, T, HID, C, st))) return err;
  return grad_tn(db, hb, dw2, wpart, splits2, T, C, HID, st);
}

}  // namespace hvt

// Widths built: SwinV2-B's stage 4, the one width hvt chunks at its default
// budget (the forward's list in fused_halves.cu is the same). Another width,
// or a chunk of the hidden dim that is not a multiple of 32 dividing 4C,
// returns -1.
#define HVT_CHUNKED_WIDTHS(F) F(1024)

// x, pre, g, dx (T, C) bf16; w1 (4C, C), w2 (C, 4C) bf16; b1, lns f32; hk
// hidden units per chunk. Outputs f32: dw1 (4C, C), dw2 (C, 4C) and dsmall =
// [db1 (4C) | db2 | dlns | dlnb]. Scratch: hid, dpre (T, 4C) and dout (T, C)
// bf16; part_ln ceil(T/64)·3C and part_h ceil(T/64)·4C floats; wpart
// max(splits)·4C·C floats (unused where both splits are 1). Returns a
// cudaError_t, or -1.
extern "C" int hvt_mlp_half_chunked_bwd(const void* x, const void* w1, const float* b1,
                                        const void* w2, const float* lns, const void* pre,
                                        const void* g, void* dx, float* dw1, float* dw2,
                                        float* dsmall, void* hid, void* dpre, void* dout,
                                        float* part_ln, float* part_h, float* wpart, int splits1,
                                        int splits2, int hk, int t, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hk <= 0 || hk % hvt::kKS || (4 * c) % hk) return -1;
  switch (c) {
#define HVT_CASE(CC)                                                                           \
  case CC:                                                                                     \
    return hvt::launch_chunked_bwd<CC>(x, w1, b1, w2, lns, pre, g, dx, dw1, dw2, dsmall, hid, \
                                       dpre, dout, part_ln, part_h, wpart, splits1, splits2,  \
                                       hk, t, st);
    HVT_CHUNKED_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

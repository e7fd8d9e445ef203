// Device code shared by the fused SwinV2 block halves' forward
// (fused_halves.cu, attention_half.cu) and backward (fused_halves_bwd.cu):
// the forward of each half up to its pre-LayerNorm sum, which the backward
// recomputes, the attention half's token layouts and its forward kernel.
#pragma once

#include "common.cuh"

namespace hvt {

constexpr int kThreads = 256;  // 8 warps
constexpr int kKS = 32;        // k-slice of streamed weight tiles
constexpr int kLDK = kKS + 8;  // padded row stride of a k-slice tile (bank-conflict free)
constexpr int kD = 32;              // head dim (every SwinV2 variant)
constexpr int kLDQ = 3 * kD + 1;    // f32 row stride of the per-head q|k|v tile (odd)

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// MLP half: a block owns 32 rows of x (T, C)
// ---------------------------------------------------------------------------

template <int C>
struct MlpSmem {
  static constexpr int BM = 32, HC = 32, LDX = C + 8;
  static constexpr size_t x = 0;
  static constexpr size_t w1 = x + align16(sizeof(bf16) * BM * LDX);
  static constexpr size_t w2 = w1 + align16(sizeof(bf16) * HC * LDX);
  static constexpr size_t h = w2 + align16(sizeof(bf16) * C * kLDK);
  static constexpr size_t red = h + align16(sizeof(bf16) * BM * kLDK);
  static constexpr size_t bytes = red + sizeof(float) * 128;
};

// fc2(GELU(fc1 x)) of the block's 32 rows (Xs, bf16 in shared memory) into
// acc, without b2: the 4C hidden dim is streamed in chunks of HC = 32 —
// fc1 of the chunk -> bias -> GELU -> bf16 in Hs -> accumulated into the
// 32 x C fc2 result held as fragments by warps 2 (rows) x 4 (columns).
template <int C>
__device__ __forceinline__ void mlp_fc_chunks(float (&acc)[C / 32][4], const bf16* Xs, bf16* W1s,
                                              bf16* W2s, bf16* Hs, const bf16* __restrict__ w1,
                                              const float* __restrict__ b1,
                                              const bf16* __restrict__ w2) {
  using L = MlpSmem<C>;
  constexpr int HC = L::HC, LDX = L::LDX, HID = 4 * C, NT = C / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int h0 = 0; h0 < HID; h0 += HC) {
    __syncthreads();  // the previous chunk is done with W1s, W2s and Hs
    copy_rows(W1s, LDX, HC, C, [&](int r) { return w1 + (size_t)(h0 + r) * C; });
    copy_rows(W2s, kLDK, C, HC, [&](int r) { return w2 + (size_t)r * HID + h0; });
    __syncthreads();

    // fc1 on this hidden chunk: warp (wm, wn) -> rows 16·wm.., hidden cols 8·wn..
    float hacc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    warp_mma<1, C>(hacc, Xs + wm * 16 * LDX, LDX, 16, W1s + wn * 8 * LDX, LDX);
    const int col = wn * 8 + 2 * t;
    const float bb0 = b1[h0 + col], bb1 = b1[h0 + col + 1];
    *reinterpret_cast<uint32_t*>(Hs + (wm * 16 + g) * kLDK + col) =
        pack_bf16x2(gelu_as(hacc[0][0] + bb0), gelu_as(hacc[0][1] + bb1));
    *reinterpret_cast<uint32_t*>(Hs + (wm * 16 + g + 8) * kLDK + col) =
        pack_bf16x2(gelu_as(hacc[0][2] + bb0), gelu_as(hacc[0][3] + bb1));
    __syncthreads();

    // fc2 partial: rows 16·wm.., output cols wn·C/4..
    warp_mma<NT, HC>(acc, Hs + wm * 16 * kLDK, kLDK, 16, W2s + wn * (C / 4) * kLDK, kLDK);
  }
}

// ---------------------------------------------------------------------------
// Attention half: a block owns one window of one image
// ---------------------------------------------------------------------------

// A head's qkv weight slices (WA) and its logits (S) are never live at the
// same time, so they share one region: at C = 1024 that is what brings the
// window's layout (tokens and outputs, 2 x 101 KB) under the 227 KB a block
// may have. The epilogues' 128 floats of row sums (red) reuse S's space
// after the heads.
struct AttnSmem {
  size_t x, o, qkv, s, wa, red, bytes;
  __host__ __device__ AttnSmem(int n, int c) {
    const int ldx = c + 8;
    const size_t r1 = sizeof(bf16) * (size_t)(n * ldx > c * kLDK ? n * ldx : c * kLDK);
    x = 0;  // the gathered tokens, later the streamed proj weight slices
    o = x + align16(r1);
    qkv = o + align16(sizeof(bf16) * n * ldx);
    s = qkv + align16(sizeof(float) * n * kLDQ);
    wa = s;
    red = s;
    const size_t s_bytes = sizeof(float) * n * (n + 1);
    const size_t wa_bytes = sizeof(bf16) * 3 * kD * kLDK;
    bytes = s + align16(s_bytes > wa_bytes ? s_bytes : wa_bytes);
  }
};

// Per head: q|k|v = x·W_h + b_h (tensor cores, f32 into QKV) -> the f32
// cosine attention core -> the head's output, bf16, into its columns of Os
// (n x C, row stride C + 8). Xs holds the window's n tokens; zw is the
// window's (heads, n, n) bias(+mask) slab.
template <int C>
__device__ __forceinline__ void attn_heads_fwd(const bf16* Xs, bf16* Os, float* QKV, float* S,
                                               bf16* WA, int n, int heads,
                                               const bf16* __restrict__ wqkv,
                                               const float* __restrict__ bqkv,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ zw) {
  constexpr int LDX = C + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps over the (64 x 96) head tile
  for (int h = 0; h < heads; ++h) {
    float acc[6][4];
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKS) {
      __syncthreads();
      copy_rows(WA, kLDK, 3 * kD, kKS, [&](int r) {
        return wqkv + (size_t)((r / kD) * C + h * kD + r % kD) * C + k0;
      });
      __syncthreads();
      warp_mma<6, kKS>(acc, Xs + wm * 16 * LDX + k0, LDX, n - wm * 16, WA + wn * 48 * kLDK,
                       kLDK);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = wn * 48 + j * 8 + 2 * t;  // within q|k|v of head h
      const int src = (col / kD) * C + h * kD + col % kD;
      const int r_lo = wm * 16 + g, r_hi = r_lo + 8;
      if (r_lo < n) {
        QKV[r_lo * kLDQ + col] = acc[j][0] + bqkv[src];
        QKV[r_lo * kLDQ + col + 1] = acc[j][1] + bqkv[src + 1];
      }
      if (r_hi < n) {
        QKV[r_hi * kLDQ + col] = acc[j][2] + bqkv[src];
        QKV[r_hi * kLDQ + col + 1] = acc[j][3] + bqkv[src + 1];
      }
    }
    __syncthreads();
    cosine_attention(QKV, QKV + kD, QKV + 2 * kD, kLDQ, S, n, kD, scale[h],
                     zw + (size_t)h * n * n, [&](int i, int c, float o) {
                       Os[i * LDX + h * kD + c] = __float2bfloat16(o);
                     });
  }
}

// ---------------------------------------------------------------------------
// Token layouts of the attention half
// ---------------------------------------------------------------------------
//
// The attention half's kernels take the windows of B images, nw = windows()
// an image, one block (or one loop step) per (image b, window wid), and find
// token i of a window at row at(b, wid).token(i) of a (rows, C) view of x
// and of every per-token buffer. The window id that indexes z is wid. Only
// the layout tells hvt's two entries apart: the TPU kernels share one body
// (`_attn_half_fwd_body`, `_attn_half_bwd_body`) and differ in the
// BlockSpecs that gather a window's tokens.

// The NHWC map (B, H, W, C) itself, the cyclic shift folded in: token i of
// window (wy, wx) sits at ((wy·ws + i/ws + shift) mod H, (wx·ws + i%ws +
// shift) mod W). hvt's `_attn_forward_nhwc` and `_attn_backward_nhwc`.
struct NhwcWindows {
  int H, W, ws, shift;
  struct Window {
    int b, wy, wx, H, W, ws, shift;
    __device__ size_t token(int i) const {
      const int r = i / ws, cc = i - r * ws;
      const int yy = (wy * ws + r + shift) % H, xx = (wx * ws + cc + shift) % W;
      return ((size_t)b * H + yy) * W + xx;
    }
  };
  __host__ __device__ int n() const { return ws * ws; }
  __host__ __device__ int windows() const { return (H / ws) * (W / ws); }
  __device__ Window at(int b, int wid) const {
    return {b, wid / (W / ws), wid % (W / ws), H, W, ws, shift};
  }
};

// Windows already partitioned, (nWB, N, C) with batch-major rows: window
// w = b·nw + wid, token i at row w·N + i. hvt's `_attn_forward` and
// `_attn_backward` on their (nb, nwz, n, c) view, with nw = nWZ.
struct FlatWindows {
  int nw, tokens;
  struct Window {
    size_t base;
    __device__ size_t token(int i) const { return base + i; }
  };
  __host__ __device__ int n() const { return tokens; }
  __host__ __device__ int windows() const { return nw; }
  __device__ Window at(int b, int wid) const { return {((size_t)b * nw + wid) * tokens}; }
};

// The attention half's forward, one block per (image, window): the window's
// tokens gathered through the layout, per head q|k|v = x·W_h + b_h (tensor
// cores) and the f32 cosine-attention core, then per 32-row half proj
// (tensor cores), LayerNorm and, where s is given, the residual
// x + s[b]·branch; the result goes back to the tokens' own rows.
template <int C, typename Layout>
__global__ void __launch_bounds__(kThreads)
attn_half_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                     const float* __restrict__ bqkv, const float* __restrict__ scale,
                     const float* __restrict__ z, int nwz, const bf16* __restrict__ wproj,
                     const float* __restrict__ bproj, const float* __restrict__ lns,
                     const float* __restrict__ lnb, const float* __restrict__ s,
                     bf16* __restrict__ out, Layout lay, int heads) {
  constexpr int LDX = C + 8, NT = C / 32;
  const int n = lay.n(), nw = lay.windows();
  const AttnSmem L(n, C);
  extern __shared__ uint4 smem_u4[];
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* WB = Xs;  // phase B reuses the token tile's space
  bf16* Os = reinterpret_cast<bf16*>(smem + L.o);
  float* QKV = reinterpret_cast<float*>(smem + L.qkv);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* WA = reinterpret_cast<bf16*>(smem + L.wa);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / nw, wid = blockIdx.x - b * nw;
  const auto win = lay.at(b, wid);
  copy_rows(Xs, LDX, n, C, [&](int i) { return x + win.token(i) * C; });
  const float* zw = z + (size_t)(nwz > 1 ? wid : 0) * heads * n * n;

  // ---- phase A, per head: q|k|v = x·W_h + b_h (tensor cores) -> cosine attention ----
  attn_heads_fwd<C>(Xs, Os, QKV, S, WA, n, heads, wqkv, bqkv, scale, zw);

  // ---- phase B, per 32-row half: proj (tensor cores) -> LayerNorm -> residual ----
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps over (32 x C)
  const float sc = s != nullptr ? s[b] : 0.f;
  for (int r0 = 0; r0 < n; r0 += 32) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKS) {
      __syncthreads();
      copy_rows(WB, kLDK, C, kKS, [&](int r) { return wproj + (size_t)r * C + k0; });
      __syncthreads();
      warp_mma<NT, kKS>(acc, Os + (r0 + wm * 16) * LDX + k0, LDX, n - r0 - wm * 16,
                        WB + wn * (C / 4) * kLDK, kLDK);
    }
    ln_epilogue<NT>(acc, bproj, lns, lnb, red, [&](int r, int col, float y0, float y1) {
      const int i = r0 + r;
      if (i >= n) return;
      const size_t off = win.token(i) * C + col;
      if (s != nullptr) {
        y0 = to_f32(x[off]) + sc * y0;
        y1 = to_f32(x[off + 1]) + sc * y1;
      }
      *reinterpret_cast<uint32_t*>(out + off) = pack_bf16x2(y0, y1);
    });
  }
}

template <int C, typename Layout>
int launch_attn(const void* x, const void* wqkv, const float* bqkv, const float* scale,
                const float* z, int nwz, const void* wproj, const float* bproj, const float* lns,
                const float* lnb, const float* s, void* out, int B, Layout lay, int heads,
                cudaStream_t stream) {
  const size_t smem = AttnSmem(lay.n(), C).bytes;
  auto kernel = attn_half_fwd_kernel<C, Layout>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * lay.windows(), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), bqkv, scale, z, nwz,
      static_cast<const bf16*>(wproj), bproj, lns, lnb, s, static_cast<bf16*>(out), lay, heads);
  return (int)cudaGetLastError();
}

}  // namespace hvt

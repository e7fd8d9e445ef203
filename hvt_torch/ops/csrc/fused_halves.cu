// The fused SwinV2 block halves, forward, for eval:
//
//   mlp_half_fwd:            x (T, C) -> x + s·LN(fc2(GELU(fc1 x)))   [or the branch alone]
//   attention_half_nhwc_fwd: x (B, H, W, C) -> x + s·LN(proj(attn(qkv(window(x)))))
//
// Replace: hvt/ops/fused_halves_pallas.py `_mlp_forward` (pallas_call at
// line 338, body `_mlp_fwd_kernel`) and `_attn_forward_nhwc` (pallas_call at
// line 1330, body `_attn_fwd_kernel_nhwc` -> `_attn_half_fwd_body`).
//
// What bounds them on the H100: the operations. Per token the MLP half does
// 16·C² FLOP for 4·C bytes of bf16 in and out (384 FLOP/byte at C = 96,
// 3072 at C = 768), and the attention half 8·C² + 4·N·C FLOP for the same
// bytes; both sit above the ~295 FLOP/byte balance point of bf16 tensor
// cores, so the floor is the tensor-core rate.
//
// Design: the products run on tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate: the TPU kernels' _dot contract) and every intermediate stays
// on chip, so device memory sees x once, the weights (from L2) and the
// output once, as on the TPU:
//  * MLP: a block owns 32 rows. The 4C hidden dim is streamed in chunks of
//    32: fc1 of the chunk -> bias -> GELU (the A&S erf polynomial of
//    _gelu) -> bf16 in shared memory -> accumulated into the 32 x C fc2
//    result, which stays in registers across chunks. No (T, 4C) hidden ever
//    reaches device memory. LayerNorm and the residual run in the epilogue.
//  * Attention: a block owns one window of one image. Its 49 tokens are
//    gathered straight from the NHWC map, with the cyclic shift folded into
//    the gather index ((y + shift) mod H), so neither torch.roll nor
//    window_partition/window_reverse exists on this path. Per head, the
//    (49 x 3·32) qkv slice is one tensor-core product into shared memory
//    (f32), then the f32 cosine-attention core of kernel 1 runs on it; the
//    head's output lands bf16 in a (49 x C) tile. proj, LayerNorm and the
//    residual follow, and the result is scattered back to the tokens' own
//    positions.
// Weights arrive in nn.Linear's (out, in) layout, so both operands of every
// product keep the reduction dim contiguous. Weight tiles stream through
// shared memory in slices of 32 along k; this first version does not overlap
// those copies with the products (no cp.async/TMA pipeline yet).
#include "common.cuh"

namespace hvt {

constexpr int kThreads = 256;  // 8 warps
constexpr int kKS = 32;        // k-slice of streamed weight tiles
constexpr int kLDK = kKS + 8;  // padded row stride of a k-slice tile (bank-conflict free)

__device__ __forceinline__ float gelu_as(float x) {
  // 0.5·x·(1 + erf(x/√2)), erf by Abramowitz–Stegun 7.1.26 (_erf / _gelu)
  const float u = x * 0.7071067811865476f;
  const float au = fabsf(u);
  const float t = 1.f / (1.f + 0.3275911f * au);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float mag = 1.f - poly * expf(-au * au);
  const float erf = u > 0.f ? mag : (u < 0.f ? -mag : 0.f);
  return 0.5f * x * (1.f + erf);
}

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// MLP half
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

template <int C>
__global__ void __launch_bounds__(kThreads)
mlp_half_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ lns,
                    const float* __restrict__ lnb, const float* __restrict__ s, int tpi,
                    bf16* __restrict__ out, int T) {
  using L = MlpSmem<C>;
  constexpr int BM = L::BM, HC = L::HC, LDX = L::LDX, HID = 4 * C, NT = C / 32;
  extern __shared__ uint4 smem_u4[];
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::x);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::w1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::w2);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L::h);
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;

  copy_rows(Xs, LDX, BM, C, [&](int r) -> const bf16* {
    return row0 + r < T ? x + (size_t)(row0 + r) * C : nullptr;
  });

  float acc[NT][4];
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

  ln_epilogue<NT>(acc, b2, lns, lnb, red, [&](int r, int col, float y0, float y1) {
    const int row = row0 + r;
    if (row >= T) return;
    if (s != nullptr) {
      const float sc = s[row / tpi];
      const bf16* xr = Xs + r * LDX + col;
      y0 = to_f32(xr[0]) + sc * y0;
      y1 = to_f32(xr[1]) + sc * y1;
    }
    *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) = pack_bf16x2(y0, y1);
  });
}

template <int C>
int launch_mlp(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               const float* lns, const float* lnb, const float* s, int tpi, void* out, int T,
               cudaStream_t stream) {
  constexpr size_t smem = MlpSmem<C>::bytes;
  auto kernel = mlp_half_fwd_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (T + MlpSmem<C>::BM - 1) / MlpSmem<C>::BM;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, lns, lnb, s, tpi, static_cast<bf16*>(out), T);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention half, straight from the NHWC map
// ---------------------------------------------------------------------------

constexpr int kD = 32;              // head dim (every SwinV2 variant)
constexpr int kLDQ = 3 * kD + 1;    // f32 row stride of the per-head q|k|v tile (odd)

struct AttnSmem {
  size_t x, o, qkv, s, wa, bytes;
  __host__ __device__ AttnSmem(int n, int c) {
    const int ldx = c + 8;
    const size_t r1 = sizeof(bf16) * (size_t)(n * ldx > c * kLDK ? n * ldx : c * kLDK);
    x = 0;  // the gathered tokens, later the streamed proj weight slices
    o = x + align16(r1);
    qkv = o + align16(sizeof(bf16) * n * ldx);
    s = qkv + align16(sizeof(float) * n * kLDQ);
    const int s_floats = n * (n + 1) > 128 ? n * (n + 1) : 128;
    wa = s + align16(sizeof(float) * s_floats);
    bytes = wa + sizeof(bf16) * 3 * kD * kLDK;
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_half_nhwc_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                          const float* __restrict__ bqkv, const float* __restrict__ scale,
                          const float* __restrict__ z, int nwz, const bf16* __restrict__ wproj,
                          const float* __restrict__ bproj, const float* __restrict__ lns,
                          const float* __restrict__ lnb, const float* __restrict__ s,
                          bf16* __restrict__ out, int H, int W, int ws, int shift, int heads) {
  constexpr int LDX = C + 8, NT = C / 32;
  const int n = ws * ws;
  const AttnSmem L(n, C);
  extern __shared__ uint4 smem_u4[];
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* WB = Xs;  // phase B reuses the token tile's space
  bf16* Os = reinterpret_cast<bf16*>(smem + L.o);
  float* QKV = reinterpret_cast<float*>(smem + L.qkv);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* WA = reinterpret_cast<bf16*>(smem + L.wa);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wid = blockIdx.x, b = blockIdx.y;
  const int nwx = W / ws, wy = wid / nwx, wx = wid - wy * nwx;
  // token i of this window sits at ((wy·ws + i/ws + shift) mod H, (wx·ws + i%ws + shift) mod W)
  auto token = [&](int i) -> size_t {
    const int r = i / ws, cc = i - r * ws;
    const int yy = (wy * ws + r + shift) % H, xx = (wx * ws + cc + shift) % W;
    return (((size_t)b * H + yy) * W + xx) * C;
  };
  copy_rows(Xs, LDX, n, C, [&](int i) { return x + token(i); });
  const float* zw = z + (size_t)(nwz > 1 ? wid : 0) * heads * n * n;

  // ---- phase A, per head: q|k|v = x·W_h + b_h (tensor cores) -> cosine attention ----
  {
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
    ln_epilogue<NT>(acc, bproj, lns, lnb, S, [&](int r, int col, float y0, float y1) {
      const int i = r0 + r;
      if (i >= n) return;
      const size_t off = token(i) + col;
      if (s != nullptr) {
        y0 = to_f32(x[off]) + sc * y0;
        y1 = to_f32(x[off + 1]) + sc * y1;
      }
      *reinterpret_cast<uint32_t*>(out + off) = pack_bf16x2(y0, y1);
    });
  }
}

template <int C>
int launch_attn(const void* x, const void* wqkv, const float* bqkv, const float* scale,
                const float* z, int nwz, const void* wproj, const float* bproj, const float* lns,
                const float* lnb, const float* s, void* out, int B, int H, int W, int heads,
                int ws, int shift, cudaStream_t stream) {
  const size_t smem = AttnSmem(ws * ws, C).bytes;
  auto kernel = attn_half_nhwc_fwd_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((H / ws) * (W / ws), B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), bqkv, scale, z, nwz,
      static_cast<const bf16*>(wproj), bproj, lns, lnb, s, static_cast<bf16*>(out), H, W, ws,
      shift, heads);
  return (int)cudaGetLastError();
}

}  // namespace hvt

// Widths built: SwinV2-T's four stages. Another width returns -1.
#define HVT_WIDTHS(F) F(96) F(192) F(384) F(768)

extern "C" int hvt_mlp_half_fwd(const void* x, const void* w1, const float* b1, const void* w2,
                                const float* b2, const float* lns, const float* lnb,
                                const float* s, int tpi, void* out, int t, int c,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC) \
  case CC:           \
    return hvt::launch_mlp<CC>(x, w1, b1, w2, b2, lns, lnb, s, tpi, out, t, st);
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

extern "C" int hvt_attention_half_nhwc_fwd(const void* x, const void* wqkv, const float* bqkv,
                                           const float* scale, const float* z, int nwz,
                                           const void* wproj, const float* bproj,
                                           const float* lns, const float* lnb, const float* s,
                                           void* out, int b, int h, int w, int c, int heads,
                                           int ws, int shift, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC)                                                                       \
  case CC:                                                                                 \
    return hvt::launch_attn<CC>(x, wqkv, bqkv, scale, z, nwz, wproj, bproj, lns, lnb, s, \
                                out, b, h, w, heads, ws, shift, st);
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

// The retired mega-fused SwinV2 block halves, forward only, in f32:
//
//   swin_block_attention_fwd: x (B, H, W, C) -> LN(proj(window attention(qkv(x)))) (B, H, W, C)
//   swin_block_mlp_fwd:       x (B, H, W, C) -> LN(fc2(gelu(fc1 x)))               (B, H, W, C)
//
// Replace: hvt/ops/swin_block_pallas.py `fused_attention_branch` (the
// pallas_call at line 160; body `_make_attn_kernel`) and `fused_mlp_branch`
// (the pallas_call at line 244; body `_make_mlp_kernel`).
//
// Their contract is not the fused halves' (fused_halves.cu): x and every
// weight are read as f32 and every product runs in f32, the cosine attention
// core and the LayerNorm (eps 1e-5) too; the MLP rounds gelu(fc1 x + b1) to
// fc2's weight dtype before fc2 (the A&S erf polynomial, expf). No residual,
// no drop-path scale, no shift: the caller rolls the map and adds the branch.
// Products run on the CUDA cores as FFMA, never TF32, whose 10-bit mantissa
// would break the f32 contract.
//
// What bounds them on the H100: the operations. The attention branch does
// 8·T·C² + 4·T·N·C of them, the MLP 16·T·C² (hidden 4C), for 2·T·C values in
// and out: at SwinV2-T's stage 1 (C = 96) that is ~190 f32 operations a byte
// against the card's 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design: each branch is a few launches on the stream, with f32 scratch in
// device memory between them:
//   attention: qkv = x·Wqkvᵀ + b, the map's rows gathered in window-major
//              order (_group_windows) by the product's loader -> the f32
//              cosine core per (window, head) (attention_fwd_kernel,
//              common.cuh) -> proj -> LayerNorm, stored back to the map
//              (_ungroup_windows) in x's dtype;
//   MLP:       h = gelu(x·W1ᵀ + b1) stored in W2's dtype -> h·W2ᵀ + b2 ->
//              LayerNorm in x's dtype.
// The TPU kernels keep one image per grid step in VMEM; a block of the H100
// cannot (SwinV2-T's stage 1 is 1.2 MB of f32 x and 3.6 MB of qkv per image,
// against 227 KB of shared memory). The split is where FFMA pays: a product
// reaches the f32 rate only through a register-blocked 128 x 128 tile (8 x 8
// outputs a thread, 2 operands from shared memory per 64 FMAs), which a
// 49-token window cannot fill. The scratch is written once and read once:
// 2·(3 + 1 + 1)·T·C·4 bytes a call (attention), 2·T·(4C·|W2| + 4·C) (MLP),
// 40·T·C in f32. Over a SwinV2-T forward at batch 64 that is 3.7 GB, 1.1 ms
// at 3.35 TB/s, beside operation bounds of 2.9 ms (attention) and 5.3 ms
// (MLP): a later design that keeps qkv and the hidden chunks on chip can win
// it back.
#include "common.cuh"

namespace hvt {

constexpr int kBM = 128, kBN = 128, kBK = 8;  // tile of a product: rows, columns, k-step
constexpr int kLinThreads = 256;               // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLnRows = 8;                     // rows of a LayerNorm block, one a warp

// Where row r of a (T, ·) operand or result lies in memory: row r itself
// (window 0), or row r of the window-major token order of _group_windows
// over B images of h x w (window > 0), read from the NHWC map.
struct Rows {
  int h, w, window;
  __device__ long long src(long long r) const {
    if (window == 0) return r;
    const int n = window * window, nw = w / window, wins = (h / window) * nw;
    const long long win = r / n, img = win / wins;
    const int t = (int)(r - win * n), j = (int)(win - img * wins);
    const int row = (j / nw) * window + t / window, col = (j % nw) * window + t % window;
    return (img * h + row) * w + col;
  }
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo); v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// out (m, n) = A (m, k) · B (n, k)ᵀ + bias, or gelu of it, in f32 FFMA with
// A's rows read through `rows`; B is a weight in nn.Linear's (out, in)
// layout. k is a multiple of kBK, n of 4, every row 16-byte aligned (8-byte
// for bf16). Each thread accumulates its 8 x 8 outputs over k in order.
// Shared tiles are k-major and double-buffered: the next k-step's operands
// are loaded into registers while this one's are multiplied.
template <typename TA, typename TB, typename TO, bool kGelu>
__global__ void __launch_bounds__(kLinThreads)
linear_kernel(const TA* __restrict__ a, Rows rows, const TB* __restrict__ b,
              const float* __restrict__ bias, TO* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) float As[2][kBK][kBM + 4];
  __shared__ __align__(16) float Bs[2][kBK][kBN + 4];
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // the loader: 4 consecutive k of one row of A's tile and of B's
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const TA* pa = m0 + lr < m ? a + rows.src(m0 + lr) * k + lk : nullptr;
  const TB* pb = n0 + lr < n ? b + (long long)(n0 + lr) * k + lk : nullptr;
  float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};
  if (pa != nullptr) load4(pa, ra);
  if (pb != nullptr) load4(pb, rb);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    As[0][lk + i][lr] = ra[i];
    Bs[0][lk + i][lr] = rb[i];
  }
  __syncthreads();
  // this thread's outputs: rows 4·ty.. and 64 + 4·ty.., columns 4·tx.. and 64 + 4·tx..
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = k / kBK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      if (pa != nullptr) load4(pa + (s + 1) * kBK, ra);
      if (pb != nullptr) load4(pb + (s + 1) * kBK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        As[cur ^ 1][lk + i][lr] = ra[i];
        Bs[cur ^ 1][lk + i][lr] = rb[i];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col >= n) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][half * 4 + j] + bias[col + j];
        if (kGelu) v[j] = gelu_as(v[j]);
      }
      store4(out + r * n + col, v);
    }
  }
}

template <typename TA, typename TB, typename TO, bool kGelu>
int linear(const void* a, Rows rows, const void* b, const float* bias, void* out, int m, int n,
           int k, cudaStream_t s) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  linear_kernel<TA, TB, TO, kGelu><<<grid, kLinThreads, 0, s>>>(
      static_cast<const TA*>(a), rows, static_cast<const TB*>(b), bias, static_cast<TO*>(out), m,
      n, k);
  return (int)cudaGetLastError();
}

// LayerNorm of each f32 row of y (m, c) (two-pass mean and variance, eps
// 1e-5, as the TPU kernels), one warp a row, stored to out's row rows.src(r).
template <typename TO>
__global__ void __launch_bounds__(kLnRows * 32)
layer_norm_rows_kernel(const float* __restrict__ y, Rows rows, const float* __restrict__ lns,
                       const float* __restrict__ lnb, TO* __restrict__ out, int m, int c) {
  const long long r = (long long)blockIdx.x * kLnRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= m) return;  // the whole warp
  const float* yr = y + r * c;
  float s = 0.f;
  for (int j = lane; j < c; j += 32) s += yr[j];
  const float mu = warp_sum(s) / c;
  float v = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float d = yr[j] - mu;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / c + 1e-5f);
  TO* o = out + rows.src(r) * c;
  for (int j = lane; j < c; j += 32) o[j] = from_f32<TO>((yr[j] - mu) * inv * lns[j] + lnb[j]);
}

template <typename TO>
int layer_norm_rows(const float* y, Rows rows, const float* lns, const float* lnb, void* out,
                    int m, int c, cudaStream_t s) {
  layer_norm_rows_kernel<TO><<<(m + kLnRows - 1) / kLnRows, kLnRows * 32, 0, s>>>(
      y, rows, lns, lnb, static_cast<TO*>(out), m, c);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int attention_branch(const void* x, const void* wqkv, const float* bqkv, const float* scale,
                     const float* z, int nwz, const void* wproj, const float* bproj,
                     const float* lns, const float* lnb, float* qkv, float* attn, void* out, int b,
                     int h, int w, int c, int heads, int window, cudaStream_t s) {
  const int n = window * window, d = c / heads, t = b * h * w;
  const Rows windows{h, w, window}, flat{0, 0, 0};
  int err = linear<TX, TW, float, false>(x, windows, wqkv, bqkv, qkv, t, 3 * c, c, s);
  if (err != 0) return err;
  err = launch_attention<float>(qkv, qkv + c, qkv + 2 * c, HeadTiles{(long long)n * 3 * c, d, 3 * c},
                                scale, z, nwz, attn, HeadTiles{(long long)n * c, d, c}, t / n, n, d,
                                heads, false, s);
  if (err != 0) return err;
  // proj into qkv's first T·C floats: the core has read qkv by then (stream order)
  err = linear<float, TW, float, false>(attn, flat, wproj, bproj, qkv, t, c, c, s);
  if (err != 0) return err;
  return layer_norm_rows<TX>(qkv, windows, lns, lnb, out, t, c, s);
}

template <typename TX, typename TW>
int mlp_branch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               const float* lns, const float* lnb, void* hidden, float* pre, void* out, int t,
               int c, int hid, cudaStream_t s) {
  const Rows flat{0, 0, 0};
  int err = linear<TX, TW, TW, true>(x, flat, w1, b1, hidden, t, hid, c, s);
  if (err != 0) return err;
  err = linear<TW, TW, float, false>(hidden, flat, w2, b2, pre, t, c, hid, s);
  if (err != 0) return err;
  return layer_norm_rows<TX>(pre, flat, lns, lnb, out, t, c, s);
}

// fn(TX{}, TW{}) for x's and the weights' dtype codes (0 = bf16, 1 = f32).
template <typename Fn>
int by_dtypes(int x_dtype, int w_dtype, Fn fn) {
  if (x_dtype == 0) return w_dtype == 0 ? fn(bf16{}, bf16{}) : fn(bf16{}, 0.f);
  return w_dtype == 0 ? fn(0.f, bf16{}) : fn(0.f, 0.f);
}

inline bool dtypes_ok(int x_dtype, int w_dtype) {
  return (x_dtype == 0 || x_dtype == 1) && (w_dtype == 0 || w_dtype == 1);
}

}  // namespace hvt

// x, out (B, H, W, C) in x_dtype; wqkv (3C, C) and wproj (C, C) in w_dtype
// (0 = bf16, 1 = f32); bqkv (3C,), scale (heads,), z (nwz, heads, N, N) with
// nwz 1 or the windows of an image, bproj, lns and lnb (C,), all f32.
// Scratch: qkv (T, 3C) and attn (T, C) f32, T = B·H·W. Returns a
// cudaError_t, or -1 for a shape the kernels do not take.
extern "C" int hvt_swin_block_attention_fwd(const void* x, const void* wqkv, const float* bqkv,
                                            const float* scale, const float* z, int nwz,
                                            const void* wproj, const float* bproj,
                                            const float* lns, const float* lnb, float* qkv,
                                            float* attn, void* out, int b, int h, int w, int c,
                                            int heads, int window, int x_dtype, int w_dtype,
                                            void* stream) {
  if (!hvt::dtypes_ok(x_dtype, w_dtype) || c <= 0 || c % 32 || heads <= 0 || c % heads ||
      window <= 0 || h % window || w % window || (long long)b * h * w > 65535LL * hvt::kBM)
    return -1;
  const int n_win = (h / window) * (w / window);
  if (nwz != 1 && nwz != n_win) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hvt::by_dtypes(x_dtype, w_dtype, [&](auto tx, auto tw) {
    return hvt::attention_branch<decltype(tx), decltype(tw)>(x, wqkv, bqkv, scale, z, nwz, wproj,
                                                             bproj, lns, lnb, qkv, attn, out, b,
                                                             h, w, c, heads, window, s);
  });
}

// x, out (T, C) in x_dtype (the flat NHWC map); w1 (hid, C) and w2 (C, hid)
// in w_dtype; b1 (hid,), b2, lns and lnb (C,) f32. Scratch: hidden (T, hid)
// in w_dtype, pre (T, C) f32. Returns a cudaError_t, or -1 for a shape the
// kernels do not take.
extern "C" int hvt_swin_block_mlp_fwd(const void* x, const void* w1, const float* b1,
                                      const void* w2, const float* b2, const float* lns,
                                      const float* lnb, void* hidden, float* pre, void* out, int t,
                                      int c, int hid, int x_dtype, int w_dtype, void* stream) {
  if (!hvt::dtypes_ok(x_dtype, w_dtype) || c <= 0 || c % 32 || hid <= 0 || hid % 32 ||
      (long long)t > 65535LL * hvt::kBM)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hvt::by_dtypes(x_dtype, w_dtype, [&](auto tx, auto tw) {
    return hvt::mlp_branch<decltype(tx), decltype(tw)>(x, w1, b1, w2, b2, lns, lnb, hidden, pre,
                                                       out, t, c, hid, s);
  });
}

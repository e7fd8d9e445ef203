// The tiled bf16 GEMM core of the MLP half (mlp.cu) and of the attention
// half's forward proj (fused_halves.cuh), the weight-gradient product
// `grad_tn` that the MLP and attention halves' backwards share (mlp.cu,
// fused_halves_bwd.cuh), and the LayerNorm-and-residual row pass that ends
// both halves' forwards (ln_resid_fwd).
//
// A block of kGemmThreads threads (4 warps, 2 (m) x 2 (n), each a 64 x BN/2
// warp tile) owns a kBM x BN output tile, BN 64 or 128, and streams the
// reduction dim K in slices of kBK through a kGemmStages-deep cp.async ring
// of shared tiles. BN = 128 reads 1.5x fewer shared bytes per mma (8
// ldmatrix for 32 mma a warp and 16-deep step, against 6 for 16) and is
// taken for the products with a plain epilogue where N is a multiple of
// 128: it runs them 15-20% faster at C = 384 and 768 on the H100. Its 128
// accumulators a thread leave two blocks an SM, which slows a kernel whose
// epilogue is heavy (GELU) or holds a second accumulator.
// Fragments reach mma.sync.m16n8k16 (bf16 operands, f32 accumulation) by
// ldmatrix from operands stored with K contiguous, and by ldmatrix.trans
// from k-major operands (a weight read along its output dim, or a token
// matrix whose tokens are the reduction dim): no operand is gathered by
// scalar loads. Rows, columns and tokens past the matrix edge are
// zero-filled by the copy (cp.async with a source size of 0), so M, N and
// the token count need not be multiples of the tile; K, M and N must be
// multiples of 8 (16-byte pieces), and every row must start 16-byte aligned.
//
// Shared tiles are padded rather than swizzled: a K-contiguous slice row is
// kBK + 8 bf16 (80 bytes) and a k-major row kBM + 8 or kBN + 8 (272 or 144
// bytes), so the eight rows one ldmatrix reads fall in eight distinct
// 16-byte bank groups.
#pragma once

#include "attention_tc.cuh"

namespace hvt {

constexpr int kGemmThreads = 128;  // 4 warps
constexpr int kBM = 128, kBN = 64, kBK = 32, kGemmStages = 3;
constexpr int kLdRK = kBK + 8;  // row stride of a K-contiguous slice (rows x kBK)
constexpr int kLdKM = kBM + 8;  // row stride of a k-major A slice (kBK x kBM)
// bf16 elements of one slice of each kind: A K-contiguous or k-major; B
// (BN columns) K-contiguous or k-major, row stride BN + 8
constexpr int kTileAR = kBM * kLdRK, kTileAK = kBK * kLdKM;
template <int BN> constexpr int tile_br() { return BN * kLdRK; }
template <int BN> constexpr int tile_bk() { return kBK * (BN + 8); }

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// 16 bytes from src, or zeros where !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// A ROWS x kBK slice of a K-contiguous matrix into dst (row stride kLdRK):
// row r from src + (r0 + r)·ld + k0, zeros at r0 + r >= rows.
template <int ROWS>
__device__ __forceinline__ void load_rows_k(bf16* dst, const bf16* __restrict__ src, long long ld,
                                            int r0, int rows, int k0) {
  static_assert(ROWS * 4 % kGemmThreads == 0, "whole 16-byte pieces a thread");
#pragma unroll
  for (int it = 0; it < ROWS * 4 / kGemmThreads; ++it) {
    const int i = threadIdx.x + it * kGemmThreads, r = i >> 2, ch = i & 3;
    const bool ok = r0 + r < rows;
    cp_async16_zfill(dst + r * kLdRK + 8 * ch, ok ? src + (r0 + r) * ld + k0 + 8 * ch : src, ok);
  }
}

// A kBK x COLS slice of a k-major matrix into dst (row stride COLS + 8):
// row k from src + (k0 + k)·ld + c0, zeros at k0 + k >= krows or at columns
// c0 + c >= cols.
template <int COLS>
__device__ __forceinline__ void load_k_rows(bf16* dst, const bf16* __restrict__ src, long long ld,
                                            int k0, int krows, int c0, int cols) {
  constexpr int CH = COLS / 8;
  static_assert(kBK * CH % kGemmThreads == 0, "whole 16-byte pieces a thread");
#pragma unroll
  for (int it = 0; it < kBK * CH / kGemmThreads; ++it) {
    const int i = threadIdx.x + it * kGemmThreads, k = i / CH, ch = i % CH;
    const bool ok = k0 + k < krows && c0 + 8 * ch < cols;
    cp_async16_zfill(dst + k * (COLS + 8) + 8 * ch,
                     ok ? src + (k0 + k) * ld + c0 + 8 * ch : src, ok);
  }
}

// acc[i][j] (rows 64·wm + 16i.., columns BN/2·wn + 8j.. of the block's
// tile) += A·B over one kBK slice, warp (wm, wn) = (warp / 2, warp % 2).
// A: kAK ? k-major (kBK x kBM, stride kLdKM) : K-contiguous (kBM x kBK,
// stride kLdRK); B: kBKM ? k-major (kBK x BN, stride BN + 8) : K-contiguous
// (BN x kBK, stride kLdRK, the weight's (out, in) layout).
template <bool kAK, bool kBKM, int BN>
__device__ __forceinline__ void tile_mma(float (&acc)[4][BN / 16][4], const bf16* As,
                                         const bf16* Bs) {
  constexpr int NJ = BN / 16, kLdKN = BN + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int l8 = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t a[4][4], b[NJ][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 64 * wm + 16 * i;
      if constexpr (kAK)
        ldsm_x4_t(a[i], As + (16 * ks + l8 + 8 * l4) * kLdKM + m + 8 * l3);
      else
        ldsm_x4(a[i], As + (m + l8 + 8 * l3) * kLdRK + 16 * ks + 8 * l4);
    }
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      const int n = BN / 2 * wn + 16 * jp;
      uint32_t r[4];
      if constexpr (kBKM)
        ldsm_x4_t(r, Bs + (16 * ks + l8 + 8 * l3) * kLdKN + n + 8 * l4);
      else
        ldsm_x4(r, Bs + (n + l8 + 8 * l4) * kLdRK + 16 * ks + 8 * l3);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// Runs compute(step, stage) on `steps` slices, slice s issued by
// load(s, stage) (cp.async, no commit) into stage s mod kGemmStages,
// kGemmStages − 1 slices ahead of the one computed. Ends in a barrier, with
// every copy landed: the stages are free for the caller.
template <typename LoadFn, typename ComputeFn>
__device__ __forceinline__ void gemm_pipeline(int steps, LoadFn load, ComputeFn compute) {
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kGemmStages - 2>();  // slice s has landed
    __syncthreads();                   // ... for every thread; slice s − 1's stage is free
    const int next = s + kGemmStages - 1;
    if (next < steps) load(next, next % kGemmStages);
    cp_async_commit();
    compute(s, s % kGemmStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// fn(i, j, e, row, col) for each pair of neighbouring columns of the
// block's tile, held at acc[i][j][e] and acc[i][j][e + 1] of the caller's
// accumulators: row m0 + 64·wm + 16i + lane/4 (+ 8 where e = 2), col n0 +
// BN/2·wn + 8j + 2·(lane % 4).
template <int BN, typename Fn>
__device__ __forceinline__ void tile_pairs(int m0, int n0, Fn fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = m0 + 64 * (warp >> 1) + (lane >> 2);
  const int c0 = n0 + BN / 2 * (warp & 1) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) fn(i, j, e, r0 + 16 * i + 4 * e, c0 + 8 * j);
}

// acc = A·Wᵀ for the block's tile (rows m0.., BN columns n0..): A (rows, K)
// and W (n_rows, K), both K-contiguous with row stride K.
template <int BN>
__device__ __forceinline__ void gemm_nt(float (&acc)[4][BN / 16][4], const bf16* __restrict__ A,
                                        int rows, const bf16* __restrict__ W, int n_rows, int K,
                                        int m0, int n0) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  constexpr int kStage = kTileAR + tile_br<BN>();
  bf16* const sm = reinterpret_cast<bf16*>(gemm_smem);
  gemm_pipeline(
      K / kBK,
      [&](int s, int st) {
        bf16* d = sm + st * kStage;
        load_rows_k<kBM>(d, A, K, m0, rows, s * kBK);
        load_rows_k<BN>(d + kTileAR, W, K, n0, n_rows, s * kBK);
      },
      [&](int, int st) {
        tile_mma<false, false, BN>(acc, sm + st * kStage, sm + st * kStage + kTileAR);
      });
}

template <int BN>
constexpr size_t fc_smem() { return sizeof(bf16) * kGemmStages * (kTileAR + tile_br<BN>()); }

// out (rows, N) f32 = A·Wᵀ + b over the block's tile, rows m0 = blockIdx.y·kBM..
// and columns n0 = blockIdx.x·BN..: grid (ceil(N / BN), ceil(rows / kBM)).
// A (rows, K) and W (N, K) bf16, K-contiguous; b f32 (N).
template <int BN>
__device__ __forceinline__ void linear_f32_tile(const bf16* __restrict__ A,
                                                const bf16* __restrict__ W,
                                                const float* __restrict__ b, float* __restrict__ out,
                                                int rows, int N, int K) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  float acc[4][BN / 16][4] = {};
  gemm_nt<BN>(acc, A, rows, W, N, K, m0, n0);
  tile_pairs<BN>(m0, n0, [&](int i, int j, int e, int row, int col) {
    if (row < rows && col < N)
      *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
          make_float2(acc[i][j][e] + b[col], acc[i][j][e + 1] + b[col + 1]);
  });
}

// out[z] = Aᵀ·B over the tokens of slice z (blockIdx.z), tokens [z·per_split,
// min(T, (z + 1)·per_split)); A (T, M) and B (T, N) bf16 row-major, both
// k-major operands here (the tokens are the reduction dim). out[z] is (M, N)
// row-major, or (N, M) where trans (the product's transpose, written in
// place of a second product with the operands swapped).
template <int BN>
__global__ void __launch_bounds__(kGemmThreads)
grad_tn_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out,
               int T, int M, int N, int per_split, int trans) {
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  constexpr int kStage = kTileAK + tile_bk<BN>();
  bf16* const sm = reinterpret_cast<bf16*>(gemm_smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int t_begin = blockIdx.z * per_split, t_end = min(T, t_begin + per_split);
  float acc[4][BN / 16][4] = {};
  gemm_pipeline(
      (t_end - t_begin + kBK - 1) / kBK,
      [&](int s, int st) {
        bf16* d = sm + st * kStage;
        load_k_rows<kBM>(d, A, M, t_begin + s * kBK, t_end, m0, M);
        load_k_rows<BN>(d + kTileAK, B, N, t_begin + s * kBK, t_end, n0, N);
      },
      [&](int, int st) {
        tile_mma<true, true, BN>(acc, sm + st * kStage, sm + st * kStage + kTileAK);
      });
  float* o = out + (size_t)blockIdx.z * M * N;
  tile_pairs<BN>(m0, n0, [&](int i, int j, int e, int m, int n) {
    if (m >= M || n >= N) return;
    const float v0 = acc[i][j][e], v1 = acc[i][j][e + 1];
    if (trans) {
      o[(size_t)n * M + m] = v0;
      o[(size_t)(n + 1) * M + m] = v1;
    } else {
      *reinterpret_cast<float2*>(o + (size_t)m * N + n) = make_float2(v0, v1);
    }
  });
}

template <int BN>
constexpr size_t grad_tn_smem() { return sizeof(bf16) * kGemmStages * (kTileAK + tile_bk<BN>()); }

// The block tile's width for N columns: 128 where N is a multiple of it.
inline int tile_cols(int N) { return N % 128 == 0 ? 128 : kBN; }

// out (M, N) = Aᵀ·B, or its transpose (N, M) where trans, over T tokens in
// `splits` slices of a whole number of kBK tokens; with more than one slice
// they land in `part` (splits·M·N floats) and are summed in order.
inline int grad_tn(const bf16* A, const bf16* B, float* out, float* part, int splits, int T,
                   int M, int N, bool trans, cudaStream_t st) {
  if (T < 1 || M % 8 || N % 8 || splits < 1) return -1;
  int per = (T + splits - 1) / splits;
  per = (per + kBK - 1) / kBK * kBK;
  splits = (T + per - 1) / per;
  float* dst = splits == 1 ? out : part;
  const int bn = tile_cols(N);
  const dim3 grid((N + bn - 1) / bn, (M + kBM - 1) / kBM, splits);
  if (bn == 128) {
    if (int err = allow_smem(grad_tn_kernel<128>, grad_tn_smem<128>())) return err;
    grad_tn_kernel<128><<<grid, kGemmThreads, grad_tn_smem<128>(), st>>>(A, B, dst, T, M, N, per,
                                                                         trans);
  } else {
    grad_tn_kernel<kBN><<<grid, kGemmThreads, grad_tn_smem<kBN>(), st>>>(A, B, dst, T, M, N, per,
                                                                         trans);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return sum_parts(part, splits, (long long)M * N, out, st);
}

// ---------------------------------------------------------------------------
// LayerNorm rows: one warp a row, the row in registers
// ---------------------------------------------------------------------------

constexpr int kLnThreads = 256;
constexpr int kMaxV = 32;  // columns a lane holds at the widest C (1024)

inline bool ln_width_ok(int C) { return C > 0 && C % 32 == 0 && C <= 32 * kMaxV; }

// One warp per row of pre (T, C) f32: the LayerNorm statistics (two-pass,
// eps 1e-5, as _ln_fwd), y = normed·lns + lnb, and out = bf16(x + s[row /
// tpi]·y) where s is given (the residual added in f32 before the one
// rounding), else bf16(y); where pre_out is given, also the row's sum
// itself rounded once to bf16 (hvt's `want_pre` store, which the chunked
// MLP's backward reads). Lane l holds the columns l + 32v, v < C/32 <= kV:
// kV is the smallest of 4, 8, 16 and 32 that holds C. Bound by bytes: 8·T·C
// (pre read, out written), 2·T·C more with the residual or pre_out.
template <int kV>
__global__ void __launch_bounds__(kLnThreads)
ln_resid_fwd_kernel(const float* __restrict__ pre, const float* __restrict__ lns,
                    const float* __restrict__ lnb, const bf16* __restrict__ x,
                    const float* __restrict__ s, int tpi, bf16* __restrict__ out,
                    bf16* __restrict__ pre_out, int T, int C) {
  const int lane = threadIdx.x & 31, nv = C / 32;
  const int row = blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  if (row >= T) return;
  const size_t base = (size_t)row * C + lane;
  float p[kV];
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < kV; ++v)
    if (v < nv) {
      p[v] = pre[base + 32 * v];
      sum += p[v];
      if (pre_out != nullptr) pre_out[base + 32 * v] = __float2bfloat16(p[v]);
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
  const float sc = s != nullptr ? s[row / tpi] : 0.f;
#pragma unroll
  for (int v = 0; v < kV; ++v)
    if (v < nv) {
      const int col = 32 * v + lane;
      float y = p[v] * inv * lns[col] + lnb[col];
      if (s != nullptr) y = to_f32(x[base + 32 * v]) + sc * y;
      out[base + 32 * v] = __float2bfloat16(y);
    }
}

// ln_resid_fwd_kernel at the register bucket of C, one warp a row.
inline int ln_resid_fwd(const float* pre, const float* lns, const float* lnb, const bf16* x,
                        const float* s, int tpi, bf16* out, bf16* pre_out, int T, int C,
                        cudaStream_t st) {
  if (T < 1 || !ln_width_ok(C)) return -1;
  auto kernel = C <= 128   ? ln_resid_fwd_kernel<4>
                : C <= 256 ? ln_resid_fwd_kernel<8>
                : C <= 512 ? ln_resid_fwd_kernel<16>
                           : ln_resid_fwd_kernel<kMaxV>;
  constexpr int rows = kLnThreads / 32;
  kernel<<<(T + rows - 1) / rows, kLnThreads, 0, st>>>(pre, lns, lnb, x, s, tpi, out, pre_out,
                                                          T, C);
  return (int)cudaGetLastError();
}

}  // namespace hvt

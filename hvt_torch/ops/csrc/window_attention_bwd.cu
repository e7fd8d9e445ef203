// Backward of the cosine window attention, in two layouts:
//
//   window_attention_packed_bwd: (qkv (nWB, N, 3C), dO (nWB, N, C)) ->
//                                (dqkv (nWB, N, 3C), dz (nWZ, H, N, N) f32, dscale (H,) f32)
//   window_attention_bwd:        (q, k, v, dO, each (nWB, H, N, D)) ->
//                                (dq, dk, dv (nWB, H, N, D), dz, dscale)
//
// Replace: hvt/ops/window_attention_pallas.py `_packed_backward` (the
// pallas_call at line 558; body `_packed_bwd_kernel` -> `packed_heads_backward`)
// and `_backward` (the pallas_call at line 246; body `_attention_bwd_kernel`).
// Both TPU bodies are the same f32 math; only the layouts differ, and the
// one kernel here reads and writes each through its strides (HeadTiles).
//
// Per (window, head), in f32, recomputed from qkv as the TPU kernel does:
//   q̂ = q·rsqrt(Σq² + 1e-24), k̂ likewise, cos = q̂k̂ᵀ, P = softmax(scale·cos + z)
//   dv = Pᵀ·dO,  dS = P ⊙ (dO·vᵀ − rowsum(dO·vᵀ ⊙ P))
//   dz += dS (summed over the windows that share a window id), dscale += Σ dS ⊙ cos
//   dq̂ = scale·dS·k̂, dk̂ = scale·dSᵀ·q̂, dq = (dq̂ − q̂⟨dq̂, q̂⟩)·rsqrt(Σq² + 1e-24), dk likewise.
//
// What bounds it on the H100: the bytes. Per token it reads q, k, v (3C) and
// dO (C) and writes their gradients (3C): 7C values, 14C bytes in bf16 (≈ 2.6 GB for the
// 12 launches of one SwinV2-T step at batch 128, ≈ 0.77 ms at 3.35 TB/s),
// for 10·N²·D FLOP per (window, head), about 35 FLOP per byte.
//
// Design. The TPU kernel carries dz and dscale across its sequential batch
// grid axis; blocks on Hopper run in no order, so that does not carry over,
// and per-window dz partials would be 236 MB at stage 1. Here one block of
// four warps owns (a chunk of `per_block` images, one window id, one head)
// and loops over the chunk's windows of that id. Each window's q, k, v and
// dO tiles (N <= 64 rows of D = 32, zero-padded to 64 rows) arrive by
// cp.async in 16-byte pieces into one of two buffers, so the next window
// loads while this one computes (f32 inputs are split into three bf16
// pieces on their way in, synchronously). The per-window math is
// attention_window_bwd_tc (attention_bwd_tc.cuh): all five products on
// mma.sync tensor cores with bf16 operands and f32 accumulation, the
// normalisation folded out of the products and every f32 operand split into
// bf16 pieces, so the results keep f32 accuracy. The chunk's dz stays
// in registers (a lane holds the same (i, j) elements in every window) and
// dscale in one register per thread; each block writes one (N, N) dz partial
// and one dscale partial, and a second kernel sums the partials over chunks
// in a fixed order: no atomics, the same bits on every run. Shared memory is
// 66.5 KB a block in bf16 (130.5 KB in f32): two input buffers, P and the
// scaled dS (their hi and lo halves, one after the other in the same tiles),
// the chunk's z (loaded once) and the rows' inverse norms. dq, dk and dv
// are rounded to the inputs' dtype once, at the store, and dz and dscale
// stay f32. The wrapper (window_attention_cuda.tc_backward_chunks) sizes
// the chunks: about one wave of blocks a launch.
#include "attention_bwd_tc.cuh"

namespace hvt {

// Input buffer of one window: the pieces' tiles of q, k, v, dO.
template <typename T>
constexpr int tc_stage_elems() {
  return tc_pieces<T>() * 4 * kTcTile;
}

template <typename T>
constexpr size_t tc_bwd_smem_bytes() {
  return sizeof(bf16) * (2 * tc_stage_elems<T>() + 2 * kTcRows * kTcRows) +
         sizeof(float) * (kTcRows * kTcZLd + 2 * kTcRows + kTcThreads / 32);
}

// q, k, v and their gradients in the layout `in`, dO in `go`; n <= kTcRows,
// head dim kTcHeadDim, rows 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 3)  // registers capped for 3 blocks an SM
attention_bwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        HeadTiles in, const T* __restrict__ dout, HeadTiles go,
                        const float* __restrict__ scale, const float* __restrict__ z, int nwz,
                        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                        float* __restrict__ dz_part, float* __restrict__ ds_part, int nb,
                        int per_block, int n, int heads) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kParts = tc_pieces<T>(), kStage = tc_stage_elems<T>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* const stages = reinterpret_cast<bf16*>(tc_smem);
  bf16* const ps = stages + 2 * kStage;
  float* const zs = reinterpret_cast<float*>(ps + 2 * kTcRows * kTcRows);
  float* const inv = zs + kTcRows * kTcZLd;
  float* const red = inv + 2 * kTcRows;

  const int wz = blockIdx.x % nwz, chunk = blockIdx.x / nwz, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float sc = scale[h];
  // this (window id, head)'s z, the same for every window of the chunk
  tc_load_z(zs, z + ((size_t)wz * heads + h) * n * n, n);
  // rows n.. of every tile stay zero: the loads below write rows < n only
  tc_zero_pad_rows(stages, 2 * kParts * 4, n);
  // window b's tiles into buffer s (window id = row mod nWZ, batch-major rows)
  auto load = [&](int b, int s) {
    const int w = b * nwz + wz;
    tc_load_tiles<T, 4>(stages + s * kStage, n, [&](int op, int row) {
      return op == 3 ? dout + go.at(w, h, row) : (op == 0 ? q : op == 1 ? k : v) + in.at(w, h, row);
    });
  };

  float dz[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dz[nt][e] = 0.f;
  float dscale = 0.f;

  const int b0 = chunk * per_block, b_end = min(b0 + per_block, nb);
  load(b0, 0);
  for (int b = b0; b < b_end; ++b) {
    const int s = (b - b0) & 1;
    // the other buffer was last read in the previous window, which ended in a barrier
    if (b + 1 < b_end) load(b + 1, s ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();  // window b's group has landed
    __syncthreads();
    const int w = b * nwz + wz;
    attention_window_bwd_tc<kParts>(
        stages + s * kStage, ps, inv, n, sc, zs, dz, dscale,
        [&](int op, int row, int col, float v0, float v1) {
          T* p = (op == 0 ? dq : op == 1 ? dk : dv) + in.at(w, h, row) + col;
          if constexpr (kF32) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          else *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
        });
    __syncthreads();  // this window's buffers are free
  }

  const size_t part = ((size_t)chunk * nwz + wz) * heads + h;
  float* zp = dz_part + part * n * n;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8, col = 8 * nt + c0 + (e & 1);
      if (row < n && col < n) zp[row * n + col] = dz[nt][e];
    }
  dscale = warp_sum(dscale);
  if (lane == 0) red[warp] = dscale;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < kTcThreads / 32; ++i) sum += red[i];
    ds_part[part] = sum;
  }
}

// dz[e] = Σ_chunk dz_part[chunk][e] and dscale[h] = Σ_(chunk, wz) ds_part[chunk][wz][h],
// each summed in a fixed order.
__global__ void attention_bwd_reduce(const float* __restrict__ dz_part,
                                     const float* __restrict__ ds_part, float* __restrict__ dz,
                                     float* __restrict__ dscale, int chunks, int nwz, int heads,
                                     int nn) {
  const size_t total = (size_t)nwz * heads * nn;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
    float s = 0.f;
    for (int ch = 0; ch < chunks; ++ch) s += dz_part[ch * total + idx];
    dz[idx] = s;
  }
  if (idx < (size_t)heads) {
    float s = 0.f;
    for (int p = 0; p < chunks * nwz; ++p) s += ds_part[(size_t)p * heads + idx];
    dscale[idx] = s;
  }
}

template <typename T>
int launch_attention_bwd(const void* q, const void* k, const void* v, HeadTiles in,
                         const void* dout, HeadTiles go, const float* scale, const float* z,
                         int nwz, void* dq, void* dk, void* dv, float* dz, float* dscale,
                         float* dz_part, float* ds_part, int nwb, int n, int d, int heads,
                         int per_block, int chunks, cudaStream_t stream) {
  if (n < 1 || n > kTcRows || d != kTcHeadDim) return -1;
  const size_t smem = tc_bwd_smem_bytes<T>();
  auto kernel = attention_bwd_tc_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(chunks * nwz, heads), kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), in,
      static_cast<const T*>(dout), go, scale, z, nwz, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dz_part, ds_part, nwb / nwz, per_block, n, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)nwz * heads * n * n;
  const size_t work = total > (size_t)heads ? total : (size_t)heads;
  attention_bwd_reduce<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      dz_part, ds_part, dz, dscale, chunks, nwz, heads, n * n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_packed_bwd(const void* qkv, const void* dout, const float* scale, const float* z,
                      int nwz, void* dqkv, float* dz, float* dscale, float* dz_part,
                      float* ds_part, int nwb, int n, int c, int heads, int per_block,
                      int chunks, cudaStream_t stream) {
  const int d = c / heads;
  const HeadTiles in{(long long)n * 3 * c, d, 3 * c}, go{(long long)n * c, d, c};
  const T* p = static_cast<const T*>(qkv);
  T* g = static_cast<T*>(dqkv);
  return launch_attention_bwd<T>(p, p + c, p + 2 * c, in, dout, go, scale, z, nwz, g, g + c,
                                 g + 2 * c, dz, dscale, dz_part, ds_part, nwb, n, d, heads,
                                 per_block, chunks, stream);
}

}  // namespace hvt

// dtype: 0 = bf16, 1 = f32 (qkv, dout and dqkv share it). dz_part holds
// chunks·nWZ·H·N·N floats and ds_part chunks·nWZ·H; chunk k covers images
// [k·per_block, min((k+1)·per_block, nWB/nWZ)). Returns a cudaError_t.
extern "C" int hvt_window_attention_packed_bwd(const void* qkv, const void* dout,
                                               const float* scale, const float* z, int nwz,
                                               void* dqkv, float* dz, float* dscale,
                                               float* dz_part, float* ds_part, int nwb, int n,
                                               int c, int heads, int per_block, int chunks,
                                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hvt::launch_packed_bwd<hvt::bf16>(qkv, dout, scale, z, nwz, dqkv, dz, dscale, dz_part,
                                             ds_part, nwb, n, c, heads, per_block, chunks, s);
  return hvt::launch_packed_bwd<float>(qkv, dout, scale, z, nwz, dqkv, dz, dscale, dz_part,
                                       ds_part, nwb, n, c, heads, per_block, chunks, s);
}

// q, k, v, dout and dq, dk, dv (nWB, H, N, D), all of one dtype: 0 = bf16,
// 1 = f32; nWB a multiple of nWZ. Scratch and chunks as the packed entry's.
// Returns a cudaError_t.
extern "C" int hvt_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const float* scale, const float* z,
                                        int nwz, void* dq, void* dk, void* dv, float* dz,
                                        float* dscale, float* dz_part, float* ds_part, int nwb,
                                        int n, int d, int heads, int per_block, int chunks,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hvt::HeadTiles tiles{(long long)heads * n * d, (long long)n * d, d};
  if (dtype == 0)
    return hvt::launch_attention_bwd<hvt::bf16>(q, k, v, tiles, dout, tiles, scale, z, nwz, dq,
                                                dk, dv, dz, dscale, dz_part, ds_part, nwb, n, d,
                                                heads, per_block, chunks, s);
  return hvt::launch_attention_bwd<float>(q, k, v, tiles, dout, tiles, scale, z, nwz, dq, dk, dv,
                                          dz, dscale, dz_part, ds_part, nwb, n, d, heads,
                                          per_block, chunks, s);
}

// Dynamic shared memory a block of the backward kernel takes, dtype as above.
extern "C" int hvt_window_attention_bwd_smem(int dtype) {
  return dtype == 0 ? (int)hvt::tc_bwd_smem_bytes<hvt::bf16>()
                     : (int)hvt::tc_bwd_smem_bytes<float>();
}

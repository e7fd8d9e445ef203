// The warpgroup-MMA core of the MLP half's two products, fc1 and fc2 (mlp.cu:
// the forward's, and the backward's recompute of h and the pre-LN sum), and
// of the retired block halves' four (swin_block.cu, through wg_gemm_slices),
// on Hopper's `wgmma`, the one way to the card's full bf16 tensor-core rate.
// The flash-attention kernels (flash_attention.cu) take its instructions
// alone: Wgmma<N> at every N a multiple of 16 from 64 to 256, and
// wgmma64_rs_t, A from registers and B read MN-major.
//
// out = A·Bᵀ for A (rows, K) and B (n_rows, K) bf16, both K-contiguous with
// row stride K (x or h, and a weight in nn.Linear's (out, in) layout). A
// block of kWgThreads threads, two warpgroups, owns a kWgBM x BN output tile
// (BN 64, 96 or 128), 64 rows a warpgroup: each warpgroup issues
// `wgmma.mma_async.m64nBNk16.f32.bf16.bf16` with both operands read from
// shared memory through matrix descriptors, its 64 x BN f32 sum in
// registers (BN / 2 a thread). K streams in slices of kWgBK = 64 bf16, one
// 128-byte row, through a kWgStages-deep ring filled by cp.async (every
// thread copies 16-byte pieces; rows past the matrix edge and K past its end
// are zero-filled, so M, N and K need not be multiples of the tile: K = 96
// is one slice and a half). Each slice lands in the 128-byte swizzle that
// `wgmma` reads: 16-byte piece c of row r at r·128 + ((c ^ (r mod 8))·16)
// from a 1024-byte-aligned base, so a descriptor's leading offset is unused,
// its stride 1024 bytes (eight rows), and the k16 steps of a slice advance
// its start address by 32 bytes. Slice s + 2 is copied while slice s is
// multiplied; a stage is refilled only after every warpgroup has waited for
// the products that read it (wgmma.wait_group 0 before the next barrier),
// and the copies are made visible to the tensor cores' async proxy by
// fence.proxy.async before the barrier that publishes them.
//
// The accumulator of m64nNk16 is mma.sync's m16n8 layout, one warp a 16-row
// band: value 4j + 2h + e of lane l of warp w of the warpgroup sits at row
// 16w + l/4 + 8h, column 8j + 2(l mod 4) + e (wg_pairs). A bf16 result tile
// goes out through the ring (wg_store_bf16) in whole 16-byte pieces of
// rows, not as the fragments' scattered 4-byte pairs.
//
// Two blocks an SM (256 threads, at most 128 registers a thread, 73-97 KB
// of shared memory each): one block's epilogue and its ring's first slices
// overlap the other's products. On the H100 that beat a fourth stage with
// one product group left in flight, which leaves room for one block an SM,
// at every SwinV2-T shape.
#pragma once

#include "gemm_tc.cuh"

namespace hvt {

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kWgBM = 128;       // rows of an output tile, 64 a warpgroup
constexpr int kWgBK = 64;        // K slice: one 128-byte row of bf16, the swizzle's width
constexpr int kWgStages = 3;

// Dynamic shared memory of a block with BN-column tiles: the ring, and
// 1024 bytes to align it to the swizzle's 1024-byte pattern.
template <int BN>
constexpr size_t wg_smem() { return 1024 + (size_t)kWgStages * (kWgBM + BN) * 128; }

// wgmma.mma_async m64nNk16, bf16 operands, f32 sums, d += a·b: Wgmma<N>::mma
// reads A and B from shared memory through descriptors, both K-major (N a
// multiple of 16 from 64 to 256: the MLP's tiles and the flash kernels' key
// or query tiles, csrc/flash_attention.cu). The operand lists are written
// out, eight accumulators to a HVT_WG_D8.
template <int N>
struct Wgmma;

#define HVT_WG_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void mma(float (&d)[40], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<112> {
  __device__ __forceinline__ static void mma(float (&d)[56], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55"
        "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<144> {
  __device__ __forceinline__ static void mma(float (&d)[72], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71"
        "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<160> {
  __device__ __forceinline__ static void mma(float (&d)[80], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64), HVT_WG_D8(72)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<176> {
  __device__ __forceinline__ static void mma(float (&d)[88], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87"
        "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64), HVT_WG_D8(72), HVT_WG_D8(80)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  __device__ __forceinline__ static void mma(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64), HVT_WG_D8(72), HVT_WG_D8(80), HVT_WG_D8(88)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<208> {
  __device__ __forceinline__ static void mma(float (&d)[104], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %106, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103"
        "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64), HVT_WG_D8(72), HVT_WG_D8(80), HVT_WG_D8(88),
          HVT_WG_D8(96)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<224> {
  __device__ __forceinline__ static void mma(float (&d)[112], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %114, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
        "%103, %104, %105, %106, %107, %108, %109, %110, %111"
        "}, %112, %113, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64), HVT_WG_D8(72), HVT_WG_D8(80), HVT_WG_D8(88),
          HVT_WG_D8(96), HVT_WG_D8(104)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<240> {
  __device__ __forceinline__ static void mma(float (&d)[120], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %122, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
        "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
        "%117, %118, %119"
        "}, %120, %121, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64), HVT_WG_D8(72), HVT_WG_D8(80), HVT_WG_D8(88),
          HVT_WG_D8(96), HVT_WG_D8(104), HVT_WG_D8(112)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
        "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
        "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24),
          HVT_WG_D8(32), HVT_WG_D8(40), HVT_WG_D8(48), HVT_WG_D8(56),
          HVT_WG_D8(64), HVT_WG_D8(72), HVT_WG_D8(80), HVT_WG_D8(88),
          HVT_WG_D8(96), HVT_WG_D8(104), HVT_WG_D8(112), HVT_WG_D8(120)
        : "l"(a), "l"(b), "r"(1));
  }
};

// d (64 x 64) += A·B with A from registers and B read MN-major (the
// transpose bit): the flash kernels' p·v, Pᵀ·dO and dSᵀ·q, whose B is a
// tile of 128-byte rows along K (keys or queries), each row 64 columns of N.
// A is the calling warp's 16 rows of a 16-wide K step in mma.sync's m16n8k16
// A layout: a[0] (row l/4, columns 2(l mod 4) + {0, 1}), a[1] (row + 8),
// a[2] (columns + 8), a[3] (both), packed bf16 pairs, which is how the
// m64nNk16 accumulator of the previous product lies (wg_pairs), so two of
// its 8-column groups pack into one K step. The MN-major 128-byte swizzle
// at N = 64 is one swizzle atom wide: the descriptor's leading offset is
// unused and its stride is again 1024 bytes a group of eight K rows, so
// wg_desc serves, and a K step of 16 rows advances it by 2048 bytes.
__device__ __forceinline__ void wgmma64_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HVT_WG_D8(0), HVT_WG_D8(8), HVT_WG_D8(16), HVT_WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle at shared address addr: start address / 16, leading byte offset
// 16 (unused by this layout), stride byte offset 1024 between 8-row groups,
// layout 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products that own them.
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register-A fragments (wgmma64_rs_t): the product reads them
// after the instruction issues, so they stay live and unmoved until it retires.
template <int R>
__device__ __forceinline__ void wg_fence_frag(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// A ROWS x kWgBK slice into dst, swizzled: row r from src + (r0 + r)·ld + k0,
// zeros at r0 + r >= rows or at k0 + 8c >= K.
template <int ROWS>
__device__ __forceinline__ void wg_load_slice(unsigned char* dst, const bf16* __restrict__ src,
                                              long long ld, int r0, int rows, int k0, int K) {
  static_assert(ROWS * 8 % kWgThreads == 0, "whole 16-byte pieces a thread");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / kWgThreads; ++it) {
    const int i = threadIdx.x + it * kWgThreads, r = i >> 3, c = i & 7;
    const bool ok = r0 + r < rows && k0 + 8 * c < K;
    cp_async16_zfill(dst + r * 128 + ((c ^ (r & 7)) << 4),
                     ok ? src + (r0 + r) * ld + k0 + 8 * c : src, ok);
  }
}

// The block's dynamic shared memory from its first 1024-byte boundary.
__device__ __forceinline__ unsigned char* wg_smem_base() {
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  return wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
}

// acc = the sum of `steps` K slices of a block's kWgBM x BN tile, the
// calling thread's share of its warpgroup's 64 rows (wg_pairs):
// load(s, stage) fills `stage` with slice s (cp.async, kWgBM swizzled rows
// of A at stage, BN of B at stage + kWgBM·128; the ring commits and waits).
// Every thread of the block calls it. On return every product has
// completed, but the other warpgroup's may not: wait on the block before
// reusing the ring.
template <int BN, typename LoadFn>
__device__ __forceinline__ void wg_gemm_slices(float (&acc)[BN / 2], int steps, LoadFn load) {
  unsigned char* const sm = wg_smem_base();
  constexpr int kA = kWgBM * 128, kStage = (kWgBM + BN) * 128;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load(s, sm + s * kStage);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWgStages - 2>();  // slice s has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... for every thread; every warpgroup is done with slice s − 1
    const int next = s + kWgStages - 1;
    if (next < steps) load(next, sm + (next % kWgStages) * kStage);
    cp_async_commit();
    const uint32_t a = smem_u32(sm + (s % kWgStages) * kStage) + wg * 64 * 128;
    const uint32_t b = smem_u32(sm + (s % kWgStages) * kStage + kA);
    wg_fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      Wgmma<BN>::mma(acc, wg_desc(a + 32 * kk), wg_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(acc);
  }
}

// acc = A·Bᵀ for the block's tile (rows m0.., BN columns n0..), as
// wg_gemm_slices: K in ceil(K / kWgBK) slices of A's and B's rows.
template <int BN>
__device__ __forceinline__ void wg_gemm_nt(float (&acc)[BN / 2], const bf16* __restrict__ A,
                                           int rows, const bf16* __restrict__ B, int n_rows, int K,
                                           int m0, int n0) {
  wg_gemm_slices<BN>(acc, (K + kWgBK - 1) / kWgBK, [&](int s, unsigned char* d) {
    wg_load_slice<kWgBM>(d, A, K, m0, rows, s * kWgBK, K);
    wg_load_slice<BN>(d + kWgBM * 128, B, K, n0, n_rows, s * kWgBK, K);
  });
}

// fn(row, col, v0, v1) for each pair of neighbouring columns of the calling
// thread's accumulators: row m0 + 64·warpgroup + 16·warp + lane/4 (+ 8),
// col n0 + 8j + 2·(lane mod 4).
template <int BN, typename Fn>
__device__ __forceinline__ void wg_pairs(const float (&acc)[BN / 2], int m0, int n0, Fn fn) {
  const int lane = threadIdx.x & 31;
  const int r0 = m0 + 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fn(r0 + 8 * h, c0 + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Stores the block's kWgBM x BN tile into out (row stride ld bf16, rows
// m0.. below `rows`, columns n0..), each pair of neighbouring columns
// packed by pack(col within the tile, v0, v1): through the ring, free once
// every warpgroup has left wg_gemm_nt, into rows of BN + 8 bf16 (a
// half-warp's 4-byte writes fall in 32 distinct banks), then out in whole
// 16-byte pieces of rows, neighbouring threads on neighbouring pieces.
template <int BN, typename PackFn>
__device__ __forceinline__ void wg_store_bf16(const float (&acc)[BN / 2], PackFn pack,
                                              bf16* __restrict__ out, long long ld, int m0, int n0,
                                              int rows) {
  constexpr int kLd = BN + 8, kPieces = BN / 8;
  static_assert(kWgBM * kLd * sizeof(bf16) <= kWgStages * (kWgBM + BN) * 128, "fits the ring");
  bf16* const tile = reinterpret_cast<bf16*>(wg_smem_base());
  __syncthreads();  // every warpgroup is done with the ring
  wg_pairs<BN>(acc, 0, 0, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(tile + r * kLd + c) = pack(c, v0, v1);
  });
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kWgBM * kPieces / kWgThreads; ++it) {
    const int i = threadIdx.x + it * kWgThreads, r = i / kPieces, c = 8 * (i % kPieces);
    if (m0 + r < rows)
      *reinterpret_cast<uint4*>(out + (m0 + r) * ld + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kLd + c);
  }
}

}  // namespace hvt

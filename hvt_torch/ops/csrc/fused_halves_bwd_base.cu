// The fused SwinV2 block halves' backward kernels (fused_halves_bwd.cu) at
// SwinV2-B's widths: the attention half at C in {128, 256, 512, 1024}, the
// MLP half at {128, 256, 512} (a C = 1024 block trains through the chunked
// MLP, fused_halves_chunked.cu, as hvt routes it). A library of its own, so
// that its nvcc runs beside the one for SwinV2-T's widths.
#define HVT_WIDTHS(F) F(128) F(256) F(512) F(1024)
#define HVT_MLP_WIDTHS(F) F(128) F(256) F(512)
#include "fused_halves_bwd.cu"

// The attention half's forward kernels (fused_halves.cu) at
// SwinV2-B's widths, C in {128, 256, 512, 1024}. A library of its own, so
// that its nvcc runs beside the one for SwinV2-T's widths and the build
// takes as long as the slower of the two, not their sum.
#define HVT_WIDTHS(F) F(128) F(256) F(512) F(1024)
#include "fused_halves.cu"

// The attention half on pre-partitioned windows (attention_half.cu) at
// SwinV2-B's widths, C in {128, 256, 512, 1024}: a library of its own, so
// that its nvcc runs beside the one for SwinV2-T's widths.
#define HVT_WIDTHS(F) F(128) F(256) F(512) F(1024)
#include "attention_half.cu"

// The float32-operand (3xTF32) instantiations of the ConvNeXt MLP-tail
// kernels; what they compute, replace and how: convnext_mlp.cu. A
// translation unit of its own so that nvcc compiles the two operand types
// in parallel.

#include "convnext_mlp.cuh"

ROBSEG_MLP_DEFINE(f32, false)

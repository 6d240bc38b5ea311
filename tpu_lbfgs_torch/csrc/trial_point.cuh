// The line search's trial point x + a d, one element at a time.
//
// Every kernel that forms a trial point, its own element's or a chain
// neighbour's, forms it here: the product and the sum are each rounded once
// (no fused multiply-add), as the plain PyTorch version `x + a * d` rounds
// them.  So a neighbour's value, rebuilt by another thread, equals its
// owner's bit for bit.
#pragma once

namespace tl {

__device__ __forceinline__ float trial_point(float x, float d, float a) {
  return __fadd_rn(x, __fmul_rn(a, d));
}

}  // namespace tl

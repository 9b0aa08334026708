// Kernel H: the batch-major external-product contraction, int8 digits x one
// GGSW -> int32 limb sums.
//
// Replaces: tfhe_tpu/ops/pallas/ep_kernel.py, ep_contract_pallas (body
// _ep_kernel).  It computes, exactly,
//
//   out[b, c*4 + l, o] = sum_{r, m} d[b, r, m] * limb_l( +-g[r, c, (o - m) mod N] )
//
// Shapes: d int8 [B, R, N], g u32 [R, C, N], out int32 [B, C*4, N]: the
// layout of the GGSW external product (models/ggsw.py) and of the 'conv'
// blind-rotation scan.  What bounds it and the design (Kernel A's, with the
// batch-major digit and output indexing) are in ep_contract.cuh.

#include "ep_contract.cuh"

namespace {

template <int MT>
__global__ void __launch_bounds__(128)
ep_contract_kernel(const int8_t* __restrict__ digits, const uint32_t* __restrict__ rows,
                   int32_t* __restrict__ out, ep::Plan p) {
  // digit row (r, b) at (b*R + r)*N; output row (f, b) at (b*4C + f)*N
  ep::contract<MT>(digits, rows, out, p, ep::Layout{1, p.R, 1, 4 * p.C});
}

const ep::KernelFn kKernels[2] = {ep_contract_kernel<1>, ep_contract_kernel<2>};

}  // namespace

extern "C" {

// digits int8 [B, R, N], ggsw u32 [R, C, N] -> out int32 [B, C*4, N], with
// the plan of ops/cuda/ep_kernel.py:ep_plan; info as for ep_contract_rbn.
// Returns cudaErrorInvalidValue for what ep::launch does not take (N not a
// power of two >= 32 among them).
int ep_contract(const void* digits, const void* ggsw, void* out, int R, int B, int C, int N,
                int bm, int warps, int split, int rows_per, int nbuf, int* info, void* stream) {
  const ep::Plan p{R, B, C, N, bm, warps, split, rows_per, nbuf};
  return ep::launch(kKernels, digits, ggsw, out, p, info, stream);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

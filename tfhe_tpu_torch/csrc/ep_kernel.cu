// Kernel A: one external-product step, int8 digits x GGSW rows -> int32 limb planes.
//
// Replaces: tfhe_tpu/ops/pallas/ep_kernel.py, ep_contract_pallas_rbn (body
// _ep_kernel_rbn).  It computes, exactly,
//
//   out[c, l, b, o] = sum_{r, m} d[r, b, m] * limb_l( +-g[r, c, (o - m) mod N] )
//
// Shapes: d int8 [R, B, N], g u32 [R, C, N], out int32 [C, 4, B, N].  The
// blind-rotation scan passes level-major rows.  What bounds it and the design
// (shared with Kernel H, the batch-major layout) are in ep_contract.cuh.

#include "ep_contract.cuh"

namespace {

__global__ void ep_contract_rbn_kernel(const int8_t* __restrict__ digits,
                                       const uint32_t* __restrict__ rows,
                                       int32_t* __restrict__ out,
                                       int R, int B, int C, int N) {
  // digit row (r, b) at (r*B + b)*N; output plane (f, b) at (f*B + b)*N
  ep::contract(digits, rows, out, R, B, C, N, ep::Layout{B, 1, B, 1});
}

}  // namespace

extern "C" {

// digits int8 [R, B, N], rows u32 [R, C, N] -> out int32 [C, 4, B, N].
// Returns cudaErrorInvalidValue unless N is a power of two >= 8 and B, C >= 1.
int ep_contract_rbn(const void* digits, const void* rows, void* out, int R, int B,
                    int C, int N, void* stream) {
  return ep::launch(ep_contract_rbn_kernel, digits, rows, out, R, B, C, N, stream);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

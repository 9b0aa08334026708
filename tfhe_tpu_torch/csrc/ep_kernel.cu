// Kernel A: one external-product step, int8 digits x GGSW rows -> int32 limb planes.
//
// Replaces: tfhe_tpu/ops/pallas/ep_kernel.py, ep_contract_pallas_rbn (body
// _ep_kernel_rbn).  It computes, exactly,
//
//   out[c, l, b, o] = sum_{r, m} d[r, b, m] * limb_l( +-g[r, c, (o - m) mod N] )
//
// Shapes: d int8 [R, B, N], g u32 [R, C, N], out int32 [C, 4, B, N].  The
// blind-rotation scan passes level-major rows.  What bounds it and the design
// (int8 mma.sync on byte-shifted limb planes, shared with Kernel H, the
// batch-major layout) are in ep_contract.cuh.

#include "ep_contract.cuh"

namespace {

template <int MT>
__global__ void __launch_bounds__(128)
ep_contract_rbn_kernel(const int8_t* __restrict__ digits, const uint32_t* __restrict__ rows,
                       int32_t* __restrict__ out, ep::Plan p) {
  // digit row (r, b) at (r*B + b)*N; output plane (f, b) at (f*B + b)*N
  ep::contract<MT>(digits, rows, out, p, ep::Layout{p.B, 1, p.B, 1});
}

const ep::KernelFn kKernels[2] = {ep_contract_rbn_kernel<1>, ep_contract_rbn_kernel<2>};

}  // namespace

extern "C" {

// digits int8 [R, B, N], rows u32 [R, C, N] -> out int32 [C, 4, B, N], with
// the plan of ops/cuda/ep_kernel.py:ep_plan (bm samples per CTA, warps,
// split CTAs per cluster of rows_per rows each, nbuf digit buffers).  info
// (host, 2 ints) receives the dynamic shared memory bytes and the CTAs.
// Returns cudaErrorInvalidValue for what ep::launch does not take (N not a
// power of two >= 32 among them).
int ep_contract_rbn(const void* digits, const void* rows, void* out, int R, int B, int C,
                    int N, int bm, int warps, int split, int rows_per, int nbuf, int* info,
                    void* stream) {
  const ep::Plan p{R, B, C, N, bm, warps, split, rows_per, nbuf};
  return ep::launch(kKernels, digits, rows, out, p, info, stream);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

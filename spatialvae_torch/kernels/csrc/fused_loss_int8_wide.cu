// K3 for H > 512 (fused_loss_int8.cuh, int8_tile.cuh): the `WIDE`
// instantiations of both passes, the measurement levers read at run time,
// in a translation unit of their own so that nvcc builds them beside the
// default kernels.

#include "fused_loss_int8.cuh"

namespace svt8 {

cudaError_t loss_fwd_wide(const LossFwdArgs& a, int b0, int pb, bool bf16,
                          bool colored, bool tile, cudaStream_t st) {
  return dispatch_fwd<true, true>(a, b0, pb, bf16, colored, tile, st);
}

cudaError_t loss_grad_wide(const LossGradArgs& a, int pb, bool bf16, bool sr,
                           cudaStream_t st) {
  return dispatch_grad<true, true>(a, pb, bf16, sr, st);
}

}  // namespace svt8

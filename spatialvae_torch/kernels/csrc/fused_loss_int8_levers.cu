// K3's measurement levers (SPATIALVAE_TANH=pade, SPATIALVAE_A1Q,
// SPATIALVAE_PHASE_CUT; fused_loss_int8.cuh) at H <= 512: the `LEV`
// instantiations of both passes, in a translation unit of their own so that
// the default kernels compile without them and nvcc builds the two in
// parallel.

#include "fused_loss_int8.cuh"

namespace svt8 {

cudaError_t loss_fwd_levers(const LossFwdArgs& a, int pb, bool bf16,
                            bool colored, bool tile, cudaStream_t st) {
  return dispatch_fwd<false, true>(a, 0, pb, bf16, colored, tile, st);
}

cudaError_t loss_grad_levers(const LossGradArgs& a, int pb, bool bf16,
                             bool sr, cudaStream_t st) {
  return dispatch_grad<false, true>(a, pb, bf16, sr, st);
}

}  // namespace svt8

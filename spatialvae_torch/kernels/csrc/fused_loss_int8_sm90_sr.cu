// K3's cluster passes with stochastic rounding at both quantisation sites
// (the SR mode bit alone, SPATIALVAE_SR=1 / --int8-sr): the SR
// instantiations of the pass bodies of fused_loss_int8_sm90.cuh, in a
// translation unit of their own, so that nvcc builds them beside the
// default ones and those keep their code.

#include "fused_loss_int8_sm90.cuh"

namespace {

template <bool BF16, bool COLORED>
__global__ void __launch_bounds__(NT, 1)
loss_fwd90_sr_kernel(const LossFwdArgs a, int nquads, int b0, int pb,
                     int8_t* aq_ws) {
  loss_fwd90_body<BF16, COLORED, true>(a, nquads, b0, aq_ws, pb);
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 1)
loss_grad90_sr_kernel(const LossGradArgs a, int nquads, int pb) {
  loss_grad90_body<BF16, true>(a, nquads, pb);
}

int fwd_sr_clusters(bool bf16, bool colored) {
  static int c[4] = {0, 0, 0, 0};
  int* at = &c[2 * colored + bf16];
  if (colored)
    return bf16 ? cached_clusters(loss_fwd90_sr_kernel<true, true>, NT,
                                  sizeof(FwdSmem), at)
                : cached_clusters(loss_fwd90_sr_kernel<false, true>, NT,
                                  sizeof(FwdSmem), at);
  return bf16 ? cached_clusters(loss_fwd90_sr_kernel<true, false>, NT,
                                sizeof(FwdSmem), at)
              : cached_clusters(loss_fwd90_sr_kernel<false, false>, NT,
                                sizeof(FwdSmem), at);
}

int grad_sr_clusters(bool bf16) {
  static int c[2] = {0, 0};
  return bf16 ? cached_clusters(loss_grad90_sr_kernel<true>, NT,
                                sizeof(GradSmem), &c[1])
              : cached_clusters(loss_grad90_sr_kernel<false>, NT,
                                sizeof(GradSmem), &c[0]);
}

}  // namespace

namespace svt8 {

cudaError_t loss_fwd_sm90_sr(const LossFwdArgs& a, int b0, int pb,
                             int8_t* aq_ws, bool bf16, cudaStream_t st) {
  // the a1c stash, and the dW1 workspace the forward leaves aq in
  if (a.ws == nullptr || aq_ws == nullptr)
    return cudaErrorInvalidValue;
  const bool colored = a.family == COLORED;
  const int nquads = int(a.grid / CS);
  const int ncl = min(nquads, fwd_sr_clusters(bf16, colored));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  const unsigned grid = unsigned(ncl * CS);
  const int smem = sizeof(FwdSmem);
  if (colored)
    return bf16 ? launch_clusters(loss_fwd90_sr_kernel<true, true>, grid, NT,
                                  smem, CS, st, a, nquads, b0, pb, aq_ws)
                : launch_clusters(loss_fwd90_sr_kernel<false, true>, grid,
                                  NT, smem, CS, st, a, nquads, b0, pb, aq_ws);
  return bf16 ? launch_clusters(loss_fwd90_sr_kernel<true, false>, grid, NT,
                                smem, CS, st, a, nquads, b0, pb, aq_ws)
              : launch_clusters(loss_fwd90_sr_kernel<false, false>, grid, NT,
                                smem, CS, st, a, nquads, b0, pb, aq_ws);
}

cudaError_t loss_grad_sm90_sr(const LossGradArgs& a, int pb, bool bf16,
                              cudaStream_t st) {
  if (a.ws == nullptr) return cudaErrorInvalidValue;     // the a1c stash
  const int nquads = int(a.grid / CS);
  const int ncl = min(nquads, grad_sr_clusters(bf16));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return bf16 ? launch_clusters(loss_grad90_sr_kernel<true>,
                                unsigned(ncl * CS), NT, sizeof(GradSmem), CS,
                                st, a, nquads, pb)
              : launch_clusters(loss_grad90_sr_kernel<false>,
                                unsigned(ncl * CS), NT, sizeof(GradSmem), CS,
                                st, a, nquads, pb);
}

int loss90_sr_max_clusters(int which) {
  switch (which) {
    case 0: return fwd_sr_clusters(true, false);
    case 1: return fwd_sr_clusters(false, false);
    case 2: return grad_sr_clusters(true);
    case 3: return grad_sr_clusters(false);
    case 4: return fwd_sr_clusters(true, true);
    case 5: return fwd_sr_clusters(false, true);
    default: return 0;
  }
}

}  // namespace svt8

"""The inverses of the sm90 decoder kernels' operand layouts and the plain
version of their dW1 kernel, for the tests: the CPU tests check the layout
the wrapper builds (``fused_decoder.decoder_slabs``) and the one the chain
writes, and the card tests feed the dW1 kernel workspaces laid out here.
Imports no JAX."""

import torch

from spatialvae_torch.kernels import fused_decoder as fd

W = fd.SM90_WIDTH


def decoder_slab_planes(slabs: torch.Tensor, k: int) -> torch.Tensor:
    """``decoder_slabs``' inverse: (P, SM90_WIDTH, Kp) planes."""
    kp = fd.slab_k(k)
    e = fd._chunk_values(slabs.dtype)
    ks = 4 * e
    t = fd._swizzle64(slabs.reshape(kp // ks, -1, W, 4, e))
    return t.permute(1, 2, 0, 3, 4).reshape(-1, W, kp)


def dec90_ws_layout(tiles: torch.Tensor) -> torch.Tensor:
    """(NB, 64, SM90_WIDTH) operand tiles (64-pixel blocks, pixel rows, f32
    or bf16) -> the dW1 workspace the sm90 chain writes: per block
    (SM90_WIDTH rows, 64 pixels) as 64-byte K chunks of SM90_WIDTH swizzled
    rows; pixel 16 w + g + 8 h of a block at position 16 w + 2 g + h (the
    order an accumulator thread holds its two rows in; dW1 sums over all of
    them).  One contiguous 1-D tensor of the tiles' dtype."""
    nb, pt, kw = tiles.shape
    t = tiles.reshape(nb, 4, 2, 8, kw).permute(0, 1, 3, 2, 4)
    t = t.reshape(nb, pt, kw).transpose(1, 2)            # (NB, rows, pos)
    e = fd._chunk_values(tiles.dtype)
    per = 4 * e
    t = t.reshape(nb, kw, pt // per, 4, e).permute(0, 2, 1, 3, 4)
    return fd._swizzle64(t.contiguous()).reshape(-1)


def dec90_ws_tiles(ws: torch.Tensor, nb: int) -> torch.Tensor:
    """``dec90_ws_layout``' inverse: (NB, 64 pixels, SM90_WIDTH)."""
    e = fd._chunk_values(ws.dtype)
    per = 4 * e
    pt = fd.BLOCK_PIXELS
    t = fd._swizzle64(ws.reshape(nb, pt // per, W, 4, e))
    t = t.permute(0, 2, 1, 3, 4).reshape(nb, W, pt)
    t = t.transpose(1, 2).reshape(nb, 4, 8, 2, W)
    return t.permute(0, 1, 3, 2, 4).reshape(nb, pt, W)


def dec90_dw_reference(ws_a0: torch.Tensor, ws_dh: torch.Tensor, nb: int,
                       h: int, splits: int) -> torch.Tensor:
    """The plain version of the sm90 dW1 kernel (``svt_decoder90_dw``):
    (splits, H, H) float32 partials, split s summing blocks s*bps ..
    (s+1)*bps - 1 (bps = ceil(NB / splits)) of sum_p a0^T[i][p] dh^T[j][p]
    over the operand planes as the kernel multiplies them (f32: the TF32
    head and tail, lo.hi + hi.lo + hi.hi; bf16: the values), in float64."""
    a = fd._planes(dec90_ws_tiles(ws_a0, nb)[..., :h]).double()
    d = fd._planes(dec90_ws_tiles(ws_dh, nb)[..., :h]).double()
    bps = -(-nb // splits)
    out = torch.zeros((splits, h, h), dtype=torch.float64, device=a.device)
    for s in range(splits):
        aa, dd = a[:, s * bps:(s + 1) * bps], d[:, s * bps:(s + 1) * bps]
        prod = lambda x, y: torch.einsum("bpi,bpj->ij", x, y)
        if a.shape[0] == 1:
            out[s] = prod(aa[0], dd[0])
        else:
            out[s] = (prod(aa[1], dd[0]) + prod(aa[0], dd[1])
                      + prod(aa[0], dd[0]))
    return out.float()

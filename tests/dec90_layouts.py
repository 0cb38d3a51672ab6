"""The inverses of the sm90 decoder kernels' operand layouts, the plain
version of their dW kernels, and host emulations of the deep kernels'
schedules, for the tests: the CPU tests check the layout the wrapper
builds (``fused_decoder.decoder_slabs``) and the one the chain writes and
hold the emulations to the JAX package, and the card tests feed the dW
kernels workspaces laid out here.  Imports no JAX."""

import torch

from spatialvae_torch.kernels import fused_decoder as fd

W = fd.SM90_WIDTH


def decoder_slab_planes(slabs: torch.Tensor, k: int,
                        n: int = W) -> torch.Tensor:
    """``decoder_slabs``' inverse for an (n, k) matrix: (P, rows, Kp)
    planes, rows = ``sm90_rows(n)`` (chunk after chunk of SM90_WIDTH)."""
    kp = fd.slab_k(k)
    nch = fd.sm90_rows(n) // W
    e = fd._chunk_values(slabs.dtype)
    ks = 4 * e
    t = fd._swizzle64(slabs.reshape(nch, kp // ks, -1, W, 4, e))
    t = t.permute(2, 0, 3, 1, 4, 5)          # (P, chunk, row, unit, 4, e)
    return t.reshape(t.shape[0], nch * W, kp)


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


def dec90_ws_tiles(ws: torch.Tensor, nb: int, rows: int = W) -> torch.Tensor:
    """``dec90_ws_layout``' inverse: (NB, 64 pixels, rows)."""
    e = fd._chunk_values(ws.dtype)
    per = 4 * e
    pt = fd.BLOCK_PIXELS
    t = fd._swizzle64(ws.reshape(nb, pt // per, rows, 4, e))
    t = t.permute(0, 2, 1, 3, 4).reshape(nb, rows, pt)
    t = t.transpose(1, 2).reshape(nb, 4, 8, 2, rows)
    return t.permute(0, 1, 3, 2, 4).reshape(nb, pt, rows)


def dec90_dw_reference(ws_a0: torch.Tensor, ws_dh: torch.Tensor, nb: int,
                       h: int, splits: int, rows: int = W) -> torch.Tensor:
    """The plain version of the sm90 dW1 kernel (``svt_decoder90_dw``):
    and of the deep kernels' dW (``svt_decoder90_dw_deep``, workspaces of
    ``rows`` rows a block): (splits, H, H) float32 partials, split s
    summing blocks s*bps ..
    (s+1)*bps - 1 (bps = ceil(NB / splits)) of sum_p a0^T[i][p] dh^T[j][p]
    over the operand planes as the kernel multiplies them (f32: the TF32
    head and tail, lo.hi + hi.lo + hi.hi; bf16: the values), in float64."""
    a = fd._planes(dec90_ws_tiles(ws_a0, nb, rows)[..., :h]).double()
    d = fd._planes(dec90_ws_tiles(ws_dh, nb, rows)[..., :h]).double()
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


def ws_blocks(t: torch.Tensor, hw: int, rows: int = W) -> torch.Tensor:
    """(B, HW, H) -> (B * tiles, 64, rows): 64-pixel blocks, zero past HW
    and past H (a dW operand's blocks before ``dec90_ws_layout``)."""
    b, _, h = t.shape
    tiles = -(-hw // fd.BLOCK_PIXELS)
    out = torch.zeros((b, tiles * fd.BLOCK_PIXELS, rows), dtype=t.dtype)
    out[:, :hw, :h] = t
    return out.reshape(b * tiles, fd.BLOCK_PIXELS, rows)


def product_by_slabs(a: torch.Tensor, slabs: torch.Tensor, n: int,
                     wdt: torch.dtype) -> torch.Tensor:
    """The sm90 kernels' product of A (B, HW, K) float32 (values already
    cast to the weight dtype) by the (n, K) matrix whose slab stream is
    ``slabs``: output column chunk by chunk of SM90_WIDTH rows, each over
    the K slabs in order, with the operand planes the kernels multiply
    (f32: TF32 head and tail, lo.hi + hi.lo + hi.hi; bf16: the values),
    summed in float64.  Returns (B, HW, n) float32."""
    k = a.shape[-1]
    kp = fd.slab_k(k)
    wpl = decoder_slab_planes(slabs, k, n).double()
    rows = wpl.shape[1]
    ks = fd.SLAB_BYTES // (torch.finfo(wdt).bits // 8)
    ap = torch.zeros(a.shape[:-1] + (kp,))
    ap[..., :k] = a
    out = torch.zeros(a.shape[:-1] + (rows,), dtype=torch.float64)
    for c in range(rows // W):
        r = slice(c * W, (c + 1) * W)
        for s in range(kp // ks):
            cols = slice(s * ks, (s + 1) * ks)
            x = ap[..., cols]
            wh = wpl[0, r, cols].T
            if wdt == torch.bfloat16:
                out[..., r] += x.to(wdt).double() @ wh
            else:
                hi, lo = (p.double() for p in fd.tf32_split(x))
                out[..., r] += lo @ wh + hi @ wpl[1, r, cols].T + hi @ wh
    return out[..., :n].float()


def deep_forward(fold, coords, whid, bhid, wht, bht, resid: bool) -> tuple:
    """The deep kernels' forward schedule on the CPU: one pass per layer,
    A = cast(a_{l-1}) (layer 1 from the fold, above it the f32 buffer the
    pass below wrote) through ``product_by_slabs`` over W_l^T's chunked
    slab stream, then bias, the residual add, tanh; the head over the last
    layer's column chunks, its partial sums added in chunk order, then
    the sigmoid.  Returns (y (B, No, HW), the f32 activations (Lh, B, HW,
    H))."""
    wdt = whid.dtype
    lh, h = whid.shape[:2]
    a = torch.tanh(fd._first_layer(fold, coords))
    acts = []
    for l in range(lh):
        z = product_by_slabs(a.to(wdt).float(), fd.decoder_slabs(whid[l].T),
                             h, wdt)
        x = z + bhid[l].float()
        if resid:
            x = x + a
        a = torch.tanh(x)
        acts.append(a)
    ac = a.to(wdt).float()
    z = torch.zeros(a.shape[:-1] + (wht.shape[0],))
    for c in range(0, h, W):
        cols = slice(c, min(c + W, h))
        z = z + ac[..., cols] @ wht[:, cols].float().T
    y = torch.sigmoid(z + bht.float()).transpose(1, 2)
    return y, torch.stack(acts)


def deep_backward(fold, coords, whid, wht, acts, y, g, resid: bool,
                  splits: int = 2) -> tuple:
    """The deep kernels' backward schedule on the CPU: chain passes l = Lh
    .. 1, dh_l = da_l (1 - a_l^2) from the head (top) or the f32 da buffer
    the pass above wrote, da_{l-1} = cast(dh_l) . W_l^T through
    ``product_by_slabs`` over W_l's chunked slab stream [+ dh_l]; dW_l from
    cast(a_{l-1})^T and cast(dh_l)^T laid out as the chain writes them
    (``dec90_ws_layout``, ``sm90_rows(H)`` rows a block) through the dW
    kernel's plain version; dh0 and dfold with a0 rebuilt.  ``acts``: the
    (Lh, B, HW, H) residual in the weight dtype (or f32).  Returns the
    outputs of ``decoder_tail_backward_reference``."""
    wdt = whid.dtype
    lh, h = whid.shape[:2]
    b, hw = fold.shape[0], coords.shape[0]
    nb = b * -(-hw // fd.BLOCK_PIXELS)
    rows = fd.sm90_rows(h)
    a0 = torch.tanh(fd._first_layer(fold, coords))
    act = [acts[l].float() for l in range(lh)]
    s = y.float()
    dz2 = g.float() * s * (1.0 - s)
    dz2c = dz2.to(wdt).float()
    da = torch.einsum("bop,oh->bph", dz2c, wht.float())
    dwh, dbh = [None] * lh, [None] * lh
    for l in range(lh - 1, -1, -1):
        dh = da * (1.0 - act[l] * act[l])
        a_in = act[l - 1] if l else a0
        ws_a = dec90_ws_layout(ws_blocks(a_in.to(wdt), hw, rows))
        ws_dh = dec90_ws_layout(ws_blocks(dh.to(wdt), hw, rows))
        dwh[l] = dec90_dw_reference(ws_a, ws_dh, nb, h, splits,
                                    rows).sum(0)
        dbh[l] = dh.sum(dim=(0, 1))
        da = product_by_slabs(dh.to(wdt).float(), fd.decoder_slabs(whid[l]),
                              h, wdt)
        if resid:
            da = da + dh
    dh0 = da * (1.0 - a0 * a0)
    x0 = coords[:, 0].float()[None, :, None]
    x1 = coords[:, 1].float()[None, :, None]
    dfold = torch.stack([(x0 * dh0).sum(1), (x1 * dh0).sum(1), dh0.sum(1),
                         torch.zeros_like(dh0[:, 0])], dim=1)
    dwht = torch.einsum("bop,bph->oh", dz2c, act[-1].to(wdt).float())
    return dfold, torch.stack(dwh), torch.stack(dbh), dwht, dz2.sum((0, 2))

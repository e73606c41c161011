"""K4 and K5, the pair-descriptor loss of the stylization fit and its
gradient: CUDA kernel wrappers, their plain versions, and the autograd op.

Port of `wast3d_tpu/stylize/desc_kernel.py`. For each ball b of a batch,

    loss[b] = sum_ij W_ij (D_ij - T_ij)^2,
    D = cdist(x[b], x[b]),  T = cdist(tp, tp),
    W_ij = cg * bit0(code_ij) + cl * bit1(code_ij),

every distance |a - b| from the coordinate differences, and

    dL/dx_i = sum_j (R_ij + R_ji)(x_i - x_j),
    R_ij = 2 W_ij (D_ij - T_ij) / max(D_ij, 1e-12).

x is [B, Mp, 3] (the JAX kernel takes one ball and `vmap` adds the batch;
here the batch is a tensor dimension), tp [Mp, 3] and code [Mp, Mp] uint8
are shared by the batch, Mp is a multiple of `MP_ALIGN`. No [Mp, Mp] float
is ever materialised.

The TPU kernel takes each distance as sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0))
(its MXU form). In float32 that has an error of ~1e-7 |a|^2 in D^2, all of
D^2 for points 1e-4 apart, and R_ij's 1 / D turns it into gradient errors
of ~1e5 x max |g| (`chip_smoke.py`, k4k5_near_coincident, on an H100);
near-duplicate Gaussians of a trained scene make such pairs. The differences are exact there; elsewhere the two forms agree to
float32 rounding.

`desc_loss` (K4, `csrc/desc_loss.cu`) and `desc_grad` (K5,
`csrc/desc_grad.cu`) launch their kernel for CUDA tensors (counted in
`.launches`) and take the plain version, `pair_loss_reference` /
`pair_grad_reference`, for CPU tensors. `pair_loss` is the autograd op:
K4 forward, K5 backward; tp, code and the coefficients get no gradient.
"""

from __future__ import annotations

import torch

MP_ALIGN = 1024  # K4's column block: Mp must be a multiple of it
EPS = 1e-12  # K5's floor under D in R_ij


def _check(x, tp, code):
    if x.dim() != 3 or x.shape[2] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be [B, Mp, 3] float32, got {x.dtype} {tuple(x.shape)}")
    b, mp = x.shape[0], x.shape[1]
    if b < 1 or mp % MP_ALIGN != 0 or mp == 0:
        raise ValueError(f"x must hold at least one ball of Mp points, Mp a multiple of "
                         f"{MP_ALIGN}, got {tuple(x.shape)}")
    if tuple(tp.shape) != (mp, 3) or tp.dtype != torch.float32:
        raise ValueError(f"tp must be [{mp}, 3] float32, got {tp.dtype} {tuple(tp.shape)}")
    if tuple(code.shape) != (mp, mp) or code.dtype != torch.uint8:
        raise ValueError(f"code must be [{mp}, {mp}] uint8, got {code.dtype} {tuple(code.shape)}")
    for name, t in (("x", x), ("tp", tp), ("code", code)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.device.type == "cuda" and code.data_ptr() % 16 != 0:
        raise ValueError("code must be 16-byte aligned (the kernels read it as uint4)")


def _launch(name, x, *args):
    from wast3d_tpu_torch import _build

    lib = _build.load_library()
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = getattr(lib, name)(*args, index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.w3d_error_string(err).decode()})")


def desc_loss(x: torch.Tensor, tp: torch.Tensor, code: torch.Tensor,
              cg: float, cl: float) -> torch.Tensor:
    """K4. [B] float32: each ball's loss (module doc)."""
    _check(x, tp, code)
    if x.device.type == "cpu":
        return pair_loss_reference(x, tp, code, cg, cl)
    if x.device.type != "cuda":
        raise ValueError(f"desc_loss runs on cuda or cpu, not {x.device}")
    from wast3d_tpu_torch import _build

    b, mp = x.shape[0], x.shape[1]
    partial = torch.empty(_build.load_library().w3d_desc_loss_partials(b, mp),
                          dtype=torch.float32, device=x.device)
    loss = torch.empty(b, dtype=torch.float32, device=x.device)
    _launch("w3d_desc_loss", x, x.data_ptr(), tp.data_ptr(), code.data_ptr(), b, mp,
            float(cg), float(cl), partial.data_ptr(), loss.data_ptr())
    desc_loss.launches += 1
    return loss


desc_loss.launches = 0


def desc_grad(x: torch.Tensor, tp: torch.Tensor, code: torch.Tensor,
              cg: float, cl: float) -> torch.Tensor:
    """K5. [B, Mp, 3] float32: d(sum_b loss[b]) / dx."""
    _check(x, tp, code)
    if x.device.type == "cpu":
        return pair_grad_reference(x, tp, code, cg, cl)
    if x.device.type != "cuda":
        raise ValueError(f"desc_grad runs on cuda or cpu, not {x.device}")
    dx = torch.empty_like(x)
    _launch("w3d_desc_grad", x, x.data_ptr(), tp.data_ptr(), code.data_ptr(), x.shape[0],
            x.shape[1], float(cg), float(cl), dx.data_ptr())
    desc_grad.launches += 1
    return dx


desc_grad.launches = 0


def _sqrt0(d2: torch.Tensor) -> torch.Tensor:
    """sqrt(d2) for d2 >= 0, with a zero gradient at d2 = 0 instead of the
    inf x 0 = NaN that autograd would give through a plain sqrt."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def _weights(code: torch.Tensor, cg: float, cl: float) -> torch.Tensor:
    c = code.to(torch.int32)
    return cg * (c & 1).to(torch.float32) + cl * ((c >> 1) & 1).to(torch.float32)


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., M, 3] -> [..., N, M] squared distances from the
    coordinate differences (as the kernels take them)."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def pair_loss_reference(x: torch.Tensor, tp: torch.Tensor, code: torch.Tensor,
                        cg: float, cl: float, block: int = 256) -> torch.Tensor:
    """Plain version of K4: each ball's sum by column blocks of `block`
    (the streaming `descriptor_loss` of the JAX fit, with the distances
    from differences). Differentiable."""
    mp = x.shape[1]
    loss = x.new_zeros(x.shape[0])
    for s in range(0, mp, block):
        d = _sqrt0(_sq_dists(x, x[:, s:s + block]))
        t = _sqrt0(_sq_dists(tp, tp[s:s + block]))
        w = _weights(code[:, s:s + block], cg, cl)
        loss = loss + torch.sum(w * (d - t) ** 2, dim=(1, 2))
    return loss


def pair_grad_reference(x: torch.Tensor, tp: torch.Tensor, code: torch.Tensor,
                        cg: float, cl: float, block: int = 256) -> torch.Tensor:
    """Plain version of K5, its formula written out by column blocks:
    R_ij with the max(D, 1e-12) floor, then the row sums of R_ij (x_i - x_j)
    into dx_i and the column sums of R_ij (x_j - x_i) into dx_j. Coincident
    points contribute exactly 0 (their difference is 0), as in K5."""
    mp = x.shape[1]
    dx = torch.zeros_like(x)
    for s in range(0, mp, block):
        xc = x[:, s:s + block]
        diff = x[:, :, None, :] - xc[:, None, :, :]  # [B, Mp, blk, 3]
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))
        t = torch.sqrt(_sq_dists(tp, tp[s:s + block]))
        r = 2.0 * _weights(code[:, s:s + block], cg, cl) * (d - t) / torch.clamp_min(d, EPS)
        rd = r[..., None] * diff
        dx += rd.sum(dim=2)
        dx[:, s:s + block] -= rd.sum(dim=1)
    return dx


class _PairLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, code, cg, cl):
        ctx.save_for_backward(x, tp, code)
        ctx.coefs = (cg, cl)
        return desc_loss(x, tp, code, cg, cl)

    @staticmethod
    def backward(ctx, g):
        x, tp, code = ctx.saved_tensors
        dx = desc_grad(x, tp, code, *ctx.coefs) * g[:, None, None]
        return dx, None, None, None, None


def pair_loss(x: torch.Tensor, tp: torch.Tensor, code: torch.Tensor,
              cg: float, cl: float) -> torch.Tensor:
    """[B] per-ball loss with K5 as its backward (module doc). x [B, Mp, 3]."""
    return _PairLoss.apply(x.contiguous(), tp.contiguous(), code, float(cg), float(cl))

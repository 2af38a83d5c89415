"""Transformer MLP branch LN -> fc1 -> GELU -> fc2 as two CUDA kernels
(forward and backward), and their plain PyTorch versions.

Counterpart of ``basicsr4rs_tpu/ops/mlp_block.py``. ``fused_mlp_block`` is a
``torch.autograd.Function`` over ``mlp_block_forward``
(``csrc/mlp_block_fwd.cu``) and ``mlp_block_backward``
(``csrc/mlp_block_bwd.cu``). Each of the two sends a CUDA tensor to its
kernel and a CPU tensor to its plain version (``reference_mlp_block``,
``reference_mlp_block_backward``), and counts its launches in ``.launches``;
the forward as the operator ``basicsr4rs::mlp_block_fwd`` (``ops/library.py``).

Weights are in the ``nn.Linear`` (out, in) layout and are cast to x's dtype;
LayerNorm parameters and biases are used in float32. Three output modes:
the branch z alone, ``z + x`` (``add_residual``), or ``s[b] * z + x`` with a
per-sample scale (``residual_scale``, DropPath folded in).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _launch, library

LN_EPS = 1e-5
# both kernels: 8 n8 tiles of fc2's sums a warp (forward), 8 features a lane
# in the LayerNorm launch (backward)
MLP_MAX_CHANNELS = 256


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim in float32 with var = E[x^2] - mean^2,
    as the JAX package computes it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - mu.square()
    return (xf - mu) * torch.rsqrt(var + LN_EPS) * weight.float() + bias.float()


def fold_branch(x, z, add_residual: bool, residual_scale):
    """The float32 branch ``z`` as the output mode says, in x's dtype: z,
    z + x, or residual_scale[b] * z + x."""
    if residual_scale is not None:
        s = residual_scale.float().reshape(-1, *([1] * (x.dim() - 1)))
        z = z * s + x.float()
    elif add_residual:
        z = z + x.float()
    return z.to(x.dtype)


def reference_mlp_block(x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                        fc2_bias, add_residual: bool = False, residual_scale=None):
    """The plain PyTorch version of ``mlp_block_forward``:
    fc2(gelu(fc1(LN(x)))) for x (B, ..., C), same shape and dtype as x.
    GEMMs run in x's dtype with float32 results."""
    dt = x.dtype
    xn = layer_norm_f32(x, ln_weight, ln_bias)
    h = (xn.to(dt) @ fc1_weight.to(dt).t()).float() + fc1_bias.float()
    h = F.gelu(h)
    z = (h.to(dt) @ fc2_weight.to(dt).t()).float() + fc2_bias.float()
    return fold_branch(x, z, add_residual, residual_scale)


def reference_mlp_block_backward(x, dz, ln_weight, ln_bias, fc1_weight, fc1_bias,
                                 fc2_weight, add_residual: bool = False,
                                 residual_scale=None):
    """The plain PyTorch version of ``mlp_block_backward``: the same tuple,
    by autograd through ``reference_mlp_block``."""
    f32 = torch.float32
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_()] + [
            t.detach().to(f32).requires_grad_()
            for t in (ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight)]
        fc2_bias = torch.zeros(x.shape[-1], dtype=f32, device=x.device, requires_grad=True)
        out = reference_mlp_block(*leaves, fc2_bias, add_residual, residual_scale)
        return torch.autograd.grad(out, leaves + [fc2_bias], dz)


def mlp_block_forward(x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                      add_residual: bool = False, residual_scale=None):
    """The MLP branch of x (B, ..., C) in one kernel launch; no autograd.
    The op ``basicsr4rs::mlp_block_fwd``: its launches count in
    ``mlp_block_forward.launches``."""
    library.check_device(x, 'mlp_block_forward')
    return torch.ops.basicsr4rs.mlp_block_fwd.default(
        x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, bool(add_residual),
        residual_scale)


mlp_block_forward.launches = 0


def mlp_block_backward(x, dz, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                       add_residual: bool = False, residual_scale=None):
    """(dx, d ln_weight, d ln_bias, d fc1_weight, d fc1_bias, d fc2_weight,
    d fc2_bias) of the MLP branch in one kernel launch, from x and the
    cotangent dz of the output; dx in x's dtype, the rest float32."""
    args = (x, dz, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, add_residual,
            residual_scale)
    if x.device.type == 'cpu':
        return reference_mlp_block_backward(*args)
    if x.device.type != 'cuda':
        raise ValueError(f'mlp_block_backward: no kernel for device {x.device}')
    grads = _launch_backward(*args)
    mlp_block_backward.launches += 1
    return grads


mlp_block_backward.launches = 0


class _FusedMlpBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                add_residual, residual_scale):
        ctx.save_for_backward(x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                              fc2_bias, residual_scale)
        ctx.add_residual = add_residual
        return mlp_block_forward(x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                                 fc2_bias, add_residual, residual_scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        *params, fc2_bias, residual_scale = ctx.saved_tensors
        x = params[0]
        grads = mlp_block_backward(x, dz.to(x.dtype).contiguous(), *params[1:],
                                   ctx.add_residual, residual_scale)
        like = (*params, fc2_bias)
        return (*(_launch.grad_like(g, p) for g, p in zip(grads, like)), None, None)


def fused_mlp_block(x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                    add_residual: bool = False, residual_scale=None):
    """fc2(gelu(fc1(LN(x)))) for x (B, ..., C), differentiable; forward and
    backward are one kernel launch each on a CUDA tensor.

    ``add_residual`` returns ``x + branch``; ``residual_scale`` (B,) float32,
    DropPath's mask / keep per sample, returns ``x + s[b] * branch`` and gets
    no gradient. With gradients off it is ``mlp_block_forward`` itself, which
    ``torch.export`` keeps as one node."""
    args = (x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, add_residual,
            residual_scale)
    if not torch.is_grad_enabled():
        return mlp_block_forward(*args)
    return _FusedMlpBlock.apply(*args)


# ------------------------------------------------------------------ launches
@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == 'mlp_block_fwd':
        lib = _launch.bind(name, [i, p, p] + [i] * 4 + [p] * 6 + [i, p, i, p, p], [i, i])
        lib.mlp_block_fwd_plan.argtypes = [i] * 4 + [p]
        lib.mlp_block_fwd_plan.restype = ctypes.c_int
        return lib
    return _launch.bind(name, [i, p, p, p] + [i] * 4 + [p] * 5 + [i, p, p, p, p], [i, i],
                        [i, i])


def forward_plan(x, hidden: int):
    """The grid the forward kernel launches for x (B, ..., C) and ``hidden``
    columns on x's card: (units, parts, blocks an SM, SMs, floats of
    scratch); a unit is one thread block for a tile of 64 tokens and one of
    ``parts`` (1 or 2) runs of its hidden chunks; of two, the first to finish
    hands its sums to the other through the scratch."""
    return _forward_plan(x.device, x.dtype, x.numel() // x.shape[-1], x.shape[-1], hidden)


@functools.lru_cache(maxsize=None)
def _forward_plan(device, dtype, tokens, c, hidden):
    """forward_plan of a shape, kept: the launch asks for it every call. Its
    block's shared memory is checked against the device first."""
    op = 'mlp_block_fwd'
    lib = _lib(op)
    dt = _launch.DTYPES[dtype]
    _launch.check_shared_memory(lib.mlp_block_fwd_smem_bytes(dt, c), device, op)
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = lib.mlp_block_fwd_plan(dt, tokens, c, hidden, ctypes.addressof(plan))
    _launch.check_rc(rc, lib, op)
    return tuple(plan)


def _prepare(op, x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, residual_scale):
    """Checked kernel operands: (tokens, C, hidden, tokens per sample, [ln_weight,
    ln_bias, fc1_weight, fc1_bias, fc2_weight], scale or None)."""
    _launch.check_activation(x, 'x', op)
    if x.dim() < 2:
        raise ValueError(f'{op}: x must be (B, ..., C)')
    c, hidden = x.shape[-1], fc1_weight.shape[0]
    if c % 4 or hidden % 4:
        raise ValueError(f'{op}: needs C % 4 == 0 and hidden % 4 == 0 (C={c}, hidden={hidden})')
    if c > MLP_MAX_CHANNELS:
        raise ValueError(f'{op}: takes C <= {MLP_MAX_CHANNELS} (C={c})')
    dev, f32 = x.device, torch.float32
    ops = [_launch.operand(ln_weight, 'ln_weight', (c,), f32, dev),
           _launch.operand(ln_bias, 'ln_bias', (c,), f32, dev),
           _launch.operand(fc1_weight, 'fc1_weight', (hidden, c), x.dtype, dev),
           _launch.operand(fc1_bias, 'fc1_bias', (hidden,), f32, dev),
           _launch.operand(fc2_weight, 'fc2_weight', (c, hidden), x.dtype, dev)]
    tokens = x.numel() // c
    return (tokens, c, hidden, max(tokens // max(x.shape[0], 1), 1), ops,
            _launch.scale_operand(residual_scale, x))


def _launch_forward(x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                    add_residual, residual_scale):
    op = 'mlp_block_fwd'
    tokens, c, hidden, per_sample, ops, scale = _prepare(
        op, x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, residual_scale)
    ops.append(_launch.operand(fc2_bias, 'fc2_bias', (c,), torch.float32, x.device))
    lib = _lib(op)
    out = torch.empty_like(x)
    if tokens == 0:
        return out
    _, parts, _, _, floats = forward_plan(x, hidden)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
    rc = lib.mlp_block_fwd(
        _launch.DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), tokens, c, hidden, per_sample,
        *_launch.pointers(ops), _launch.mode_of(add_residual, residual_scale),
        *_launch.pointers([scale]), parts, *_launch.pointers([scratch]),
        _launch.current_stream(x.device))
    _launch.check_rc(rc, lib, op)
    return out


def _launch_backward(x, dz, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                     add_residual, residual_scale):
    op = 'mlp_block_bwd'
    tokens, c, hidden, per_sample, ops, scale = _prepare(
        op, x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, residual_scale)
    _launch.check_activation(dz, 'dz', op)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device:
        raise ValueError(f'{op}: dz must match x in shape, dtype and device')
    lib = _lib(op)
    dtype = _launch.DTYPES[x.dtype]
    _launch.check_shared_memory(lib.mlp_block_bwd_smem_bytes(dtype, c), x.device, op)
    dx = torch.empty_like(x)
    # one float32 buffer for every parameter gradient and one for dL/dLN(x)
    # summed over the hidden chunks; the op zeroes both on the stream
    grads = torch.empty(lib.mlp_block_bwd_grad_floats(c, hidden), dtype=torch.float32,
                        device=x.device)
    if tokens == 0:
        grads.zero_()
    else:
        scratch = torch.empty(x.numel(), dtype=torch.float32, device=x.device)
        rc = lib.mlp_block_bwd(
            dtype, x.data_ptr(), dz.data_ptr(), dx.data_ptr(), tokens, c, hidden, per_sample,
            *_launch.pointers(ops), _launch.mode_of(add_residual, residual_scale),
            *_launch.pointers([scale]), grads.data_ptr(), scratch.data_ptr(),
            _launch.current_stream(x.device))
        _launch.check_rc(rc, lib, op)
    dln_w, dln_b, dw1, db1, dw2, db2 = grads.split(
        [c, c, hidden * c, hidden, c * hidden, c])
    return dx, dln_w, dln_b, dw1.view(hidden, c), db1, dw2.view(c, hidden), db2


# ------------------------------------------------------------------- the op
# x is taken contiguous here: see the ops of ``ops.swin_block``
def _forward_cpu(x, *args):
    return reference_mlp_block(x.contiguous(), *args).contiguous()


def _forward_cuda(x, *args):
    out = _launch_forward(x.contiguous(), *args)
    mlp_block_forward.launches += 1
    return out


library.define('mlp_block_fwd',
               'Tensor x, Tensor ln_weight, Tensor ln_bias, Tensor fc1_weight, Tensor fc1_bias, '
               'Tensor fc2_weight, Tensor fc2_bias, bool add_residual, Tensor? residual_scale',
               _forward_cpu, _forward_cuda, library.like_x)

"""Windowed multi-head attention from packed q|k|v as CUDA kernels, and
their plain twins.

Counterpart of ``basicsr4rs_tpu/ops/window_attention.py``. For qkv
(B, H, W, 3C) and a float32 bias (nWb, heads, n, n) with n = window_size**2
and nWb 1 or the windows of one image,

    out[window, head] = softmax(scale * q k^T + bias) v          (B, H, W, C)

- ``window_attention_forward`` is one launch of
  ``csrc/window_attention_fwd.cu``: both products on the tensor cores, one
  thread block a (window position, head, group of samples), as the
  backward;
- ``window_attention_backward`` is one launch of
  ``csrc/window_attention_bwd.cu``: from qkv, bias and the output's
  cotangent it recomputes the probabilities and returns dqkv (qkv's dtype)
  and dbias (float32, summed over the samples, and over the windows when
  nWb == 1);
- ``fused_window_attention`` is the ``torch.autograd.Function`` over the two.

The qkv and proj GEMMs stay outside, with the caller. Every wrapper sends a
CUDA tensor to its kernel and a CPU tensor to its plain PyTorch version
(``reference_*``), and counts its launches in ``.launches``. The kernels
take windows of at most 96 tokens (window 9's 81 among them) and heads of at
most 64 channels, and raise beyond that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _launch

# both kernels pad a window to 16-token tiles: 4 of them up to 64 tokens, 6 up to 96
MAX_TOKENS_PER_WINDOW = 96
MAX_HEAD_DIM = 64


def reference_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                               window_size: int, num_heads: int,
                               scale: float) -> torch.Tensor:
    """Windowed MHA from packed q|k|v.

    Args:
      qkv: (B, H, W, 3C).
      bias: (nWb, heads, n, n) float32: relative-position bias (+ shift
        mask); nWb is 1 (broadcast over windows) or the windows per image.
      window_size, num_heads, scale: attention geometry.
    Returns: (B, H, W, C) in the dtype of ``qkv``.
    """
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ws, n = window_size, window_size * window_size
    hd = c // num_heads
    nwh, nww = h // ws, w // ws

    x = qkv.reshape(b, nwh, ws, nww, ws, c3).permute(0, 1, 3, 2, 4, 5)
    q, k, v = x.reshape(-1, n, 3, num_heads, hd).unbind(2)
    attn = torch.einsum('nqhc,nkhc->nhqk', (q * scale).float(), k.float())
    nwb = bias.shape[0]
    attn = attn.reshape(-1, nwb, num_heads, n, n) + bias[None]
    attn = torch.softmax(attn.reshape(-1, num_heads, n, n), dim=-1)
    out = torch.einsum('nhqk,nkhc->nqhc', attn.to(qkv.dtype), v)
    out = out.reshape(b, nwh, nww, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, h, w, c)


def reference_window_attention_backward(qkv, bias, dout, window_size: int, num_heads: int,
                                        scale: float):
    """The plain PyTorch version of ``window_attention_backward``: (dqkv,
    dbias) by autograd through ``reference_window_attention``."""
    with torch.enable_grad():
        qkv = qkv.detach().requires_grad_()
        bias = bias.detach().float().requires_grad_()
        out = reference_window_attention(qkv, bias, window_size, num_heads, scale)
        return torch.autograd.grad(out, (qkv, bias), dout)


def window_attention_forward(qkv, bias, window_size: int, num_heads: int, scale: float):
    """The attention of qkv (B, H, W, 3C) in one kernel launch; no autograd."""
    if qkv.device.type == 'cpu':
        return reference_window_attention(qkv, bias, window_size, num_heads, scale)
    if qkv.device.type != 'cuda':
        raise ValueError(f'window_attention_forward: no kernel for device {qkv.device}')
    out = _launch_forward(qkv, bias, window_size, num_heads, scale)
    window_attention_forward.launches += 1
    return out


window_attention_forward.launches = 0


def window_attention_backward(qkv, bias, dout, window_size: int, num_heads: int, scale: float):
    """(dqkv, dbias) of the attention in one kernel launch, from qkv, bias
    and the cotangent dout (B, H, W, C) of the output; dqkv in qkv's dtype,
    dbias float32 in bias's shape."""
    if qkv.device.type == 'cpu':
        return reference_window_attention_backward(qkv, bias, dout, window_size, num_heads,
                                                   scale)
    if qkv.device.type != 'cuda':
        raise ValueError(f'window_attention_backward: no kernel for device {qkv.device}')
    grads = _launch_backward(qkv, bias, dout, window_size, num_heads, scale)
    window_attention_backward.launches += 1
    return grads


window_attention_backward.launches = 0


class _FusedWindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, bias, window_size, num_heads, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.geometry = (window_size, num_heads, scale)
        return window_attention_forward(qkv, bias, window_size, num_heads, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = window_attention_backward(qkv, bias, dout.to(qkv.dtype).contiguous(),
                                                *ctx.geometry)
        return dqkv, dbias.to(bias.dtype), None, None, None


def fused_window_attention(qkv, bias, window_size: int, num_heads: int, scale: float):
    """Windowed multi-head attention of qkv (B, H, W, 3C), already rolled,
    differentiable in qkv and bias; forward and backward are one kernel
    launch each on a CUDA tensor.

    ``bias``: (nWb, heads, n, n) float32, the relative-position bias plus,
    when nWb is the windows of one image, the shift mask. Returns (B, H, W, C)
    in qkv's dtype."""
    return _FusedWindowAttention.apply(qkv, bias, window_size, num_heads, scale)


# ------------------------------------------------------------------ launches
@functools.lru_cache(maxsize=None)
def _checked_lib(op: str, dtype: torch.dtype, c: int, num_heads: int, window_size: int,
                 device: torch.device) -> ctypes.CDLL:
    """The kernel's library with its C functions' types set (the launch, the
    shared-memory query, dtype first, and the grid query), once its block's
    shared memory is known to fit the device for this geometry."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pointers = 3 if op == 'window_attention_fwd' else 5
    lib = _launch.bind(op, [i] + [p] * pointers + [i] * 7 + [f, p], [i, i, i, i])
    plan = getattr(lib, f'{op}_plan')
    plan.argtypes, plan.restype = [i] * 7 + [p], ctypes.c_int
    needed = getattr(lib, f'{op}_smem_bytes')(_launch.DTYPES[dtype], c, num_heads, window_size)
    _launch.check_shared_memory(needed, device, op)
    return lib


def _plan(op, qkv, window_size, num_heads):
    b, h, w, c3 = qkv.shape
    lib = _checked_lib(op, qkv.dtype, c3 // 3, num_heads, window_size, qkv.device)
    plan = (ctypes.c_int * 5)()
    rc = getattr(lib, f'{op}_plan')(_launch.DTYPES[qkv.dtype], b, h, w, c3 // 3, num_heads,
                                    window_size, ctypes.addressof(plan))
    _launch.check_rc(rc, lib, op)
    return tuple(plan)


def forward_plan(qkv, window_size: int, num_heads: int):
    """The grid the forward kernel launches for qkv (B, H, W, 3C) on its
    card: (units, samples a unit, blocks an SM, SMs, stages); a unit is one
    thread block for a (window position, head, group of samples), stages the
    samples' buffers it holds (2: the next one's copy overlaps the work).
    The kernel keeps the plan of each shape after its first launch."""
    return _plan('window_attention_fwd', qkv, window_size, num_heads)


def backward_plan(qkv, window_size: int, num_heads: int):
    """The same for the backward kernel."""
    return _plan('window_attention_bwd', qkv, window_size, num_heads)


def _operands(op, qkv, bias, window_size, num_heads):
    """Checked operands: the float32 bias, and (b, h, w, c)."""
    _launch.check_activation(qkv, 'qkv', op)
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f'{op}: qkv must be a (B, H, W, 3C) tensor')
    b, h, w, c3 = qkv.shape
    c, n = c3 // 3, window_size * window_size
    if h % window_size or w % window_size:
        raise ValueError(f'{op}: {h}x{w} is not a multiple of the window {window_size}')
    if n > MAX_TOKENS_PER_WINDOW:
        raise ValueError(f'{op}: window {window_size} has more than '
                         f'{MAX_TOKENS_PER_WINDOW} tokens')
    if c % num_heads or c // num_heads > MAX_HEAD_DIM:
        raise ValueError(f'{op}: needs C % heads == 0 and a head dim of at most '
                         f'{MAX_HEAD_DIM} (C={c}, heads={num_heads})')
    windows = (h // window_size) * (w // window_size)
    if bias.dim() != 4 or bias.shape[0] not in (1, windows):
        raise ValueError(f'{op}: bias must be (1 | {windows}, {num_heads}, {n}, {n}), got '
                         f'{tuple(bias.shape)}')
    bias = _launch.operand(bias, 'bias', (bias.shape[0], num_heads, n, n), torch.float32,
                           qkv.device)
    return bias, (b, h, w, c)


def _launch_forward(qkv, bias, window_size, num_heads, scale):
    op = 'window_attention_fwd'
    bias, (b, h, w, c) = _operands(op, qkv, bias, window_size, num_heads)
    lib = _checked_lib(op, qkv.dtype, c, num_heads, window_size, qkv.device)
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    rc = lib.window_attention_fwd(
        _launch.DTYPES[qkv.dtype], qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c,
        num_heads, window_size, bias.shape[0], float(scale), _launch.current_stream(qkv.device))
    _launch.check_rc(rc, lib, op)
    return out


def _launch_backward(qkv, bias, dout, window_size, num_heads, scale):
    op = 'window_attention_bwd'
    bias, (b, h, w, c) = _operands(op, qkv, bias, window_size, num_heads)
    _launch.check_activation(dout, 'dout', op)
    if dout.shape != (b, h, w, c) or dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise ValueError(f'{op}: dout must be {(b, h, w, c)} in qkv\'s dtype and on its device')
    lib = _checked_lib(op, qkv.dtype, c, num_heads, window_size, qkv.device)
    dqkv = torch.empty_like(qkv)
    # the op zeroes dbias on the stream before the launch
    dbias = torch.empty_like(bias)
    if qkv.numel() == 0:
        return dqkv, dbias.zero_()
    rc = lib.window_attention_bwd(
        _launch.DTYPES[qkv.dtype], qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), dbias.data_ptr(), b, h, w, c, num_heads, window_size, bias.shape[0],
        float(scale), _launch.current_stream(qkv.device))
    _launch.check_rc(rc, lib, op)
    return dqkv, dbias

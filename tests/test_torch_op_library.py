"""The port's forward kernels as operators of the namespace ``basicsr4rs``
(basicsr4rs_torch/ops/library.py): each op's schema, fake implementation and
registrations, checked by ``torch.library.opcheck`` on its CPU
implementation (the plain version); the CPU op gives the plain version's
bits; only the CPU and CUDA keys have a kernel, so no other device falls
back to anything; and the launch count moves in the CUDA implementation
alone. CPU only: the CUDA implementations are called here with their
launch replaced by a stand-in."""

import pytest
import torch

from basicsr4rs_torch.archs.swinir_arch import _shift_attn_mask
from basicsr4rs_torch.ops import conv3x3, library, mlp_block, swin_block

OPS = ('swin_block_joint_fwd', 'swin_attn_block_fwd', 'mlp_block_fwd', 'conv3x3_fwd')
C, HEADS, WS, HIDDEN = 24, 2, 8, 48


def _block(seed, shift, batch=2, size=16):
    """Operands of a Swin block at C=24 in heads of 12, window 8, on a 16x16
    map: (x, ln1 w, ln1 b, qkv w, qkv b, proj w, proj b, rel_bias, mask, ln2 w,
    ln2 b, fc1 w, fc1 b, fc2 w, fc2 b)."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=1.):
        return torch.randn(*shape, generator=g) * std

    n = WS * WS
    mask = _shift_attn_mask(size, size, WS, WS // 2, torch.device('cpu')) if shift else None
    return [r(batch, size, size, C), 1 + r(C, std=.1), r(C, std=.1), r(3 * C, C, std=C**-.5),
            r(3 * C, std=.02), r(C, C, std=C**-.5), r(C, std=.02), r(HEADS, n, n, std=.5), mask,
            1 + r(C, std=.1), r(C, std=.1), r(HIDDEN, C, std=C**-.5), r(HIDDEN, std=.02),
            r(C, HIDDEN, std=HIDDEN**-.5), r(C, std=.02)]


def _scales(seed, batch=2):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(batch, generator=g) < .5).float() * 1.25 for _ in range(2)]


GEOMETRY = (WS, HEADS, (C // HEADS)**-.5)
# (op, its arguments) at each output mode the callers use
JOINT_CASES = {
    'plain': lambda: _block(0, False) + [*GEOMETRY, None, None],
    'shifted': lambda: _block(1, True) + [*GEOMETRY, None, None],
    'scaled': lambda: _block(2, True) + [*GEOMETRY, *_scales(2)],
}
ATTN_CASES = {
    'branch': lambda: _block(3, False)[:9] + [*GEOMETRY, False, None],
    'residual': lambda: _block(4, True)[:9] + [*GEOMETRY, True, None],
    'scaled': lambda: _block(5, True)[:9] + [*GEOMETRY, False, _scales(5)[0]],
}


def _mlp(seed, add_residual, scaled):
    b = _block(seed, False)
    return [b[0], *b[9:15], add_residual, _scales(seed)[0] if scaled else None]


MLP_CASES = {
    'branch': lambda: _mlp(6, False, False),
    'residual': lambda: _mlp(7, True, False),
    'scaled': lambda: _mlp(8, False, True),
}


def _conv(seed, residual, act_slope, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 6, 9, 11, generator=g).to(dtype)
    return [x, torch.randn(10, 6, 3, 3, generator=g) / 8, torch.randn(10, generator=g),
            torch.randn(2, 10, 9, 11, generator=g).to(dtype) if residual else None, act_slope]


CONV_CASES = {
    'bias': lambda: _conv(9, False, None),
    'residual': lambda: _conv(10, True, None),
    'leaky_relu': lambda: _conv(11, False, 0.2),
    'bfloat16': lambda: _conv(12, True, 0.1, torch.bfloat16),
}
CASES = [(op, name, make) for op, cases in zip(OPS, (JOINT_CASES, ATTN_CASES, MLP_CASES,
                                                      CONV_CASES))
         for name, make in cases.items()]


def _op(name):
    return getattr(torch.ops.basicsr4rs, name).default


@pytest.mark.parametrize('op, case, make', CASES, ids=[f'{o}-{c}' for o, c, _ in CASES])
def test_opcheck(op, case, make):
    """Schema, fake implementation (shapes, dtypes and strides of the CPU
    result), registrations and an AOT-dispatch trace with dynamic shapes:
    ``torch.library.opcheck`` on the CPU implementation."""
    torch.library.opcheck(_op(op), tuple(make()))


PLAIN = {
    'swin_block_joint_fwd': lambda *a: swin_block.reference_swin_block_full(
        *a[:18], None if a[18] is None else (a[18], a[19])),
    'swin_attn_block_fwd': swin_block.reference_swin_attn_block,
    'mlp_block_fwd': mlp_block.reference_mlp_block,
    'conv3x3_fwd': conv3x3.reference_conv3x3,
}


@pytest.mark.parametrize('op, case, make', CASES, ids=[f'{o}-{c}' for o, c, _ in CASES])
def test_cpu_op_is_the_plain_version(op, case, make):
    """On the CPU the op gives its plain version's bits, also for an x
    handed over in another layout (taken contiguous inside the op); the
    K10 op's output is channels-last, as the kernel writes it."""
    args = make()
    want = PLAIN[op](*args)
    got = _op(op)(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if op == 'conv3x3_fwd':
        assert got.is_contiguous(memory_format=torch.channels_last)
        args[0] = args[0].contiguous(memory_format=torch.channels_last)
    else:
        assert got.is_contiguous()
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(_op(op)(*args), want)


@pytest.mark.parametrize('op', OPS)
def test_only_cpu_and_cuda_have_kernels(op):
    """A kernel for the CPU key (the plain version) and the CUDA key (the
    launch), none for another backend and no composite that would run
    anywhere; the fake implementation serves tracing (and the meta device,
    which the wrappers refuse before the op)."""
    qualname = f'basicsr4rs::{op}'
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualname, 'CPU') and has(qualname, 'CUDA')
    for key in ('XPU', 'MPS', 'HIP', 'PrivateUse1', 'CompositeImplicitAutograd',
                'CompositeExplicitAutograd'):
        assert not has(qualname, key), key


WRAPPERS = {   # op -> (module, its launch function, the wrapper counting its launches)
    'swin_block_joint_fwd': (swin_block, '_launch_joint', 'fused_swin_block_full',
                             swin_block._joint_cuda),
    'swin_attn_block_fwd': (swin_block, '_launch_attn_forward', 'swin_attn_block_forward',
                            swin_block._attn_cuda),
    'mlp_block_fwd': (mlp_block, '_launch_forward', 'mlp_block_forward',
                      mlp_block._forward_cuda),
    'conv3x3_fwd': (conv3x3, '_launch_forward', 'fused_conv3x3', conv3x3._forward_cuda),
}
FIRST_CASE = {'swin_block_joint_fwd': JOINT_CASES['scaled'],
              'swin_attn_block_fwd': ATTN_CASES['scaled'], 'mlp_block_fwd': MLP_CASES['scaled'],
              'conv3x3_fwd': CONV_CASES['residual']}


@pytest.mark.parametrize('op', OPS)
def test_cuda_implementation_counts_its_launch(monkeypatch, op):
    """The CUDA implementation hands its launch x contiguous (K10's launch
    takes any layout) and every other argument as the op got it, adds one to the wrapper's ``.launches``, and
    returns what the launch wrote; the CPU op launches nothing."""
    module, launch, counter, cuda_impl = WRAPPERS[op]
    args = FIRST_CASE[op]()
    args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    seen = []
    out = torch.zeros(1)
    monkeypatch.setattr(module, launch, lambda *a: seen.append(a) or out)
    wrapper = getattr(module, counter)
    before = wrapper.launches
    _op(op)(*args)
    assert wrapper.launches == before and not seen
    assert cuda_impl(*args) is out
    assert wrapper.launches == before + 1
    (got,) = seen
    if op == 'conv3x3_fwd':   # its launch lays x out channels-last itself
        assert got[0] is args[0]
    else:
        assert got[0].is_contiguous() and torch.equal(got[0], args[0])
    if op == 'swin_block_joint_fwd':      # the launch takes DropPath's scales as one pair
        got = got[:-1] + tuple(got[-1])
    for a, b in zip(got[1:], args[1:]):
        assert a is b


@pytest.mark.parametrize('op', OPS)
def test_wrappers_refuse_other_devices(op):
    """The public wrappers raise on a device with no kernel before the op,
    whose meta implementation would give a shape."""
    args = FIRST_CASE[op]()
    meta = [t.to('meta') if isinstance(t, torch.Tensor) else t for t in args]
    public = {'swin_block_joint_fwd': lambda *a: swin_block.swin_block_full_forward(
                  *a[:18], (a[18], a[19])),
              'swin_attn_block_fwd': swin_block.swin_attn_block_forward,
              'mlp_block_fwd': mlp_block.mlp_block_forward,
              'conv3x3_fwd': conv3x3.conv3x3_forward}[op]
    with pytest.raises(ValueError, match='no kernel for device'):
        public(*meta)
    assert _op(op)(*meta).device.type == 'meta'


def test_register_all_imports_the_op_modules_only():
    """``register_all`` imports the three modules that define the four ops."""
    library.register_all()
    assert library.OP_MODULES == ('swin_block', 'mlp_block', 'conv3x3')
    assert all(hasattr(torch.ops.basicsr4rs, op) for op in OPS)

"""The port's whole-Swin-block op (basicsr4rs_torch/ops/swin_block.py) against
the JAX package's: the Pallas kernel in interpret mode and its XLA
reference, on the same numpy inputs, in float32 on the CPU. On the CPU the
port runs its plain PyTorch version; the CUDA kernel itself is checked
against that version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.swinir_arch import _shift_attn_mask
from basicsr4rs_torch.ops import mlp_block as mlp_port
from basicsr4rs_torch.ops import swin_block as port
from basicsr4rs_tpu.ops import swin_block as ref

B, H, W, C, HEADS, HIDDEN = 2, 16, 16, 18, 3, 36   # head_dim 6: not a multiple of 8
SCALE = (C // HEADS)**-0.5


def _case(window_size, shifted, seed, C=C, HIDDEN=HIDDEN, heads=HEADS, B=B, wstd=0.2):
    """Inputs in the port's layout (nn.Linear (out, in) weights of std wstd,
    separate relative-position bias and shift mask), as numpy."""
    rng = np.random.RandomState(seed)
    n = window_size * window_size

    def r(*shape, std=wstd):
        return (rng.randn(*shape) * std).astype(np.float32)

    case = dict(x=r(B, H, W, C, std=1.), ln1_weight=1 + r(C, std=.1), ln1_bias=r(C, std=.1),
                qkv_weight=r(3 * C, C), qkv_bias=r(3 * C, std=.1), proj_weight=r(C, C),
                proj_bias=r(C, std=.1), rel_bias=r(heads, n, n, std=1.), mask=None,
                ln2_weight=1 + r(C, std=.1), ln2_bias=r(C, std=.1), fc1_weight=r(HIDDEN, C),
                fc1_bias=r(HIDDEN, std=.1), fc2_weight=r(C, HIDDEN), fc2_bias=r(C, std=.1))
    if shifted:
        case['mask'] = _shift_attn_mask(H, W, window_size, window_size // 2,
                                        torch.device('cpu')).numpy()
    return case


def _port_args(case):
    return [None if v is None else torch.from_numpy(v) for v in case.values()]


def _jax_args(case):
    """The same block in the JAX layout: (in, out) weights, one summed
    (nW | 1, heads, n, n) bias."""
    bias = case['rel_bias'][None]
    if case['mask'] is not None:
        bias = bias + case['mask'][:, None]
    return [jnp.asarray(v) for v in (
        case['x'], case['ln1_weight'], case['ln1_bias'], case['qkv_weight'].T, case['qkv_bias'],
        case['proj_weight'].T, case['proj_bias'], bias, case['ln2_weight'], case['ln2_bias'],
        case['fc1_weight'].T, case['fc1_bias'], case['fc2_weight'].T, case['fc2_bias'])]


def _jax_reference(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias, ln2s, ln2b, w1, b1, w2, b2,
                   window_size):
    from basicsr4rs_tpu.ops.mlp_block import reference_mlp_block
    y = x + ref.reference_swin_attn_block(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias,
                                          window_size, HEADS, SCALE)
    return y + reference_mlp_block(y, ln2s, ln2b, w1, b1, w2, b2)


@pytest.mark.parametrize('shifted', [False, True], ids=['no_shift', 'shift_mask'])
@pytest.mark.parametrize('window_size', [4, 8])
def test_block_matches_jax_kernel_and_reference(window_size, shifted):
    """K1's semantics: the port's block equals the Pallas kernel (interpret
    mode) and the XLA reference within the JAX package's own K1 tolerance
    (tests/test_ops/test_swin_block.py: atol 5e-5, rtol 1e-4); a CPU tensor
    never reaches the CUDA kernel."""
    case = _case(window_size, shifted, seed=window_size + 10 * shifted)
    launches = port.fused_swin_block_full.launches
    got = port.fused_swin_block_full(*_port_args(case), window_size, HEADS, SCALE).numpy()
    assert port.fused_swin_block_full.launches == launches

    jargs = _jax_args(case)
    kernel = ref.fused_swin_block_full(*jargs, window_size, HEADS, SCALE, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(_jax_reference(*jargs, window_size)),
                               atol=5e-5, rtol=1e-4)


def test_reference_is_the_plain_twin():
    """``reference_swin_block_full`` is what the wrapper runs on the CPU."""
    args = _port_args(_case(8, True, seed=3))
    np.testing.assert_array_equal(
        port.fused_swin_block_full(*args, 8, HEADS, SCALE).numpy(),
        port.reference_swin_block_full(*args, 8, HEADS, SCALE).numpy())


def test_cuda_entry_raises_without_a_device():
    """The CUDA entry point raises on a host without CUDA and never falls
    back to the plain version; other devices have no kernel at all."""
    args = _port_args(_case(8, False, seed=4, C=24, HIDDEN=48))  # shapes the kernel takes
    launches = port.fused_swin_block_full.launches
    with pytest.raises(RuntimeError):
        port._launch_joint(*args, 8, HEADS, SCALE)
    meta = [None if t is None else t.to('meta') for t in args]
    with pytest.raises(ValueError, match='no kernel for device'):
        port.fused_swin_block_full(*meta, 8, HEADS, SCALE)
    assert port.fused_swin_block_full.launches == launches


@pytest.mark.parametrize('change, error', [
    (dict(x_dtype=torch.float16), TypeError),
    (dict(window_size=3), ValueError),       # 16 is not a multiple of 3
    (dict(window_size=16), ValueError),      # 256 tokens per window
    (dict(transpose_x=True), ValueError),    # not contiguous
    (dict(channels=208, heads=8), ValueError),   # C > 192: proj's outputs stay in registers
    (dict(channels=96, heads=2), ValueError),    # heads of 48 features, padded to 32
])
def test_launch_rejects_what_the_kernel_does_not_take(change, error):
    """Shape, dtype and layout checks run before anything is built."""
    window_size = change.get('window_size', 8)
    c, heads = change.get('channels', 24), change.get('heads', HEADS)
    args = _port_args(_case(8, False, seed=5, C=c, HIDDEN=2 * c, heads=heads))
    if 'x_dtype' in change:
        args[0] = args[0].to(change['x_dtype'])
    if change.get('transpose_x'):
        args[0] = args[0].transpose(1, 2)
    with pytest.raises(error):
        port._launch_joint(*args, window_size, heads, SCALE)


def test_launch_takes_the_widest_block():
    """C = 192 in heads of 32 passes every check and goes on to build the
    kernel, which this host cannot: the error is the missing toolkit."""
    args = _port_args(_case(8, False, seed=5, C=192, HIDDEN=384, heads=6))
    with pytest.raises(RuntimeError, match='nvcc|CUDA'):
        port._launch_joint(*args, 8, 6, 32**-.5)


def bound_types(monkeypatch, module, name):
    """The ctypes types ``module._lib`` gives ``name``, ``<name>_smem_bytes``
    and, where the kernel has one, its grid query ``<name>_plan``, with the
    library's load replaced by a stand-in (no kernel is built), and the C
    parameters of those in ``csrc/<name>.cu``."""
    import ctypes
    import re
    import types
    from basicsr4rs_torch.ops import _build, _launch
    from test_torch_conv3x3 import c_signature
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in (
        name, f'{name}_error', f'{name}_smem_bytes', f'{name}_grad_floats', f'{name}_plan')})
    monkeypatch.setattr(_launch, 'load_library', lambda _: fake)
    module._lib.cache_clear()
    try:
        module._lib(name)
    finally:
        module._lib.cache_clear()
    source = (_build.CSRC_DIR / f'{name}.cu').read_text()
    smem = re.search(rf'\bsize_t {name}_smem_bytes\(([^)]*)\)', source).group(1)
    assert all(p.split()[0] == 'int' for p in smem.split(','))
    plan = re.search(rf'\bint {name}_plan\(([^)]*)\)', source)
    declared_plan = [ctypes.c_void_p if '*' in p else ctypes.c_int
                     for p in plan.group(1).split(',')] if plan else None
    return ((list(getattr(fake, name).argtypes), list(getattr(fake, f'{name}_smem_bytes').argtypes),
             getattr(getattr(fake, f'{name}_plan'), 'argtypes', None)),
            (c_signature(name), [ctypes.c_int] * len(smem.split(',')), declared_plan))


@pytest.mark.parametrize('name', ['swin_block_joint_fwd', 'swin_attn_block_fwd',
                                  'swin_attn_block_bwd', 'mlp_block_fwd', 'mlp_block_bwd'])
def test_binding_matches_the_c_signature(monkeypatch, name):
    """The wrapper's ctypes types are the kernel's C parameters, one for
    one, for the launch, its shared-memory query and (K4) its grid query: a
    count that differs passes a pointer as an int or fails at the first
    launch on the card."""
    bound, declared = bound_types(monkeypatch, mlp_port if name.startswith('mlp') else port, name)
    assert bound == declared


# ------------------------------------------------- the attention branch (training)
ATTN_NAMES = ('x', 'ln1_weight', 'ln1_bias', 'qkv_weight', 'qkv_bias', 'proj_weight', 'proj_bias',
              'rel_bias')
ATTN_MODES = ['branch', 'residual', 'scaled']


def _attn_mode_kwargs(mode, lib, batch=B):
    if mode == 'scaled':   # DropPath's mask / keep: the first sample dropped (unless alone)
        return dict(residual_scale=lib(np.array([0., 1.25][-batch:], np.float32)))
    return dict(add_residual=mode == 'residual')


def _port_attn_run(case, dz, window_size, mode, heads=HEADS):
    args = [torch.from_numpy(case[k]).requires_grad_() for k in ATTN_NAMES]
    mask = None if case['mask'] is None else torch.from_numpy(case['mask'])
    scale = (case['x'].shape[-1] // heads)**-0.5
    out = port.fused_swin_attn_block(*args, mask, window_size, heads, scale,
                                     **_attn_mode_kwargs(mode, torch.from_numpy, len(dz)))
    out.backward(torch.from_numpy(dz))
    return out.detach().numpy(), [a.grad.numpy() for a in args]


def _jax_attn_run(case, dz, window_size, mode, fn, heads=HEADS):
    """Output and gradients of a JAX attention-branch function in the port's
    layout: weights transposed back, the gradient of the summed (nW | 1,
    heads, n, n) bias summed over its windows into d rel_bias."""
    args = [jnp.asarray(case[k].T if k.endswith('_weight') and case[k].ndim == 2 else case[k])
            for k in ATTN_NAMES[:-1]]
    mask = case['mask']
    scale = (case['x'].shape[-1] // heads)**-0.5

    def f(*a):
        *params, rel_bias = a
        bias = rel_bias[None] if mask is None else rel_bias[None] + jnp.asarray(mask)[:, None]
        return fn(*params, bias, window_size, heads, scale,
                  **_attn_mode_kwargs(mode, jnp.asarray, len(dz)))

    out, vjp = jax.vjp(f, *args, jnp.asarray(case['rel_bias']))
    grads = [np.asarray(g) for g in vjp(jnp.asarray(dz))]
    return np.asarray(out), [g.T if k.endswith('_weight') and g.ndim == 2 else g
                             for k, g in zip(ATTN_NAMES, grads)]


def _jax_attn_reference(x, *params_and_geometry, add_residual=False, residual_scale=None):
    z = ref.reference_swin_attn_block(x, *params_and_geometry)
    if residual_scale is not None:
        return x + z * residual_scale[:, None, None, None]
    return x + z if add_residual else z


# (window, shifted, mode, widths): SwinIR-M-like blocks at B=2 (C=18 in 3
# heads of 6), and SwinIR's eval blocks past the joint kernel's widths at B=1
# (C=240 in 8 heads of 30, SwinIR-L's; C=180 in 3 heads of 60)
WIDE = {'C240-8heads': (240, 8), 'C180-3heads': (180, 3)}
ATTN_CASES = [pytest.param(ws, shifted, mode, None, id=f'{ws}-{tag}-{mode}')
              for mode in ATTN_MODES for shifted, tag in ((False, 'no_shift'), (True, 'shift_mask'))
              for ws in (4, 8)]
ATTN_CASES += [pytest.param(8, True, mode, wide, id=f'8-shift_mask-{mode}-{wide}')
               for wide in WIDE for mode in ('residual', 'scaled')]


@pytest.mark.parametrize('window_size, shifted, mode, wide', ATTN_CASES)
def test_attn_block_matches_jax_kernels_and_reference(window_size, shifted, mode, wide):
    """K2 and K3's semantics: forward and all eight gradients of
    ``fused_swin_attn_block`` in the three output modes against the Pallas
    kernels (interpret mode) and the XLA reference, also at the widths the
    eval route sends to K2 past the joint kernel's (B=1 16x16). Tolerance:
    the JAX package's own for its kernels against its reference
    (tests/test_ops/test_swin_block.py: forward atol 5e-5, rtol 1e-4;
    gradients atol 2e-4, rtol 1e-3), float32 sums in another order. The
    wide blocks' weights keep the std a fan-in of C=18 gives 0.2 (0.2 (18 /
    C)^0.5, as an nn.Linear's init scales), so that their activations stay
    in the range the tolerance was set for."""
    c, heads = WIDE[wide] if wide else (C, HEADS)
    batch = 1 if wide else B
    case = _case(window_size, shifted, seed=20 + window_size + shifted, C=c, HIDDEN=2 * c,
                 heads=heads, B=batch, wstd=0.2 * (C / c)**0.5)
    dz = np.random.RandomState(3).randn(batch, H, W, c).astype(np.float32)
    launches = (port.swin_attn_block_forward.launches, port.swin_attn_block_backward.launches)
    out, grads = _port_attn_run(case, dz, window_size, mode, heads)
    assert (port.swin_attn_block_forward.launches,
            port.swin_attn_block_backward.launches) == launches
    for fn in (lambda *a, **k: ref.fused_swin_attn_block(*a, interpret=True, **k),
               _jax_attn_reference):
        want, want_grads = _jax_attn_run(case, dz, window_size, mode, fn, heads)
        np.testing.assert_allclose(out, want, atol=5e-5, rtol=1e-4)
        for name, g, w in zip(ATTN_NAMES, grads, want_grads):
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3, err_msg=f'd {name}')


def test_attn_block_dropped_sample_passes_through():
    """A sample whose DropPath scale is 0 gives out == x and dx == dz exactly."""
    case = _case(8, True, seed=31)
    dz = np.random.RandomState(4).randn(B, H, W, C).astype(np.float32)
    out, grads = _port_attn_run(case, dz, 8, 'scaled')
    np.testing.assert_array_equal(out[0], case['x'][0])
    np.testing.assert_array_equal(grads[0][0], dz[0])
    assert np.abs(out[1] - case['x'][1]).max() > 0


def test_attn_backward_wrapper_returns_the_kernel_tuple():
    """``swin_attn_block_backward`` on the CPU is the plain version: eight
    gradients in the parameters' shapes, float32; d rel_bias sums over every
    window and sample, and a non-contiguous cotangent is accepted by the
    autograd function."""
    case = _case(4, True, seed=32)
    args = [torch.from_numpy(case[k]) for k in ATTN_NAMES]
    mask = torch.from_numpy(case['mask'])
    dz = torch.from_numpy(np.random.RandomState(5).randn(B, W, H, C).astype(np.float32))
    grads = port.swin_attn_block_backward(args[0], dz.transpose(1, 2).contiguous(), *args[1:6],
                                          args[7], mask, 4, HEADS, SCALE, add_residual=True)
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in args]
    assert all(g.dtype == torch.float32 for g in grads)
    leaves = [a.clone().requires_grad_() for a in args]
    out = port.fused_swin_attn_block(*leaves, mask, 4, HEADS, SCALE, add_residual=True)
    out.backward(dz.transpose(1, 2))   # not contiguous
    for g, leaf in zip(grads, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-6, rtol=1e-6)


def test_attn_backward_launch_takes_heads_wider_than_the_joint_kernel():
    """The attention backward takes every shape its first route held in
    shared memory, heads of 48 features (C = 96, 2 heads) among them, which
    the joint kernel refuses: no check of the joint kernel's widths reaches
    it, and it goes on to build the kernel, which this host cannot."""
    case = _case(8, True, seed=34, C=96, HIDDEN=192, heads=2)
    args = [torch.from_numpy(case[k]) for k in ATTN_NAMES]
    with pytest.raises(ValueError, match='head dim'):
        port._launch_joint(*_port_args(case), 8, 2, 48**-.5)
    with pytest.raises(RuntimeError, match='nvcc|CUDA'):
        port._launch_attn_backward(args[0], torch.zeros_like(args[0]), *args[1:6], args[7],
                                   torch.from_numpy(case['mask']), 8, 2, 48**-.5, False, None)


@pytest.mark.parametrize('entry', ['_launch_attn_forward', '_launch_attn_backward'])
def test_attn_cuda_entries_raise_without_a_device(entry):
    """Operand checks first, then the build, which raises on a host without
    the CUDA toolkit; nothing falls back to the plain version."""
    case = _case(8, False, seed=33, C=24, HIDDEN=48)
    args = [torch.from_numpy(case[k]) for k in ATTN_NAMES]
    tail = [None, 8, HEADS, SCALE, False, None]
    if entry == '_launch_attn_backward':
        args = [args[0], torch.zeros_like(args[0])] + args[1:6] + [args[7]]
    with pytest.raises(ValueError, match='contiguous'):
        getattr(port, entry)(args[0].transpose(1, 2), *args[1:], *tail)
    with pytest.raises(TypeError):
        getattr(port, entry)(args[0].half(), *args[1:], *tail)
    with pytest.raises(RuntimeError):
        getattr(port, entry)(*args, *tail)
    public = (port.swin_attn_block_forward if entry == '_launch_attn_forward'
              else port.swin_attn_block_backward)
    with pytest.raises(ValueError, match='no kernel for device'):
        public(*[t.to('meta') for t in args], *tail)

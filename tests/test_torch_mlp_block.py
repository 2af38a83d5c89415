"""The port's MLP-branch op (basicsr4rs_torch/ops/mlp_block.py), forward and
every gradient, against the JAX package's: the Pallas kernels in interpret
mode and the XLA reference, on the same numpy inputs, in float32 on the CPU.
On the CPU the port's kernel wrappers run their plain PyTorch versions
through the same ``torch.autograd.Function`` that launches the CUDA kernels
on a card; the kernels themselves are checked against those plain versions
on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.ops import mlp_block as port
from basicsr4rs_tpu.ops import mlp_block as ref

B, H, W, C, HIDDEN = 2, 8, 12, 24, 48
NAMES = ('x', 'ln_weight', 'ln_bias', 'fc1_weight', 'fc1_bias', 'fc2_weight', 'fc2_bias')
MODES = ['branch', 'residual', 'scaled']


def _case(seed):
    rng = np.random.RandomState(seed)

    def r(*shape, std=0.2):
        return (rng.randn(*shape) * std).astype(np.float32)

    case = dict(x=r(B, H, W, C, std=1.), ln_weight=1 + r(C, std=.1), ln_bias=r(C, std=.1),
                fc1_weight=r(HIDDEN, C), fc1_bias=r(HIDDEN, std=.1), fc2_weight=r(C, HIDDEN),
                fc2_bias=r(C, std=.1))
    return case, r(B, H, W, C, std=1.), np.array([0., 1.25], np.float32)   # dz, DropPath scale


def _mode_kwargs(mode, scale, lib):
    if mode == 'scaled':
        s = lib(scale)
        return dict(residual_scale=s if lib is torch.from_numpy else s[:, None, None])
    return dict(add_residual=mode == 'residual')


def _port_run(case, dz, mode, scale):
    args = [torch.from_numpy(case[k]).requires_grad_() for k in NAMES]
    out = port.fused_mlp_block(*args, **_mode_kwargs(mode, scale, torch.from_numpy))
    out.backward(torch.from_numpy(dz))
    return out.detach().numpy(), [a.grad.numpy() for a in args]


def _jax_run(case, dz, mode, scale, fn):
    """Output and gradients of a JAX MLP function in the port's layout."""
    args = [jnp.asarray(case[k].T if k.endswith('_weight') and case[k].ndim == 2 else case[k])
            for k in NAMES]

    def f(*a):
        return fn(*a, **_mode_kwargs(mode, scale, jnp.asarray))

    out, vjp = jax.vjp(f, *args)
    grads = [np.asarray(g) for g in vjp(jnp.asarray(dz))]
    return np.asarray(out), [g.T if k.endswith('_weight') and g.ndim == 2 else g
                             for k, g in zip(NAMES, grads)]


@pytest.mark.parametrize('mode', MODES)
def test_mlp_block_matches_jax_kernels_and_reference(mode):
    """Forward and all seven gradients in the three output modes. Tolerance:
    the JAX package's own for these kernels against their reference
    (tests/test_ops/test_mlp_block.py: atol 2e-4, rtol 1e-3 on gradients,
    float32 sums in another order; the Pallas kernel's rational erf differs
    from erf by 1.5e-7)."""
    case, dz, scale = _case(MODES.index(mode))
    out, grads = _port_run(case, dz, mode, scale)
    for fn in (lambda *a, **k: ref.fused_mlp_block(*a, interpret=True, **k), _jax_reference):
        want, want_grads = _jax_run(case, dz, mode, scale, fn)
        np.testing.assert_allclose(out, want, atol=5e-5, rtol=1e-4)
        for name, g, w in zip(NAMES, grads, want_grads):
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3, err_msg=f'd {name}')


def _jax_reference(x, *params, add_residual=False, residual_scale=None):
    z = ref.reference_mlp_block(x, *params)
    if residual_scale is not None:
        return x + z * residual_scale[..., None]
    return x + z if add_residual else z


def test_dropped_sample_passes_through():
    """A sample whose DropPath scale is 0 gives out == x and dx == dz exactly."""
    case, dz, scale = _case(7)
    out, grads = _port_run(case, dz, 'scaled', scale)
    np.testing.assert_array_equal(out[0], case['x'][0])
    np.testing.assert_array_equal(grads[0][0], dz[0])
    assert np.abs(out[1] - case['x'][1]).max() > 0


def test_backward_wrapper_returns_the_kernel_tuple():
    """``mlp_block_backward`` on the CPU is the plain version: seven
    gradients, dx in x's dtype, the rest float32 in the parameters' shapes;
    nothing is launched."""
    case, dz, scale = _case(8)
    args = [torch.from_numpy(case[k]) for k in NAMES]
    launches = (port.mlp_block_forward.launches, port.mlp_block_backward.launches)
    grads = port.mlp_block_backward(args[0], torch.from_numpy(dz), *args[1:6],
                                    residual_scale=torch.from_numpy(scale))
    assert (port.mlp_block_forward.launches, port.mlp_block_backward.launches) == launches
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in args]
    assert all(g.dtype == torch.float32 for g in grads)
    _, want = _port_run(case, dz, 'scaled', scale)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-6)


def test_bfloat16_forward_keeps_dtype_and_tracks_float32():
    """bfloat16 activations: GEMM inputs rounded to bfloat16, float32 sums;
    the result stays within 3e-2 of the float32 one relative to its largest
    entry (bfloat16 has 8 bits of mantissa)."""
    case, _, _ = _case(9)
    args = [torch.from_numpy(case[k]) for k in NAMES]
    want = port.fused_mlp_block(*args, add_residual=True)
    got = port.fused_mlp_block(args[0].bfloat16(), *args[1:], add_residual=True)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= 3e-2 * want.abs().max()


@pytest.mark.parametrize('entry', ['_launch_forward', '_launch_backward'])
def test_cuda_entries_raise_without_a_device(entry):
    """The CUDA entry points check their operands, then build the kernel:
    on a host without the CUDA toolkit that raises, and nothing falls back
    to the plain version."""
    case, dz, _ = _case(10)
    args = [torch.from_numpy(case[k]) for k in NAMES]
    if entry == '_launch_backward':
        args = [args[0], torch.from_numpy(dz)] + args[1:6]
    with pytest.raises(ValueError, match='contiguous'):
        getattr(port, entry)(args[0].transpose(1, 2), *args[1:], False, None)
    with pytest.raises(TypeError):
        getattr(port, entry)(args[0].half(), *args[1:], False, None)
    with pytest.raises(RuntimeError):
        getattr(port, entry)(*args, False, None)
    meta = [t.to('meta') for t in args]
    public = port.mlp_block_forward if entry == '_launch_forward' else port.mlp_block_backward
    with pytest.raises(ValueError, match='no kernel for device'):
        public(*meta)


@pytest.mark.parametrize('c, hidden, error, match', [
    (60, 120, RuntimeError, 'nvcc|CUDA'),    # SwinIR-light: hidden chunks of 96 and 24
    (180, 360, RuntimeError, 'nvcc|CUDA'),   # SwinIR-M: chunks of 96, 96, 96 and 72
    (260, 520, ValueError, 'C <= 256'),      # past the LayerNorm launch's 8 features a lane
])
def test_backward_launch_checks_widths(c, hidden, error, match):
    """The backward kernel takes SwinIR-light's and SwinIR-M's widths and a
    hidden that is no multiple of its chunk: every operand check passes and
    the launch goes on to build the kernel, which this host cannot. A C
    past 256 is refused before the build."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(1, 3, 5, c).astype(np.float32))   # 15 tokens: a ragged tile
    params = [torch.ones(c), torch.zeros(c), torch.zeros(hidden, c), torch.zeros(hidden),
              torch.zeros(c, hidden)]
    with pytest.raises(error, match=match):
        port._launch_backward(x, torch.zeros_like(x), *params, False, None)

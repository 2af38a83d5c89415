"""The port's whole-Swin-block op (basicsr4rs_torch/ops/swin_block.py) against
the JAX package's: the Pallas kernel in interpret mode and its XLA
reference, on the same numpy inputs, in float32 on the CPU. On the CPU the
port runs its plain PyTorch version; the CUDA kernel itself is checked
against that version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.swinir_arch import _shift_attn_mask
from basicsr4rs_torch.ops import swin_block as port
from basicsr4rs_tpu.ops import swin_block as ref

B, H, W, C, HEADS, HIDDEN = 2, 16, 16, 18, 3, 36   # head_dim 6: not a multiple of 8
SCALE = (C // HEADS)**-0.5


def _case(window_size, shifted, seed, C=C, HIDDEN=HIDDEN):
    """Inputs in the port's layout (nn.Linear (out, in) weights, separate
    relative-position bias and shift mask), as numpy."""
    rng = np.random.RandomState(seed)
    n = window_size * window_size

    def r(*shape, std=0.2):
        return (rng.randn(*shape) * std).astype(np.float32)

    case = dict(x=r(B, H, W, C, std=1.), ln1_weight=1 + r(C, std=.1), ln1_bias=r(C, std=.1),
                qkv_weight=r(3 * C, C), qkv_bias=r(3 * C, std=.1), proj_weight=r(C, C),
                proj_bias=r(C, std=.1), rel_bias=r(HEADS, n, n, std=1.), mask=None,
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
        port._launch(*args, 8, HEADS, SCALE)
    meta = [None if t is None else t.to('meta') for t in args]
    with pytest.raises(ValueError, match='no kernel for device'):
        port.fused_swin_block_full(*meta, 8, HEADS, SCALE)
    assert port.fused_swin_block_full.launches == launches


@pytest.mark.parametrize('change, error', [
    (dict(x_dtype=torch.float16), TypeError),
    (dict(window_size=3), ValueError),       # 16 is not a multiple of 3
    (dict(window_size=16), ValueError),      # 256 tokens per window
    (dict(transpose_x=True), ValueError),    # not contiguous
])
def test_launch_rejects_what_the_kernel_does_not_take(change, error):
    """Shape, dtype and layout checks run before anything is built."""
    window_size = change.get('window_size', 8)
    args = _port_args(_case(8, False, seed=5, C=24, HIDDEN=48))
    if 'x_dtype' in change:
        args[0] = args[0].to(change['x_dtype'])
    if change.get('transpose_x'):
        args[0] = args[0].transpose(1, 2)
    with pytest.raises(error):
        port._launch(*args, window_size, HEADS, SCALE)

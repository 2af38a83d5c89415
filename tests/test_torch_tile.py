"""The port's batched tiled inference (basicsr4rs_torch/ops/tile.py) and the
SwinIR inference script against the JAX package's ``tiled_apply``: the three
cases of tests/test_ops/test_tile.py, the same functions fed NCHW here and
NHWC there."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.archs.swinir_arch import SwinIR
from basicsr4rs_torch.inference import inference_swinir
from basicsr4rs_torch.models.swinir_model import pad_to_multiple
from basicsr4rs_torch.ops.tile import tiled_apply
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs.srresnet_arch import MSRResNet as JaxMSRResNet
from basicsr4rs_tpu.archs.swinir_arch import SwinIR as JaxSwinIR
from basicsr4rs_tpu.ops.tile import tiled_apply as jax_tiled_apply


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def test_tiled_apply_exact_for_cnn():
    """MSRResNet (one block: receptive field 2 + 2 + 2 + ... < 12) tiled 10 +
    2 x 12 on 37x45: equal to the untiled forward (atol 2e-5, rtol 1e-5, the
    JAX test's) and to the JAX package's tiled output on the same weights."""
    opt = dict(num_in_ch=3, num_out_ch=3, num_feat=8, num_block=1, upscale=4)
    jnet = JaxMSRResNet(**opt)
    x = np.random.RandomState(0).rand(2, 3, 37, 45).astype(np.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))['params'])
    jfn = jax.jit(lambda v: jnet.apply({'params': params}, v))
    net = MSRResNet(**opt).eval()
    net.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.array, params), MSRResNet.JAX_KEY_RULES), strict=True)
    batches = []

    def fn(v):
        batches.append(tuple(v.shape))
        with torch.no_grad():
            return net(v)

    want = fn(torch.from_numpy(x)).numpy()
    got = tiled_apply(fn, torch.from_numpy(x), scale=4, tile_size=10, tile_pad=12).numpy()
    assert got.shape == want.shape == (2, 3, 148, 180)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert batches[1] == (2 * 4 * 5, 3, 34, 34)            # all 20 tiles in one batch
    jgot = _nchw(jax_tiled_apply(jfn, _nhwc(x), scale=4, tile_size=10, tile_pad=12))
    np.testing.assert_allclose(got, jgot, atol=2e-5, rtol=1e-5)


def test_tiled_apply_identity():
    """A pointwise x2 upsample: tiling is exact, and the port's stitching
    equals the JAX package's; an input smaller than one padded tile goes
    through whole."""
    x = np.random.RandomState(1).rand(1, 2, 20, 26).astype(np.float32)
    fn = lambda v: v.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # noqa: E731
    jfn = lambda v: jnp.repeat(jnp.repeat(v, 2, axis=1), 2, axis=2)  # noqa: E731
    got = tiled_apply(fn, torch.from_numpy(x), scale=2, tile_size=4, tile_pad=2).numpy()
    np.testing.assert_allclose(got, fn(torch.from_numpy(x)).numpy(), atol=1e-6)
    np.testing.assert_array_equal(
        got, _nchw(jax_tiled_apply(jfn, _nhwc(x), scale=2, tile_size=4, tile_pad=2)))
    seen = []
    tiled_apply(lambda v: seen.append(v.shape) or fn(v), torch.from_numpy(x), 2, 16, 2)
    assert seen == [x.shape]


def _swinir_pair():
    opt = dict(upscale=4, in_chans=3, img_size=16, window_size=8, img_range=1., depths=[2],
               embed_dim=16, num_heads=[2], mlp_ratio=2, upsampler='pixelshuffledirect')
    jnet = JaxSwinIR(**opt)
    params = jax.device_get(
        jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))['params'])
    net = SwinIR(**opt).eval()
    net.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.array, params), SwinIR.JAX_KEY_RULES), strict=True)
    return jnet, params, net


def test_tiled_apply_swinir_receptive_field():
    """Window-attention tiling: with ``tile_pad`` covering the receptive
    field of this 2-block net the tiled output equals the untiled one (1e-5:
    the batch of tiles sums in another order than the whole image), a smaller
    halo is approximate (0 < err < 0.05, the JAX test's bound), and both
    equal the JAX package's tiled outputs to 1e-4."""
    jnet, params, net = _swinir_pair()
    x = np.random.RandomState(2).rand(1, 3, 37, 53).astype(np.float32)
    xp = pad_to_multiple(torch.from_numpy(x), 8)
    assert xp.shape == (1, 3, 40, 56)

    def fn(v):
        with torch.no_grad():
            return net(v)

    jfn = jax.jit(lambda v: jnet.apply({'params': params}, v))
    want = fn(xp).numpy()
    exact = tiled_apply(fn, xp, 4, 16, tile_pad=16)
    # 48 >= 40: the plan does not tile this height, so the whole image runs
    np.testing.assert_allclose(exact.numpy(), want, atol=1e-5)
    approx = tiled_apply(fn, xp, 4, 8, tile_pad=8).numpy()
    assert 0 < np.abs(want - approx).max() < 0.05
    japprox = _nchw(jax_tiled_apply(jfn, _nhwc(xp.numpy()), 4, 8, tile_pad=8))
    np.testing.assert_allclose(approx, japprox, atol=1e-4, rtol=1e-4)
    # inside every tile's core, away from what another tile would have seen,
    # a tile with the full receptive field as halo equals the untiled forward
    wide = tiled_apply(fn, pad_to_multiple(torch.from_numpy(
        np.random.RandomState(3).rand(1, 3, 72, 72).astype(np.float32)), 8), 4, 8, tile_pad=16)
    assert wide.shape == (1, 3, 288, 288)


@pytest.mark.parametrize('tile', [0, 12])
def test_inference_script_on_a_tiny_image(tmp_path, tile):
    """``inference_swinir`` end to end on the CPU: reads a 21x30 PNG, pads to
    the window, runs (tiled: tile 12 -> 16, pad 4 -> 8, rounded up to the
    window) and writes the x2 PNG; untiled equals the network's own forward
    to one uint8 level; with no card and no ``--device cpu`` it raises."""
    torch.manual_seed(0)
    net = SwinIR(**dict(inference_swinir.TASKS['lightweight_sr'], upscale=2))
    weights = str(tmp_path / 'net.pth')
    torch.save({'params_ema': net.state_dict()}, weights)
    (tmp_path / 'lq').mkdir()
    img = (np.random.RandomState(4).rand(21, 30, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / 'lq' / 'tiny.png'), img)
    argv = ['--model_path', weights, '--task', 'lightweight_sr', '--scale', '2', '--input',
            str(tmp_path / 'lq'), '--output', str(tmp_path / 'out'), '--tile', str(tile),
            '--tile_pad', '4']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            inference_swinir.main(argv)
    inference_swinir.main(argv + ['--device', 'cpu'])
    out = cv2.imread(str(tmp_path / 'out' / 'tiny_SwinIR.png'))
    assert out is not None and out.shape == (42, 60, 3)
    x = torch.from_numpy(img[..., ::-1].astype(np.float32).transpose(2, 0, 1) / 255.)[None]
    with torch.no_grad():
        want = net.eval()(pad_to_multiple(x, 8))[0, :, :42, :60].clamp(0, 1)
    want = (want.permute(1, 2, 0).numpy()[..., ::-1] * 255).round()
    limit = 1 if tile == 0 else 40      # a tile sees 8 pixels of halo, not the image
    assert np.abs(out.astype(np.float32) - want).max() <= limit
    assert inference_swinir.round_up(12, 8) == 16 and inference_swinir.round_up(16, 8) == 16

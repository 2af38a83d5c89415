"""The port's serving path, ``python -m basicsr4rs_torch.test``, against the
JAX package's ``basicsr4rs_tpu.test`` on the SwinIR-M x4 synthetic config,
with one shared ``.pth`` and the same images, on the CPU; plus the pieces
it is built from: options, image conversion, metrics and checkpoint
loading."""

import sys
from os import path as osp

import cv2
import numpy as np
import pytest
import torch

import basicsr4rs_torch.test as port_test
import basicsr4rs_tpu.test as jax_test
from basicsr4rs_torch.archs.swinir_arch import SwinIR
from basicsr4rs_torch.metrics import psnr_ssim as port_metrics
from basicsr4rs_torch.models.base_model import BaseModel
from basicsr4rs_torch.utils import img_util as port_img
from basicsr4rs_torch.utils import options as port_options
from basicsr4rs_tpu.metrics import psnr_ssim as jax_metrics
from basicsr4rs_tpu.utils import img_util as jax_img
from basicsr4rs_tpu.utils import options as jax_options

CONFIG = osp.join(osp.dirname(__file__), '..', 'options', 'test', 'SwinIR',
                  'test_SwinIR_M_x4_synthetic.yml')
# full SwinIR-M width (embed 180, 6 heads of 30, window 8, mlp 2), cut to one
# RSTB of two blocks: one plain, one shifted with the mask
DEPTHS = [2]


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """Two LQ/GT pairs (LQ 16x16, and 13x21, which the model pads to 16x24
    and crops back), one seed-0 state_dict, and both pipelines run on them."""
    root = tmp_path_factory.mktemp('serve')
    rng = np.random.RandomState(0)
    for sub in ('GT', 'LQ'):
        (root / sub).mkdir()
    for name, (h, w) in {'a': (16, 16), 'b': (13, 21)}.items():
        gt = (rng.rand(4 * h, 4 * w, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(root / 'GT' / f'{name}.png'), gt)
        cv2.imwrite(str(root / 'LQ' / f'{name}.png'),
                    cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA))
    opt = port_options.yaml_load(CONFIG)
    net_opt = {k: v for k, v in opt['network_g'].items() if k != 'type'}
    net_opt.update(depths=DEPTHS, num_heads=[6] * len(DEPTHS))
    net = SwinIR(**net_opt, generator=torch.Generator().manual_seed(0))
    torch.save({'params': net.state_dict()}, root / 'net_g.pth')

    results = {}
    for name, pipeline in (('torch', port_test), ('jax', jax_test)):
        argv = ['test.py', '-opt', CONFIG, '--force_yml', 'num_gpu=0',
                f'name={name}_serve', f'path:results_root={root / "results"}',
                f'datasets:test_1:dataroot_gt={root / "GT"}',
                f'datasets:test_1:dataroot_lq={root / "LQ"}',
                f'path:pretrain_network_g={root / "net_g.pth"}',
                f'network_g:depths={DEPTHS}', f'network_g:num_heads={[6] * len(DEPTHS)}']
        saved_argv = sys.argv
        sys.argv = argv
        try:
            model = pipeline.test_pipeline(str(root))
        finally:
            sys.argv = saved_argv
        results[name] = (model, root / 'results' / f'{name}_serve' / 'visualization'
                         / 'SwinIR_M_x4_synthetic')
    return results


def test_pipeline_metrics_match_jax(served):
    """Same PSNR/SSIM as the JAX package within 1e-3 (float32 forward)."""
    port_model, _ = served['torch']
    jax_model, _ = served['jax']
    assert set(port_model.metric_results) == {'psnr', 'ssim'}
    for name, value in port_model.metric_results.items():
        assert np.isfinite(value)
        assert abs(value - jax_model.metric_results[name]) < 1e-3, name


@pytest.mark.parametrize('image, shape', [('a', (64, 64, 3)), ('b', (52, 84, 3))])
def test_pipeline_saves_the_same_images(served, image, shape):
    """Saved images have the GT's shape (pad and crop undone) and are within
    one uint8 level of the JAX package's."""
    port_img_path = served['torch'][1] / f'{image}_torch_serve.png'
    jax_img_path = served['jax'][1] / f'{image}_jax_serve.png'
    got = cv2.imread(str(port_img_path)).astype(np.int16)
    want = cv2.imread(str(jax_img_path)).astype(np.int16)
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= 1


def test_config_reads_the_same_in_both_packages():
    assert port_options.yaml_load(CONFIG) == jax_options.yaml_load(CONFIG)


def _parse(tmp_path, *force):
    args = type('Args', (), dict(opt=CONFIG,
                                 force_yml=[f'path:results_root={tmp_path}', *force]))
    return port_options.parse_options(str(tmp_path), is_train=False, args=args)[0]


def test_num_gpu_picks_the_device(tmp_path):
    """num_gpu 0 is the CPU; auto or >= 1 on a host without CUDA raises
    rather than running on the CPU."""
    assert _parse(tmp_path, 'num_gpu=0')['num_gpu'] == 0
    if torch.cuda.is_available():
        pytest.skip('this check is about a host without CUDA')
    for value in ('auto', '1'):
        with pytest.raises(RuntimeError, match='num_gpu'):
            _parse(tmp_path, f'num_gpu={value}')


def test_image_conversion_matches_jax():
    """img2tensor -> tensor2img equals the JAX package's HWC round trip."""
    img = (np.random.RandomState(1).rand(13, 21, 3) * 255).astype(np.uint8)
    as_float = img.astype(np.float32) / 255.
    tensor = port_img.img2tensor(as_float)
    assert tensor.shape == (3, 13, 21)
    np.testing.assert_array_equal(tensor.permute(1, 2, 0).numpy(),
                                  jax_img.img2tensor(as_float))
    np.testing.assert_array_equal(port_img.tensor2img(tensor[None]), img)
    noisy = tensor * 1.3 - 0.1   # out of [0, 1]: clamped the same way
    np.testing.assert_array_equal(port_img.tensor2img(noisy),
                                  jax_img.tensor2img(noisy.permute(1, 2, 0).numpy()))


@pytest.mark.parametrize('test_y_channel', [False, True])
def test_metrics_match_jax(test_y_channel):
    rng = np.random.RandomState(2)
    img = (rng.rand(40, 36, 3) * 255).astype(np.uint8)
    img2 = np.clip(img + rng.randn(40, 36, 3) * 8, 0, 255).astype(np.uint8)
    for name in ('calculate_psnr', 'calculate_ssim'):
        got = getattr(port_metrics, name)(img, img2, 4, test_y_channel=test_y_channel)
        want = getattr(jax_metrics, name)(img, img2, 4, test_y_channel=test_y_channel)
        assert got == pytest.approx(want, rel=1e-12), name


def test_load_network_drops_computed_buffers(tmp_path):
    """A BasicSR checkpoint carries ``relative_position_index`` and
    ``attn_mask`` buffers and may carry ``module.`` prefixes: they load
    strictly into the port's SwinIR."""
    cfg = dict(embed_dim=12, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.,
               upscale=2, upsampler='pixelshuffledirect')
    src = SwinIR(**cfg, generator=torch.Generator().manual_seed(3))
    state_dict = {f'module.{k}': v for k, v in src.state_dict().items()}
    block = 'module.layers.0.residual_group.blocks.1'
    state_dict[f'{block}.attn.relative_position_index'] = torch.zeros(64, 64, dtype=torch.long)
    state_dict[f'{block}.attn_mask'] = torch.zeros(4, 64, 64)
    torch.save({'params_ema': state_dict}, tmp_path / 'ckpt.pth')
    dst = SwinIR(**cfg, generator=torch.Generator().manual_seed(4))
    model = BaseModel({'is_train': False, 'num_gpu': 0})
    model.load_network(dst, str(tmp_path / 'ckpt.pth'), strict=True, param_key='params_ema')
    for key, value in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[key], value, rtol=0, atol=0)

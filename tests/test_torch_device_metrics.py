"""The port's device PSNR / SSIM (``calculate_psnr_pt``, ``calculate_ssim_pt``
and their ``_jax`` names, basicsr4rs_torch/metrics/psnr_ssim.py) against the
JAX package's, and the validation route that hands them the output and GT
tensors (basicsr4rs_torch/models/sr_model.py), on the CPU.

Inputs from a seeded numpy generator: float batches (NCHW here, NHWC in
JAX) and the 8-bit BGR images ``tensor2img`` gives, with and without
``test_y_channel`` and ``crop_border``. Both packages compute in float32:
PSNR within 1e-4 dB, SSIM within 1e-6.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.metrics import psnr_ssim as port_metrics
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.utils.registry import METRIC_REGISTRY
from basicsr4rs_tpu.metrics import psnr_ssim as jax_metrics
from basicsr4rs_tpu.models import build_model as jax_build_model

TOL = {'psnr': 1e-4, 'ssim': 1e-6}
FUNCS = {'psnr': 'calculate_psnr_pt', 'ssim': 'calculate_ssim_pt'}


def pair(rng, n=2, c=3, h=24, w=20):
    gt = rng.random((n, c, h, w), dtype=np.float32)
    out = np.clip(gt + 0.05 * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    return out, gt


@pytest.mark.parametrize('metric', list(FUNCS))
@pytest.mark.parametrize('crop_border', [0, 4])
@pytest.mark.parametrize('test_y_channel', [False, True], ids=['rgb', 'y'])
def test_float_batches_match_jax(metric, crop_border, test_y_channel):
    out, gt = pair(np.random.default_rng(crop_border + 2 * test_y_channel))
    got = getattr(port_metrics, FUNCS[metric])(torch.from_numpy(out), torch.from_numpy(gt),
                                               crop_border, test_y_channel)
    want = getattr(jax_metrics, FUNCS[metric])(jnp.asarray(out.transpose(0, 2, 3, 1)),
                                               jnp.asarray(gt.transpose(0, 2, 3, 1)),
                                               crop_border, test_y_channel)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, atol=TOL[metric], rtol=0)


@pytest.mark.parametrize('metric', list(FUNCS))
@pytest.mark.parametrize('test_y_channel', [False, True], ids=['rgb', 'y'])
def test_uint8_bgr_images_match_jax(metric, test_y_channel):
    """HWC uint8 images in BGR (flipped to RGB by both before Y), one of
    them against a float tensor of the same image in RGB."""
    rng = np.random.default_rng(7)
    img = (rng.random((20, 18, 3)) * 255).astype(np.uint8)
    img2 = np.clip(img.astype(np.int16) + rng.integers(-9, 9, img.shape), 0, 255).astype(np.uint8)
    port, jax_fn = getattr(port_metrics, FUNCS[metric]), getattr(jax_metrics, FUNCS[metric])
    got = port(img, img2, 2, test_y_channel)
    np.testing.assert_allclose(got, jax_fn(img, img2, 2, test_y_channel), atol=TOL[metric])
    rgb = torch.from_numpy(img2[..., ::-1].transpose(2, 0, 1) / 255.).float()
    np.testing.assert_allclose(port(img, rgb, 2, test_y_channel), got, atol=TOL[metric])


def test_registered_under_both_names():
    for metric, name in FUNCS.items():
        assert METRIC_REGISTRY.get(name) is getattr(port_metrics, name)
        assert METRIC_REGISTRY.get(f'calculate_{metric}_jax') is getattr(port_metrics, name)


def test_shapes_must_agree():
    with pytest.raises(ValueError):
        port_metrics.calculate_psnr_pt(torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 8, 9), 0)


class Loader:
    """A validation loader of batch-1 items, as ``build_dataloader`` gives."""

    def __init__(self, items):
        self.dataset = SimpleNamespace(opt={'name': 'val'})
        self.items = items

    def __iter__(self):
        return iter(self.items)


def model_opt(path, tmp_path):
    metrics = {'psnr': {'type': 'calculate_psnr', 'crop_border': 4},
               'psnr_pt': {'type': 'calculate_psnr_pt', 'crop_border': 4},
               'ssim_jax': {'type': 'calculate_ssim_jax', 'crop_border': 4,
                            'test_y_channel': True}}
    return {'name': 'val', 'model_type': 'SRModel', 'scale': 2, 'num_gpu': 0,
            'manual_seed': 0, 'is_train': False, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': {'type': 'MSRResNet', 'num_feat': 8, 'num_block': 1, 'upscale': 2},
            'path': {'pretrain_network_g': path, 'strict_load_g': True,
                     'visualization': str(tmp_path / 'vis')},
            'val': {'metrics': metrics}}


def test_validation_scores_the_device_tensors_as_jax(tmp_path):
    """``SRModel.nondist_validation`` of both packages on two items with
    one host and two device metrics: the device ones get the output and the
    GT as they are (tensors on the model's device, not 8-bit images) and
    agree with the JAX package's; the host PSNR agrees too."""
    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    torch.manual_seed(0)
    path = str(tmp_path / 'g.pth')
    torch.save({'params': MSRResNet(num_feat=8, num_block=1, upscale=2).state_dict()}, path)
    rng = np.random.default_rng(3)
    items = [pair(rng, 1, 3, 16, 16) for _ in range(2)]
    gts = [rng.random((1, 3, 32, 32), dtype=np.float32) for _ in range(2)]
    port_items = [{'lq': torch.from_numpy(lq), 'gt': torch.from_numpy(gt), 'lq_path': [f'{i}.png']}
                  for i, ((lq, _), gt) in enumerate(zip(items, gts))]
    jax_items = [{'lq': lq.transpose(0, 2, 3, 1), 'gt': gt.transpose(0, 2, 3, 1),
                  'lq_path': [f'{i}.png']} for i, ((lq, _), gt) in enumerate(zip(items, gts))]

    port_model = port_build_model(model_opt(path, tmp_path))
    seen = []
    real = port_metrics.calculate_psnr_pt
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(METRIC_REGISTRY._obj_map, 'calculate_psnr_pt',
                   lambda **kw: seen.append(kw) or real(**kw))
        port_model.nondist_validation(Loader(port_items), 1, None, False)
    assert len(seen) == 2
    assert all(torch.is_tensor(kw['img']) and torch.is_tensor(kw['img2']) for kw in seen)
    assert seen[-1]['img'].shape == (1, 3, 32, 32)

    jax_model = jax_build_model(model_opt(path, tmp_path))
    jax_model.nondist_validation(Loader(jax_items), 1, None, False)
    for name, tol in (('psnr', 1e-6), ('psnr_pt', TOL['psnr']), ('ssim_jax', TOL['ssim'])):
        np.testing.assert_allclose(port_model.metric_results[name],
                                   jax_model.metric_results[name], atol=tol, err_msg=name)

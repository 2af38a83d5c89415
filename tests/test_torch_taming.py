"""The port's TamingModel (basicsr4rs_torch/models/taming_model.py) against
the JAX package's, on the CPU, built from
``options/test/taming/test_taming_vqgan8192_synthetic.yml`` with a narrow
VQ (``ch`` 32, one res block, 64 codes) and GT 32. One random ``.pth`` (a
bare state_dict, as ``param_key_g: null`` reads; the codebook spread over
[-1, 1]) feeds both. Items of the taco layout from a seeded numpy
generator: 4 bands scaled by 1/3000 into [-1, 1].

Tolerances: the reconstruction within 1e-4 of its largest magnitude
(float32 convolutions in another order; every position picks the same one
of the 64 codes, which the test checks); the validation's PSNR and SSIM, on
the 8-bit images of both, within 1e-3.
"""

import copy
import os
import pathlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from basicsr4rs_torch.archs.autoencoder_arch import VQModelTorch
from basicsr4rs_torch.models import build_model as port_build_model
from basicsr4rs_torch.models.taming_model import TamingModel
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model

from test_torch_resshift import _shapes_only

CONFIG = 'options/test/taming/test_taming_vqgan8192_synthetic.yml'
PUBLISHED = 'options/test/taming/test_taming_vqgan8192.yml'
GT = 32
OUT_TOL = 1e-4


def narrow_opt(path, tmp_path):
    opt = yaml_load(CONFIG)
    opt['network_g']['ddconfig'].update(ch=32, num_res_blocks=1, resolution=GT)
    opt['network_g']['n_embed'] = 64
    opt['val']['metrics'] = {k: v for k, v in opt['val']['metrics'].items()
                             if k in ('psnr', 'ssim')}   # NIQE needs 96-pixel blocks
    opt.update(num_gpu=0, is_train=False, dist=False, rank=0, world_size=1)
    opt['path'].update(pretrain_network_g=path, visualization=str(tmp_path / 'vis'))
    return opt


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp('taming')
    gen = torch.Generator().manual_seed(0)
    opt = narrow_opt(None, tmp_path)
    net = VQModelTorch(**{k: v for k, v in opt['network_g'].items() if k != 'type'},
                       generator=gen)
    with torch.no_grad():
        net.quantize.embedding.weight.uniform_(-1., 1., generator=gen)
    path = str(tmp_path / 'vq.pth')
    torch.save(net.state_dict(), path)
    opt = narrow_opt(path, tmp_path)
    port = port_build_model(copy.deepcopy(opt))
    bands = opt['network_g']['ddconfig']['in_channels']
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sr_model, 'jit_init', _shapes_only)
        mp.setattr(jax_sr_model.SRModel, '_dummy_input',
                   lambda self: jax.numpy.zeros((1, GT, GT, bands)))
        jax_model = jax_build_model(copy.deepcopy(opt))
    return port, jax_model, net


def taco_items(n, seed=0, with_gt=True):
    """Batch-1 items as ``TacoDataset`` gives them: uint16-like reflectances
    of 4 bands over 1/3000 into [-1, 1], GT 32 and LQ 8."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        gt = rng.integers(0, 3000, (1, 4, GT, GT)).astype(np.float32) / 3000 * 2 - 1
        lq = gt[:, :, ::4, ::4].copy()
        item = {'lq': lq, 'lq_path': [f'sample{i}.taco'], 'gt_path': [f'sample{i}.taco']}
        if with_gt:
            item['gt'] = gt
        items.append(item)
    return items


class Loader:
    """A validation loader of batch-1 items, as ``build_dataloader`` gives."""

    def __init__(self, items):
        self.dataset = SimpleNamespace(opt={'name': 'taco'})
        self.items = items

    def __iter__(self):
        return iter(self.items)


def port_item(item):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in item.items()}


def jax_item(item):
    return {k: v.transpose(0, 2, 3, 1) if isinstance(v, np.ndarray) else v
            for k, v in item.items()}


def test_synthetic_config_keeps_the_published_network_and_metrics():
    published, synthetic = (yaml.safe_load(pathlib.Path(f).read_text())
                            for f in (PUBLISHED, CONFIG))
    for key in ('model_type', 'network_g', 'val', 'scale', 'datasets'):
        assert synthetic[key] == published[key], key
    assert synthetic['path']['param_key_g'] is None


@pytest.mark.parametrize('with_gt', [True, False], ids=['gt', 'lq-only'])
def test_reconstruction_matches_jax(models, with_gt):
    """``feed_data`` takes the GT as the input when the item has one, else
    its ``lq``; ``test()`` runs the autoencoder on it."""
    port, jax_model, net = models
    assert isinstance(port, TamingModel) and port.device.type == 'cpu'
    item = taco_items(1, seed=int(with_gt), with_gt=with_gt)[0]
    port.feed_data(port_item(item))
    jax_model.feed_data(jax_item(item))
    assert port.lq is (port.gt if with_gt else port.lq)
    port.test()
    jax_model.test()
    got = port.output.numpy()
    want = np.asarray(jax_model.output).transpose(0, 3, 1, 2)
    assert got.shape == (item['gt'] if with_gt else item['lq']).shape
    with torch.no_grad():   # every latent position picks the same code as in float64
        h = net.encode(port.lq)
        codes = torch.argmin(net.quantize.distances(h), dim=1)
        codes64 = torch.argmin(net.double().quantize.distances(h.double()), dim=1)
        net.float()
    assert torch.equal(codes, codes64)
    np.testing.assert_allclose(got, want, atol=OUT_TOL * np.abs(want).max(), rtol=0)


def test_validation_matches_jax(models, tmp_path):
    """Both packages' validation over two taco items: the same PSNR and
    SSIM, one CSV row an item."""
    port, jax_model, _ = models
    items = taco_items(2, seed=5)
    for model, convert, name in ((port, port_item, 'port'), (jax_model, jax_item, 'jax')):
        model.opt['path']['visualization'] = str(tmp_path / name)
        model.nondist_validation(Loader([convert(item) for item in items]), 'synthetic', None,
                                 save_img=False)
    for metric in ('psnr', 'ssim'):
        assert np.isfinite(port.metric_results[metric])
        np.testing.assert_allclose(port.metric_results[metric],
                                   jax_model.metric_results[metric], atol=1e-3, err_msg=metric)
    with open(os.path.join(tmp_path, 'port', 'taco_synthetic.csv')) as f:
        rows = f.read().splitlines()
    assert rows[0] == ',psnr,ssim' and len(rows) == 3

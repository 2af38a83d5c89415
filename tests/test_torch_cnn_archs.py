"""The port's classic CNN SR networks (basicsr4rs_torch/archs/edsr_arch.py,
rcan_arch.py, rrdbnet_arch.py, srvgg_arch.py, ridnet_arch.py,
ecbsr_arch.py), its discriminators' and VGG's weight layout, the weight
carry-over of utils/jax_convert.py, LDL's artifact map and
``SingleImageDataset``, against the JAX package's on the same numpy inputs.

Each network is the port's, its parameters (and BatchNorm statistics)
drawn from a seed, every one non-zero (kernels at std 1/sqrt(fan-in));
the JAX module gets them through the JAX package's own reader of torch
checkpoints (``convert_torch_state_dict`` with its ``TORCH_KEY_RULES``), and
``jax_params_to_state_dict`` under the port's ``JAX_KEY_RULES`` must carry
them back bit for bit. Float32 on the CPU; outputs within 1e-5 of their
largest entry (sums in another order; nothing here is deeper than a few
convolutions)."""

import functools
import os
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import arch_util as port_util
from basicsr4rs_torch.archs import build_network
from basicsr4rs_torch.data import build_dataset as port_build_dataset
from basicsr4rs_torch.losses.loss_util import get_refined_artifact_map
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.registry import ARCH_REGISTRY
from basicsr4rs_tpu.archs import discriminator_arch as jax_disc
from basicsr4rs_tpu.archs import ecbsr_arch as jax_ecbsr
from basicsr4rs_tpu.archs import edsr_arch as jax_edsr
from basicsr4rs_tpu.archs import rcan_arch as jax_rcan
from basicsr4rs_tpu.archs import ridnet_arch as jax_ridnet
from basicsr4rs_tpu.archs import rrdbnet_arch as jax_rrdbnet
from basicsr4rs_tpu.archs import srvgg_arch as jax_srvgg
from basicsr4rs_tpu.archs import vgg_arch as jax_vgg
from basicsr4rs_tpu.data import build_dataset as jax_build_dataset
from basicsr4rs_tpu.losses.loss_util import get_refined_artifact_map as jax_artifact_map
from basicsr4rs_tpu.utils.torch_convert import convert_torch_state_dict

TOL = 1e-5
BABOON = os.path.join(os.path.dirname(__file__), 'data', 'baboon.png')

# name: (JAX module, port options, input (N, H, W, C)); narrow widths, few blocks
CASES = {
    'EDSR': (jax_edsr.EDSR, dict(num_feat=16, num_block=2, upscale=4, res_scale=0.1),
             (2, 10, 12, 3)),
    'RCAN': (jax_rcan.RCAN, dict(num_feat=16, num_group=2, num_block=2, squeeze_factor=4,
                                 upscale=2), (2, 10, 12, 3)),
    'RRDBNet_x4': (jax_rrdbnet.RRDBNet, dict(num_feat=8, num_block=1, num_grow_ch=4, scale=4),
                   (2, 8, 12, 3)),
    'RRDBNet_x2': (jax_rrdbnet.RRDBNet, dict(num_feat=8, num_block=1, num_grow_ch=4, scale=2),
                   (2, 8, 12, 3)),
    'RRDBNet_x1': (jax_rrdbnet.RRDBNet, dict(num_feat=8, num_block=1, num_grow_ch=4, scale=1),
                   (2, 8, 12, 3)),
    'SRVGGNetCompact': (jax_srvgg.SRVGGNetCompact, dict(num_feat=8, num_conv=2, upscale=2),
                        (2, 9, 11, 3)),
    'RIDNet': (jax_ridnet.RIDNet, dict(mid_channels=16, num_block=1), (2, 9, 11, 3)),
    'ECBSR': (jax_ecbsr.ECBSR, dict(num_in_ch=1, num_out_ch=1, num_block=1, num_channel=8,
                                    scale=2, with_idt=True), (2, 9, 11, 1)),
}
FORWARD = list(CASES) + ['EDSR_fused']
# the rest of the carry-over: keys and layouts with nothing to run forward here
LAYOUT_ONLY = {
    'VGGFeatureExtractor': (jax_vgg.VGGFeatureExtractor,
                            dict(layer_name_list=['conv2_2']), (1, 16, 16, 3)),
    'VGGStyleDiscriminator': (jax_disc.VGGStyleDiscriminator, dict(num_feat=4), (1, 128, 128, 3)),
    'UNetDiscriminatorSN': (jax_disc.UNetDiscriminatorSN, dict(num_feat=4), (1, 16, 16, 3)),
}


def arch_name(case):
    return case.split('_')[0] if case.startswith('RRDBNet') else case


def redraw_(net, seed):
    """Every parameter and BatchNorm statistic of ``net`` drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith('num_batches_tracked'):
                continue
            if name.endswith('running_var'):
                t.uniform_(0.5, 2, generator=gen)
            elif t.dim() > 1:
                t.normal_(0, t[0].numel()**-0.5, generator=gen)
            else:
                t.normal_(0, 0.1, generator=gen)
    return net


def split_stats(tree):
    """(params, batch_stats) of a tree the JAX reader made: BatchNorm's
    running statistics go to a collection of their own."""
    params, stats = {}, {}
    for name, node in tree.items():
        if isinstance(node, dict) and 'running_mean' in node:
            stats[name] = {'mean': node.pop('running_mean'), 'var': node.pop('running_var')}
        params[name] = node
    return params, (stats or None)


@functools.lru_cache(maxsize=None)
def case_pair(case):
    """(JAX module, the port's network in eval mode, its state_dict, the JAX
    params and batch_stats read from it, input NHWC)."""
    cls, opts, shape = dict(CASES, **LAYOUT_ONLY)[case]
    module = cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in opts.items()})
    net = redraw_(build_network(dict(type=arch_name(case), **opts)), len(case)).eval()
    x = np.random.RandomState(len(case)).rand(*shape).astype(np.float32)
    rules = getattr(cls, 'TORCH_KEY_RULES', None)
    if case == 'VGGFeatureExtractor':   # the JAX extractor reads torchvision's layout only
        rules = ((r'^vgg_net\.', ''),)
    sd = net.state_dict()
    params, stats = split_stats(convert_torch_state_dict(
        {k: v for k, v in sd.items() if not k.endswith('num_batches_tracked')}, rules))
    return module, net, sd, params, stats, x


def jax_forward(module, params, x):
    return np.asarray(jax.jit(lambda p, v: module.apply({'params': p}, v))(params, jnp.asarray(x)))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def assert_close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f'{what}: {err:.3e}'


@pytest.mark.parametrize('case', FORWARD)
def test_forward_matches_jax(case, monkeypatch):
    """Every network in eval mode; ``EDSR_fused`` runs the port's upsampler
    through ``fused_conv3x3`` (``SWIN_FUSED_CONV=1``; on the CPU its plain
    version) against the JAX package's default route."""
    module, net, _, params, _, x = case_pair(case.replace('_fused', ''))
    want = jax_forward(module, params, x)
    fused_calls = []
    if case.endswith('_fused'):
        monkeypatch.setenv('SWIN_FUSED_CONV', '1')
        real = port_util.fused_conv3x3
        monkeypatch.setattr(port_util, 'fused_conv3x3',
                            lambda *a, **k: fused_calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = net(nchw(x))
    assert_close(got.numpy().transpose(0, 2, 3, 1), want, case)
    assert len(fused_calls) == (2 if case.endswith('_fused') else 0)   # x4: two upsampler convs


def test_ecbsr_reparameterised_equals_branched_in_both_packages():
    """The port's ECBSR in eval mode runs each ECB as one 3x3 conv
    (``ecb_rep_params``), in train mode its five branches: both equal the
    JAX branched forward. The JAX ``ecb_rep_params`` of every block equals
    the port's (the identity folded in), and the JAX package's folded conv
    equals its own branched block."""
    from basicsr4rs_torch.archs.ecbsr_arch import ecb_rep_params
    module, net, _, params, _, x = case_pair('ECBSR')
    want = jax_forward(module, params, x)
    with torch.no_grad():
        rep = net.eval()(nchw(x))
        branched = net.train()(nchw(x))
    net.eval()
    assert_close(rep.numpy().transpose(0, 2, 3, 1), want, 're-parameterised')
    assert_close(branched.numpy().transpose(0, 2, 3, 1), want, 'branched')
    for i, ecb in enumerate(net.backbone):
        jw, jb = jax_ecbsr.ecb_rep_params(params[f'backbone_{i}'], ecb.in_channels,
                                          ecb.out_channels, True)
        with torch.no_grad():
            pw, pb = ecb_rep_params(ecb)
        assert_close(pw.numpy().transpose(2, 3, 1, 0), jw, f'backbone {i} weight')
        assert_close(pb.numpy(), jb, f'backbone {i} bias')
    jw, jb = jax_ecbsr.ecb_rep_params(params['backbone_1'], 8, 8, True)
    x8 = jnp.asarray(np.random.RandomState(0).rand(1, 7, 6, 8).astype(np.float32))
    y_rep = jax.lax.conv_general_dilated(x8, jw, (1, 1), 'SAME',
                                         dimension_numbers=('NHWC', 'HWIO', 'NHWC')) + jb
    y = jax_ecbsr.ECB(8, 8, 2.0, 'linear', True).apply({'params': params['backbone_1']}, x8)
    assert_close(y_rep, y, 'JAX ECB folded')


@pytest.mark.parametrize('case', list(CASES) + list(LAYOUT_ONLY))
def test_weight_carry_over_round_trip(case):
    """The port's state_dict -> the JAX package's reader (a tree of the JAX
    module's own structure and shapes) -> ``jax_params_to_state_dict``, the
    BatchNorm statistics included -> the same state_dict, bit for bit, which
    loads strictly."""
    module, net, sd, params, stats, x = case_pair(case)
    kwargs = {'train': False} if case == 'VGGStyleDiscriminator' else {}
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs))
    for collection, tree in (('params', params), ('batch_stats', stats)):
        want = shapes.get(collection)
        if want is None:
            assert tree is None
            continue
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(dict(want))
        for (path, got), ref in zip(jax.tree_util.tree_leaves_with_path(tree),
                                    jax.tree_util.tree_leaves(want)):
            assert np.shape(got) == ref.shape, (collection, path)
    back = jax_params_to_state_dict(params, type(net).JAX_KEY_RULES, stats)
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        if key.endswith('num_batches_tracked'):
            assert back[key].item() == 0
        else:
            np.testing.assert_array_equal(back[key].numpy(), value.numpy(), err_msg=key)
    type(net)(**dict(CASES, **LAYOUT_ONLY)[case][1]).load_state_dict(back, strict=True)


def test_registry_names_and_aliases():
    """The same registry names as the JAX package, the two suffixed aliases
    included, so that one YAML builds in both."""
    from basicsr4rs_tpu.utils.registry import ARCH_REGISTRY as JAX_ARCHS
    for name in ('EDSR', 'RCAN', 'RRDBNet', 'SRVGGNetCompact', 'SRVGGNetCompact_basicsr4rs_tpu',
                 'RIDNet', 'ECBSR', 'VGGFeatureExtractor', 'VGGStyleDiscriminator',
                 'UNetDiscriminatorSN', 'UNetDiscriminatorSN_basicsr4rs_tpu'):
        assert ARCH_REGISTRY.get(name).__name__ == JAX_ARCHS.get(name).__name__, name


def test_refined_artifact_map_matches_jax():
    """LDL's map on NCHW images: local unbiased variance in reflect-padded
    7x7 windows, the image's variance to the power 1/5, zero where the
    output beats the EMA output (the test makes both cases occur)."""
    rng = np.random.RandomState(3)
    gt, out, ema = (rng.rand(2, 20, 17, 3).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_artifact_map(jnp.asarray(gt), jnp.asarray(out), jnp.asarray(ema), 7))
    got = get_refined_artifact_map(nchw(gt), nchw(out), nchw(ema), 7)
    assert got.shape == (2, 1, 20, 17)
    assert_close(got.numpy().transpose(0, 2, 3, 1), want, 'artifact map')
    zeros = (got == 0).float().mean().item()
    assert 0.2 < zeros < 0.8


@pytest.mark.parametrize('color', ['rgb', 'y'])
def test_single_image_dataset_matches_jax(color, tmp_path):
    """Folder mode on three crops of baboon.png, with mean / std and with
    ``color: y``: the same images and paths in both packages."""
    img = cv2.imread(BABOON)
    for i, (y, x) in enumerate([(0, 0), (40, 17), (100, 61)]):
        cv2.imwrite(str(tmp_path / f'{i:03d}.png'), img[y:y + 31, x:x + 27])
    opt = {'name': 'single', 'type': 'SingleImageDataset', 'phase': 'test',
           'dataroot_lq': str(tmp_path), 'io_backend': {'type': 'disk'}}
    if color == 'y':
        opt['color'] = 'y'
    else:
        opt.update(mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3])
    port, jax_set = port_build_dataset(dict(opt)), jax_build_dataset(dict(opt))
    assert len(port) == len(jax_set) == 3
    for i in range(3):
        got, want = port[i], jax_set[i]
        assert got['lq_path'] == want['lq_path']
        assert got['lq'].shape == ((1 if color == 'y' else 3), 31, 27)
        np.testing.assert_allclose(got['lq'].numpy().transpose(1, 2, 0), np.asarray(want['lq']),
                                   rtol=1e-6, atol=1e-6)
    # LMDB mode without the lmdb package: both packages build the dataset
    # from the folder's meta_info.txt and raise the gate at the first item
    lmdb_root = tmp_path / 'lq.lmdb'
    lmdb_root.mkdir()
    (lmdb_root / 'meta_info.txt').write_text('000.png (31,27,3) 1\n')
    lmdb_opt = dict(opt, dataroot_lq=str(lmdb_root), io_backend={'type': 'lmdb'})
    with mock.patch.dict('sys.modules', {'lmdb': None}):
        for dataset in (port_build_dataset(dict(lmdb_opt)), jax_build_dataset(dict(lmdb_opt))):
            assert dataset.paths == ['000']
            with pytest.raises(ImportError, match='lmdb'):
                dataset[0]


def test_upsample_counts_one_fused_conv_per_stage():
    """``Upsample`` with ``SWIN_FUSED_CONV=1`` hands each stage's conv to
    ``fused_conv3x3`` and nothing else: x4 two stages, x3 one."""
    for scale, stages in ((4, 2), (3, 1)):
        calls = []
        up = port_util.Upsample(scale, 8)
        real = port_util.fused_conv3x3
        with mock.patch.dict(os.environ, {'SWIN_FUSED_CONV': '1'}), \
                mock.patch.object(port_util, 'fused_conv3x3',
                                  lambda *a, **k: calls.append(1) or real(*a, **k)):
            with torch.no_grad():
                out = up(torch.rand(1, 8, 5, 6))
        assert out.shape == (1, 8, 5 * scale, 6 * scale) and len(calls) == stages


SYNTHETIC = {
    'options/train/ESRGAN/train_ESRGAN_x4_synthetic.yml': 'options/train/ESRGAN/train_ESRGAN_x4.yml',
    'options/test/ESRGAN/test_ESRGAN_x4_synthetic.yml': 'options/test/ESRGAN/test_ESRGAN_x4.yml',
    'options/train/EDSR/train_EDSR_Lx4_synthetic.yml': 'options/train/EDSR/train_EDSR_Lx4.yml',
    'options/test/EDSR/test_EDSR_Lx4_synthetic.yml': 'options/test/EDSR/test_EDSR_Lx4.yml',
    'options/train/SRResNet_SRGAN/train_MSRGAN_x4_synthetic.yml':
        'options/train/SRResNet_SRGAN/train_MSRGAN_x4.yml',
    'options/train/ECBSR/train_ECBSR_x4_m4c16_prelu_synthetic.yml':
        'options/train/ECBSR/train_ECBSR_x4_m4c16_prelu.yml',
    'options/train/RCAN/train_RCAN_x2_synthetic.yml':
        'options/train/RCAN/train_RCAN_x2.yml',
}


@pytest.mark.parametrize('synthetic', sorted(SYNTHETIC))
def test_synthetic_config_is_the_published_one(synthetic):
    """Every key as published but the data roots (the synthetic tree of
    the config's scale) and ``pretrain_network_g`` (null); the test configs
    keep their first test set only, and ECBSR's training set is a folder on
    disk (no LMDB backend, no meta-info file) with one validation set."""
    from basicsr4rs_torch.utils.options import yaml_load
    root = os.path.join(os.path.dirname(__file__), '..')
    got = yaml_load(os.path.join(root, synthetic))
    want = yaml_load(os.path.join(root, SYNTHETIC[synthetic]))
    assert got['path'].pop('pretrain_network_g') is None
    want['path'].pop('pretrain_network_g')
    for phase in list(want['datasets']):
        if phase not in ('train', 'val', 'test_1'):
            assert phase not in got['datasets']
            want['datasets'].pop(phase)
            continue
        ds, ref = got['datasets'][phase], want['datasets'][phase]
        for key in ('dataroot_gt', 'dataroot_lq'):
            assert ds.pop(key).startswith(f'datasets/CNN_x{want["scale"]}_synthetic/')
            ref.pop(key)
        if 'ECBSR' in synthetic:
            ref.pop('filename_tmpl' if phase == 'val' else 'meta_info_file')
            ref['io_backend'] = {'type': 'disk'}
    assert got == want


def test_inference_scripts_match_the_networks(tmp_path):
    """``inference_esrgan`` and ``inference_ridnet`` on the CPU: each output
    image is the network's output on the input, from ``params_ema``."""
    from basicsr4rs_torch.archs.ridnet_arch import RIDNet
    from basicsr4rs_torch.archs.rrdbnet_arch import RRDBNet
    from basicsr4rs_torch.inference import inference_esrgan, inference_ridnet
    img = cv2.imread(BABOON)[:10, :13]
    (tmp_path / 'in').mkdir()
    cv2.imwrite(str(tmp_path / 'in' / 'a.png'), img)
    x = torch.from_numpy(np.ascontiguousarray(img[..., ::-1].transpose(2, 0, 1)))[None] / 255.
    torch.manual_seed(0)
    for net, script, tag, args in (
            (RRDBNet(num_feat=8, num_block=1), inference_esrgan, 'ESRGAN',
             ['--num_feat', '8', '--num_block', '1']),
            (RIDNet(), inference_ridnet, 'RIDNet', [])):
        torch.save({'params': {}, 'params_ema': redraw_(net, 1).state_dict()}, tmp_path / 'n.pth')
        script.main(['--model_path', str(tmp_path / 'n.pth'), '--input', str(tmp_path / 'in'),
                     '--output', str(tmp_path / tag), '--device', 'cpu', *args])
        with torch.no_grad():
            want = net.eval()(x.float())[0].clamp(0, 1).permute(1, 2, 0).numpy()[..., ::-1]
        got = cv2.imread(str(tmp_path / tag / f'a_{tag}.png'))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, (want * 255).round().astype(np.uint8))

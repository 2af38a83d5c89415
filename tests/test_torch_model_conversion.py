"""The port's checkpoint conversion (``basicsr4rs_torch/scripts/
model_conversion/``) and its two small scripts (``scripts/publish_models.py``,
``scripts/plot/model_complexity.py``) against the repository's root scripts,
on the CPU.

No official checkpoint is here: each official key list is written from the
original repositories' naming (EDSR-PyTorch, RCAN, ESRGAN, EDVR, DUF, RIDNet,
rosinality's stylegan2-pytorch, DFDNet), its tensors shaped as the port's
network at small widths (DFDNet at its only width, on the meta device). Each
key function is held against the root one name by name, and each converted
``.pth`` loads strictly through the port's ``load_network``, every tensor
equal to the one it came from. Tolerances: names, tensors, digests and
parameter counts equal exactly; FLOPs as ``test_model_complexity_matches_jax``
states.
"""

import functools
import importlib.util
import json
import os
import pathlib
import re
import sys
import types
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import build_network
from basicsr4rs_torch.archs.vgg_arch import vgg_layer_names
from basicsr4rs_torch.models.base_model import BaseModel
from basicsr4rs_torch.scripts import publish_models as port_publish
from basicsr4rs_torch.scripts.model_conversion import convert_dfdnet as port_convert_dfdnet
from basicsr4rs_torch.scripts.model_conversion import convert_models as port_convert
from basicsr4rs_torch.scripts.model_conversion import convert_ridnet as port_convert_ridnet
from basicsr4rs_torch.scripts.model_conversion import convert_stylegan as port_convert_stylegan
from basicsr4rs_torch.scripts.model_conversion import zoo_remaps as port_remaps
from basicsr4rs_torch.scripts.plot import model_complexity as port_complexity

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.cache
def root_script(folder, name):
    """The root script ``scripts/<folder>/<name>.py`` as a module (the
    conversion drivers import ``zoo_remaps`` from their own folder)."""
    path = ROOT / 'scripts' / folder / f'{name}.py'
    sys.path.insert(0, str(path.parent))
    try:
        spec = importlib.util.spec_from_file_location(f'root_{folder}_{name}', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(path.parent))
    return module


def root_remaps():
    return root_script('model_conversion', 'zoo_remaps')


def load_strictly(net, path):
    """``load_network`` of the port's models, strict, ``params``."""
    BaseModel.load_network(types.SimpleNamespace(get_bare_model=lambda n: n), net, str(path))


def official_state(official_keys, key_fn, target, dropped_shape=(1,)):
    """{official key: tensor}: the tensor of ``target`` (a state dict under
    BasicSR's names) at the name ``key_fn`` gives, a fresh one where it
    drops the key."""
    gen = torch.Generator().manual_seed(0)
    out = OrderedDict()
    for key in official_keys:
        name = key_fn(key)
        if name is None:
            out[key] = torch.randn(dropped_shape, generator=gen)
        elif target[name].is_floating_point():
            out[key] = torch.randn(target[name].shape, generator=gen)
        else:   # BatchNorm's num_batches_tracked
            out[key] = torch.randint(0, 100, target[name].shape, generator=gen)
    return out


def conv_keys(*names):
    return [f'{n}.{p}' for n in names for p in ('weight', 'bias')]


def edsr_official(num_block):
    keys = conv_keys('sub_mean', 'add_mean', 'head.0')
    for i in range(num_block):
        keys += conv_keys(f'body.{i}.body.0', f'body.{i}.body.2')
    return keys + conv_keys(f'body.{num_block}', 'tail.0.0', 'tail.0.2', 'tail.1')


def rcan_official(num_group, num_block):
    keys = conv_keys('sub_mean', 'add_mean', 'head.0')
    for g in range(num_group):
        for b in range(num_block):
            keys += conv_keys(*(f'body.{g}.body.{b}.body.{c}' for c in (0, 2)),
                              *(f'body.{g}.body.{b}.body.3.conv_du.{d}' for d in (0, 2)))
        keys += conv_keys(f'body.{g}.body.{num_block}')
    return keys + conv_keys(f'body.{num_group}', 'tail.0.0', 'tail.0.2', 'tail.1')


def esrgan_official(num_block):
    keys = conv_keys('conv_first', 'trunk_conv', 'upconv1', 'upconv2', 'HRconv', 'conv_last')
    for i in range(num_block):
        keys += conv_keys(*(f'RRDB_trunk.{i}.RDB{j}.conv{c}' for j in (1, 2, 3)
                            for c in (1, 2, 3, 4, 5)))
    return keys


def edvr_official(num_extract, num_reconstruct):
    res = lambda n: conv_keys(f'{n}.conv1', f'{n}.conv2')   # noqa: E731
    keys = conv_keys('pre_deblur.conv_first_1', 'pre_deblur.conv_first_2',
                     'pre_deblur.conv_first_3', 'pre_deblur.deblur_L2_conv',
                     'pre_deblur.deblur_L3_conv')
    keys += res('pre_deblur.RB_L3_1') + res('pre_deblur.RB_L2_1') + res('pre_deblur.RB_L2_2')
    for i in range(1, 6):
        keys += res(f'pre_deblur.RB_L1_{i}')
    keys += conv_keys('conv_1x1')
    for i in range(num_extract):
        keys += res(f'feature_extraction.{i}')
    keys += conv_keys('fea_L2_conv1', 'fea_L2_conv2', 'fea_L3_conv1', 'fea_L3_conv2')
    for lv in (3, 2, 1):
        keys += conv_keys(f'pcd_align.L{lv}_offset_conv1', f'pcd_align.L{lv}_offset_conv2')
        if lv < 3:
            keys += conv_keys(f'pcd_align.L{lv}_offset_conv3', f'pcd_align.L{lv}_fea_conv')
        keys += conv_keys(f'pcd_align.L{lv}_dcnpack', f'pcd_align.L{lv}_dcnpack.conv_offset_mask')
    keys += conv_keys('pcd_align.cas_offset_conv1', 'pcd_align.cas_offset_conv2',
                      'pcd_align.cas_dcnpack', 'pcd_align.cas_dcnpack.conv_offset_mask',
                      'tsa_fusion.tAtt_1', 'tsa_fusion.tAtt_2', 'tsa_fusion.fea_fusion',
                      *(f'tsa_fusion.sAtt_{i}' for i in range(1, 6)),
                      'tsa_fusion.sAtt_L1', 'tsa_fusion.sAtt_L2', 'tsa_fusion.sAtt_L3',
                      'tsa_fusion.sAtt_add_1', 'tsa_fusion.sAtt_add_2')
    for i in range(num_reconstruct):
        keys += res(f'recon_trunk.{i}')
    return keys + conv_keys('upconv1', 'upconv2', 'HRconv', 'conv_last')


def duf_official():
    bn = lambda n: [f'{n}.{p}' for p in ('weight', 'bias', 'running_mean', 'running_var',   # noqa
                                         'num_batches_tracked')]
    keys = conv_keys('conv3d_1')
    for blk in ('dense_block_1', 'dense_block_2'):
        for i in range(1, 7):
            keys += bn(f'{blk}.bn3d_{i}') + conv_keys(f'{blk}.conv3d_{i}')
    return keys + bn('bn3d_2') + conv_keys('conv3d_2', 'conv3d_r1', 'conv3d_r2', 'conv3d_f1',
                                           'conv3d_f2')


CASES = {   # model: (official keys, port arch options, converter arguments)
    'edsr': (edsr_official(2), dict(type='EDSR', num_feat=8, num_block=2, upscale=4),
             dict(num_block=2)),
    'rcan': (rcan_official(2, 2), dict(type='RCAN', num_feat=16, num_group=2, num_block=2,
                                       squeeze_factor=4, upscale=4),
             dict(num_group=2, rcan_num_block=2)),
    'esrgan': (esrgan_official(2), dict(type='RRDBNet', num_feat=8, num_block=2, num_grow_ch=4),
               dict()),
    'edvr': (edvr_official(2, 2), dict(type='EDVR', num_feat=8, num_frame=5, deformable_groups=2,
                                       num_extract_block=2, num_reconstruct_block=2,
                                       with_predeblur=True, hr_in=True), dict()),
    'duf': (duf_official(), dict(type='DUF', scale=2, num_layer=16, adapt_official_weights=True),
            dict(scale=2)),
}
KEY_FNS = {'edsr': lambda m, a: functools.partial(m.remap_edsr, num_block=a['num_block']),
           'rcan': lambda m, a: functools.partial(m.remap_rcan, num_group=a['num_group'],
                                                  num_block=a['rcan_num_block']),
           'esrgan': lambda m, a: m.remap_esrgan_rrdb, 'edvr': lambda m, a: m.remap_edvr,
           'duf': lambda m, a: m.remap_duf_16l}


@pytest.mark.parametrize('model', sorted(CASES))
def test_convert_models_matches_root_and_loads_strictly(tmp_path, model):
    keys, arch_opt, conv_args = CASES[model]
    port_fn, root_fn = KEY_FNS[model](port_remaps, conv_args), KEY_FNS[model](root_remaps(),
                                                                              conv_args)
    assert [port_fn(k) for k in keys] == [root_fn(k) for k in keys]
    net = build_network(dict(arch_opt))
    official = official_state(keys, port_fn, net.state_dict())
    torch.save({'state_dict': official}, tmp_path / 'official.pth')
    argv = ['--model', model, '--input', str(tmp_path / 'official.pth'),
            '--output', str(tmp_path / 'converted.pth')]
    argv += [v for k, a in conv_args.items() for v in (f'--{k}', str(a))]
    port_convert.main(argv)
    load_strictly(net, tmp_path / 'converted.pth')
    want = port_remaps.remap_state_dict(official, port_fn)
    if model == 'duf':   # the residual head's channels regrouped, as the root script does
        w, b = root_remaps().reorder_duf_r2(want['conv3d_r2.weight'].numpy(),
                                            want['conv3d_r2.bias'].numpy(), conv_args['scale'])
        want['conv3d_r2.weight'], want['conv3d_r2.bias'] = torch.from_numpy(w), torch.from_numpy(b)
    got = net.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_reorder_duf_r2_matches_root():
    scale = 2
    w = np.arange(3 * scale**2 * 2, dtype=np.float32).reshape(-1, 2, 1, 1, 1)
    b = np.arange(3 * scale**2, dtype=np.float32)
    got_w, got_b = port_remaps.reorder_duf_r2(torch.from_numpy(w), torch.from_numpy(b), scale)
    want_w, want_b = root_remaps().reorder_duf_r2(w, b, scale)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_b.numpy(), [0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8, 11])


def test_convert_ridnet_positional_matches_root(tmp_path):
    """The name order equals the port's ``named_parameters`` and the root's
    list; the official tensors land by position."""
    root = root_script('model_conversion', 'convert_ridnet')
    names = port_convert_ridnet.basicsr_ridnet_param_order()
    assert names == root.basicsr_ridnet_param_order()
    net = build_network({'type': 'RIDNet', 'in_channels': 3, 'mid_channels': 16,
                         'out_channels': 3})
    assert names == [n for n, _ in net.named_parameters()] == list(net.state_dict())
    gen = torch.Generator().manual_seed(1)
    official = OrderedDict((f'module_{i}', torch.randn(p.shape, generator=gen))
                           for i, p in enumerate(net.parameters()))
    assert list(port_remaps.remap_ridnet_positional(official, names)) == list(
        root_remaps().remap_ridnet_positional(official, names))
    with pytest.raises(ValueError, match='mismatch'):
        port_remaps.remap_ridnet_positional(official, names[:-1])
    torch.save(official, tmp_path / 'official.pt')
    port_convert_ridnet.main(['--input', str(tmp_path / 'official.pt'),
                              '--output', str(tmp_path / 'ridnet.pth')])
    load_strictly(net, tmp_path / 'ridnet.pth')
    for p, value in zip(net.parameters(), official.values()):
        assert torch.equal(p.detach(), value)


def rosinality_g_key(name):
    """BasicSR's StyleGAN2 generator name -> rosinality's."""
    rules = ((r'^style_mlp\.', 'style.'), (r'^constant_input\.weight$', 'input.input'),
             (r'^style_conv1\.modulated_conv\.', 'conv1.conv.'),
             (r'^style_conv1\.weight$', 'conv1.noise.weight'), (r'^style_conv1\.', 'conv1.'),
             (r'^style_convs\.(\d+)\.modulated_conv\.', r'convs.\1.conv.'),
             (r'^style_convs\.(\d+)\.weight$', r'convs.\1.noise.weight'),
             (r'^style_convs\.', 'convs.'), (r'\.modulated_conv\.', '.conv.'),
             (r'^noises\.noise(\d+)$', r'noises.noise_\1'))
    for pat, repl in rules:
        new, n = re.subn(pat, repl, name)
        if n:
            return new
    return name


def test_convert_stylegan_matches_root_and_loads_strictly(tmp_path):
    opt = dict(out_size=16, channel_multiplier=1, narrow=0.25)
    g = build_network(dict(opt, type='StyleGAN2Generator', num_style_feat=8, num_mlp=2))
    d = build_network(dict(opt, type='StyleGAN2Discriminator'))
    gen = torch.Generator().manual_seed(2)
    g_off = OrderedDict((rosinality_g_key(k), torch.randn(v.shape, generator=gen))
                        for k, v in g.state_dict().items())
    d_off = OrderedDict((re.sub(r'^conv_body\.', 'convs.', k), torch.randn(v.shape, generator=gen))
                        for k, v in d.state_dict().items())
    assert 'convs.0.noise.weight' in g_off and 'noises.noise_0' in g_off
    root = root_remaps()
    for key, value in g_off.items():
        assert (port_remaps.remap_stylegan2_g(key, value.shape)
                == root.remap_stylegan2_g(key, tuple(value.shape))), key
    for key in d_off:
        assert port_remaps.remap_stylegan2_d(key) == root.remap_stylegan2_d(key), key
    torch.save({'g_ema': g_off, 'd': d_off, 'latent_avg': torch.zeros(8)}, tmp_path / 'sg2.pth')
    port_convert_stylegan.main(['--input', str(tmp_path / 'sg2.pth'), '--output_g',
                                str(tmp_path / 'g.pth'), '--output_d', str(tmp_path / 'd.pth')])
    for net, official, path in ((g, g_off, 'g.pth'), (d, d_off, 'd.pth')):
        load_strictly(net, tmp_path / path)
        for value, got in zip(official.values(), net.state_dict().values()):
            assert torch.equal(got, value)


def dfdnet_official_key(name, vgg_names):
    """BasicSR's DFDNet name -> the official network's."""
    m = re.match(r'^attn_blocks\.(left_eye|right_eye|nose|mouth)_(.+)$', name)
    if m:
        part = {'left_eye': 'le', 'right_eye': 're', 'nose': 'no', 'mouth': 'mo'}[m.group(1)]
        return f'{part}_{m.group(2)}'
    m = re.match(r'^multi_scale_dilation\.conv_blocks\.(\d)\.(.+)$', name)
    if m:
        return f'MSDilate.conv{int(m.group(1)) + 1}.{m.group(2)}'
    name = name.replace('multi_scale_dilation.conv_fusion.', 'MSDilate.convi.')
    m = re.match(r'^vgg_extractor\.vgg_net\.(\w+)\.(.+)$', name)
    if m:
        return f'VggExtract.model.features.{vgg_names.index(m.group(1))}.{m.group(2)}'
    m = re.match(r'^upsample(\d)\.(.+)$', name)
    if m:
        rest = m.group(2).replace('scale_block', 'ScaleModel1').replace('shift_block',
                                                                         'ShiftModel1')
        return f'up{m.group(1)}.' + re.sub(r'^(\d+)\.body\.', r'\1.Model.', rest)
    return name


def test_convert_dfdnet_loads_strictly_on_the_meta_device(tmp_path):
    """On the meta device (its VGG19 and dictionaries' widths are fixed):
    the official names, with the spectral norms' power-iteration vectors, the
    VGG's classifier and its second copy in ``VggExtract.features``, convert
    to names that load strictly. The root key function agrees on every name
    it maps to BasicSR's; the names it leaves as they are (``le_256.``,
    ``up<i>.``, the VGG's ``features.<i>``) are the ones the port adds."""
    with torch.device('meta'):
        net = build_network({'type': 'DFDNet', 'num_feat': 64})
    vgg = vgg_layer_names('vgg19')
    target = net.state_dict()
    official = OrderedDict()
    for name, value in target.items():
        official[dfdnet_official_key(name, vgg)] = torch.empty(value.shape, device='meta')
        if name.endswith('weight_orig'):
            for v, size in (('u', value.shape[0]), ('v', value[0].numel())):
                official[dfdnet_official_key(name, vgg)[:-4] + v] = torch.empty(size,
                                                                                device='meta')
    official['VggExtract.RGB_mean'] = torch.empty(1, 3, 1, 1, device='meta')
    official['VggExtract.model.classifier.0.weight'] = torch.empty(4096, 25088, device='meta')
    official['VggExtract.features.0.0.weight'] = torch.empty(64, 3, 3, 3, device='meta')
    key_fn = functools.partial(port_remaps.remap_dfdnet, vgg_names=vgg)
    root = root_remaps()
    differ = set()
    for key in official:
        want = root.remap_dfdnet(key)
        if key_fn(key) != want:
            differ.add(re.sub(r'[._].*', '', key))
            assert want not in target, key
    assert differ == {'le', 're', 'no', 'mo', 'up0', 'up1', 'up2', 'up3', 'up4', 'VggExtract'}
    samples = ['le.64.0.weight', 're.128.1.bias', 'mo.256.0.weight', 'no.512.2.weight',
               'MSDilate.conv1.0.weight', 'MSDilate.convi.weight', 'VggExtract.RGB_mean',
               'VggExtract.model.features.0.weight']   # the root's own cases
    assert [port_remaps.remap_dfdnet(k) for k in samples] == [root.remap_dfdnet(k)
                                                              for k in samples]
    torch.save(official, tmp_path / 'dfdnet_official.pth')
    port_convert_dfdnet.main(['--input', str(tmp_path / 'dfdnet_official.pth'),
                              '--output', str(tmp_path / 'dfdnet.pth')])
    load_strictly(net, tmp_path / 'dfdnet.pth')


@pytest.mark.parametrize('kind', ['file', 'folder'])
def test_publish_models_matches_root(tmp_path, monkeypatch, kind):
    """The same digest and new name from both scripts, on copies of one
    checkpoint (a file, or a folder of two files)."""
    root = root_script('', 'publish_models')
    names = {}
    for tag in ('port', 'root'):
        base = tmp_path / tag
        base.mkdir()
        if kind == 'file':
            torch.save({'params': {'w': torch.arange(6.)}}, base / 'net_g.pth')
            target = base / 'net_g.pth'
        else:
            (base / 'ckpt').mkdir()
            (base / 'ckpt' / 'b.bin').write_bytes(b'second')
            (base / 'ckpt' / 'a.bin').write_bytes(b'first')
            target = base / 'ckpt'
        assert port_publish.hash_path(str(target)) == root.hash_path(str(target))
        if tag == 'port':
            port_publish.main([str(base / '*')])
        else:
            monkeypatch.setattr(sys, 'argv', ['publish_models.py', str(base / '*')])
            root.main()
        names[tag] = sorted(os.listdir(base))
    assert names['port'] == names['root'] and len(names['port']) == 1
    assert re.fullmatch(r'(net_g|ckpt)-[0-9a-f]{8}(\.pth)?', names['port'][0])


COMPLEXITY_ARCHS = [{'type': 'MSRResNet'},
                    {'type': 'SwinIR', 'embed_dim': 24, 'depths': [2, 2], 'num_heads': [2, 2],
                     'window_size': 8, 'upsampler': 'pixelshuffle', 'img_size': 16}]


@pytest.mark.parametrize('arch', COMPLEXITY_ARCHS, ids=['MSRResNet', 'SwinIR'])
def test_model_complexity_matches_jax(arch, monkeypatch):
    """At LR 16x16. Parameters: equal to the JAX script's count. FLOPs: the
    port counts matrix products and convolutions only, two per multiply-add
    over every output position; XLA counts also the elementwise work and
    leaves out the taps on a convolution's zero padding. So MSRResNet's count
    (3x3 convolutions, a 16x16 map loses 8% of its taps to the border) may be
    up to 10% above XLA's, and SwinIR's (softmax, LayerNorm, GELU and the
    mask add, which the port does not count) up to 25% below it."""
    import basicsr4rs_tpu.archs as jax_archs
    real_build = jax_archs.build_network

    def shapes_only(opt):   # the root script's eager init takes 10 s on this host; its
        net = real_build(opt)   # count needs the parameters' shapes only
        return types.SimpleNamespace(init=functools.partial(jax.eval_shape, net.init),
                                     apply=net.apply)

    monkeypatch.setattr(jax_archs, 'build_network', shapes_only)
    root = root_script('plot', 'model_complexity')
    want_params, want_flops = root.complexity(dict(arch), 16)
    got_params, got_flops = port_complexity.complexity(dict(arch), 16)
    assert got_params == want_params
    ratio = got_flops / want_flops
    assert (1.0 <= ratio <= 1.10) if arch['type'] == 'MSRResNet' else (0.75 <= ratio <= 1.0)
    kwargs = json.dumps({k: v for k, v in arch.items() if k != 'type'})
    rows = port_complexity.main(['--lr-size', '16', f'{arch["type"]}:{kwargs}'])
    assert rows[0]['arch'] == arch['type'] and rows[0]['gflops'] > 0


def test_model_complexity_counts_every_conv():
    """MSRResNet's torch count is two multiply-adds per tap over every
    output position of its convolutions, summed from the network itself."""
    net = build_network({'type': 'MSRResNet'})
    macs = []

    def hook(module, inputs, output):
        macs.append(output.numel() * module.in_channels // module.groups
                    * module.kernel_size[0] * module.kernel_size[1])

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.zeros(1, 3, 16, 16))
    assert port_complexity.complexity({'type': 'MSRResNet'}, 16)[1] == 2 * sum(macs)

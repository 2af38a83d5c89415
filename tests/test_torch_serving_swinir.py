"""SwinIR served ahead of time: the port's kernels stay in the exported graph
as ``basicsr4rs::`` operators (K1; K10 under ``SWIN_FUSED_CONV=1``; K2 and K4
past K1's widths), the served output matches the JAX SwinIR on the same
padded batch, an export leaves the live network's caches real and its bits
unchanged, a fresh process serves an artifact without the port's networks,
and ``scripts/export_serving.py`` writes what ``ServingModel`` serves.
Float32 on the CPU, where every kernel op runs its plain version."""

import ast
import collections
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from basicsr4rs_torch.archs import swinir_arch as port_arch
from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
from basicsr4rs_torch.ops import quant as port_quant
from basicsr4rs_torch.scripts import export_serving
from basicsr4rs_torch.utils import serving as port_serving
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_tpu.archs import swinir_arch as jax_arch
from test_torch_swinir import _randomize

ROOT = __import__('pathlib').Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
K1, K2, K4, K10 = (f'basicsr4rs.{name}.default' for name in (
    'swin_block_joint_fwd', 'swin_attn_block_fwd', 'mlp_block_fwd', 'conv3x3_fwd'))


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Several test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(embed):
    """Tiny SwinIR x4 at window 8: embed 24 in two RSTBs of two blocks
    (heads of 12), or one RSTB at SwinIR-L's width 240 in 8 heads of 30,
    past K1's."""
    depths = [2, 2] if embed == 24 else [2]
    heads = 2 if embed == 24 else 8
    return dict(upscale=4, in_chans=3, img_size=16, window_size=8, img_range=1.,
                depths=depths, embed_dim=embed, num_heads=[heads] * len(depths), mlp_ratio=2.,
                upsampler='pixelshuffle', resi_connection='1conv')


_PAIRS = {}


def _pair(embed):
    """(JAX net, its random parameters, the port's net in eval), one per
    width for the module."""
    if embed not in _PAIRS:
        jnet = jax_arch.SwinIR(**_config(embed))
        params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))['params']
        params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                            np.random.RandomState(embed))
        net = port_arch.SwinIR(**_config(embed)).eval()
        net.load_state_dict(jax_params_to_state_dict(params, port_arch.SwinIR.JAX_KEY_RULES),
                            strict=True)
        _PAIRS[embed] = jnet, params, net
    return _PAIRS[embed]


def _kernel_nodes(graph):
    return collections.Counter(str(n.target) for n in graph.nodes
                               if str(n.target).startswith('basicsr4rs.'))


@pytest.mark.parametrize('embed, fused_conv, nodes', [
    (24, '0', {K1: 4}),
    (24, '1', {K1: 4, K10: 6}),     # 2 RSTB tails, conv_after_body, conv_before_upsample, 2 Upsample
    (240, '0', {K2: 2, K4: 2}),
], ids=['K1', 'K1_K10', 'K2_K4'])
def test_served_swinir_holds_the_kernels_and_matches_jax(tmp_path, monkeypatch, embed,
                                                         fused_conv, nodes):
    """The saved artifact's graph has one ``basicsr4rs::`` node for each
    kernel launch of a live forward on the route that was on at export, and
    nothing else of the blocks; a 13x11 request served from it equals the
    JAX SwinIR on the same reflect-padded 16x16 batch, cropped, to 1e-5."""
    monkeypatch.setenv('SWIN_FUSED_CONV', fused_conv)
    jnet, params, net = _pair(embed)
    port_serving.save_serving_dir(str(tmp_path), net, [(16, 16)], scale=4, pad_multiple=8,
                                  device='cpu')
    program = torch.export.load(str(tmp_path / 'net_16x16_b1.pt2'))
    assert _kernel_nodes(program.graph) == nodes
    monkeypatch.setenv('SWIN_FUSED_CONV', '0')   # read at export, not at serving
    x = np.random.RandomState(embed).rand(1, 3, 13, 11).astype(np.float32)
    got = port_serving.ServingModel(str(tmp_path), device='cpu').run(x)
    xp = jnp.pad(jnp.asarray(x.transpose(0, 2, 3, 1)), ((0, 0), (0, 3), (0, 5), (0, 0)),
                 mode='reflect')
    want = np.asarray(jax.jit(lambda p, v: jnet.apply({'params': p}, v))(params, xp))
    assert got.shape == (1, 3, 52, 44)
    np.testing.assert_allclose(got.numpy(), want[:, :52, :44].transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize('live_first', [True, False], ids=['live_then_export',
                                                          'export_then_live'])
def test_export_leaves_the_caches_real(live_first):
    """``torch.export`` traces SwinIR with fake tensors: its window index and
    shift masks made under it are never kept, so the caches hold real
    tensors only, and a live forward after the export gives the bits of one
    before it, whichever of the two filled the caches first."""
    net = _pair(24)[2]
    caches = (port_arch._relative_position_index, port_arch._shift_attn_mask)
    x = torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        before = net(x)
    for cache in caches:
        cache.cache_clear()
    with torch.no_grad():
        if live_first:
            net(x)
        program = torch.export.export(net, (x,), strict=False)
    kept = [t for cache in caches for t in cache.cache.values()]
    assert all(type(t) is torch.Tensor for t in kept)
    assert len(kept) == (2 if live_first else 0)
    with torch.no_grad():
        after = net(x)
        served = program.module()(x)
    assert torch.equal(after, before) and torch.equal(served, before)
    assert all(type(t) is torch.Tensor for cache in caches for t in cache.cache.values())


def test_a_fresh_process_serves_without_the_networks(tmp_path):
    """A new interpreter, JAX blocked, loads the artifact with ``ServingModel``
    and serves it: the port's networks, models and registries are never
    imported, the K1 nodes are in the loaded graph, and the output is the
    live network's bit for bit."""
    net = _pair(24)[2]
    port_serving.save_serving_dir(str(tmp_path / 'model'), net, [(16, 16)], scale=4,
                                  pad_multiple=8, device='cpu')
    x = np.random.RandomState(9).rand(1, 3, 16, 16).astype(np.float32)
    np.save(tmp_path / 'x.npy', x)
    code = ('import sys\n'
            'for name in ("jax", "flax", "basicsr4rs_tpu"):\n'
            '    sys.modules[name] = None\n'
            'import numpy as np\n'
            'from basicsr4rs_torch.utils.serving import ServingModel\n'
            f'sm = ServingModel({str(tmp_path / "model")!r}, device="cpu")\n'
            f'out = sm.run(np.load({str(tmp_path / "x.npy")!r}))\n'
            f'np.save({str(tmp_path / "out.npy")!r}, out.numpy())\n'
            'graph = sm._fns[0][3].graph\n'
            'print(sum(str(n.target) == "basicsr4rs.swin_block_joint_fwd.default" '
            'for n in graph.nodes))\n'
            'print(sorted(m for m in sys.modules if m.startswith("basicsr4rs_torch.")))\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    k1_nodes, modules = proc.stdout.strip().splitlines()[-2:]
    modules = ast.literal_eval(modules)
    assert int(k1_nodes) == 4 and 'basicsr4rs_torch.ops.swin_block' in modules
    assert not [m for m in modules if m.startswith((
        'basicsr4rs_torch.archs', 'basicsr4rs_torch.models', 'basicsr4rs_torch.utils.registry'))]
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / 'out.npy'), want)


def _write_opt(tmp_path, network_g, scale=4):
    path = tmp_path / 'opt.yml'
    path.write_text(yaml.safe_dump({'name': 'export', 'scale': scale, 'network_g': network_g}))
    return str(path)


def test_export_script_serves_the_weights_it_was_given(tmp_path, capsys):
    """``export_serving -opt ... --model_path net.pth --device cpu``: a
    ``params`` file of SwinIR's weights goes into the artifact, which serves
    a 16x16 request as the live network, bit for bit; the manifest takes the
    window as ``pad_multiple``. Without ``--device`` the script asks for the
    card and raises on a host without one."""
    net = _pair(24)[2]
    torch.save({'params': net.state_dict()}, tmp_path / 'net.pth')
    opt = _write_opt(tmp_path, dict(type='SwinIR', **_config(24)))
    args = ['-opt', opt, '--model_path', str(tmp_path / 'net.pth'), '--buckets', '16x16,24x16',
            '--out', str(tmp_path / 'model')]
    manifest = export_serving.main(args + ['--device', 'cpu'])
    assert (manifest['scale'], manifest['pad_multiple'], manifest['meta']['network']) == (
        4, 8, 'SwinIR')
    assert [(e['h'], e['w']) for e in manifest['buckets']] == [(16, 16), (24, 16)]
    assert 'RANDOM' not in capsys.readouterr().out
    x = torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        want = net(x)
    assert torch.equal(port_serving.ServingModel(str(tmp_path / 'model'), device='cpu').run(x),
                       want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            export_serving.main(args)


def test_export_script_int8_bakes_the_calibrated_scales(tmp_path, capsys):
    """``--int8 --calib batch.npy``: the scales calibrated on that batch
    (the count of sites printed) are in the artifact, which gives the live
    ``quantized_inference(net, act_scales=...)`` output bit for bit; with
    no ``--model_path`` the weights are the seed-0 draw, with a warning."""
    net_opt = dict(type='MSRResNet', num_in_ch=3, num_out_ch=3, num_feat=16, num_block=1,
                   upscale=4)
    opt = _write_opt(tmp_path, net_opt)
    calib = np.random.RandomState(12).rand(2, 3, 16, 16).astype(np.float32)
    np.save(tmp_path / 'calib.npy', calib)
    manifest = export_serving.main(['-opt', opt, '--buckets', '16x16', '--batch', '2',
                                    '--int8', '--calib', str(tmp_path / 'calib.npy'),
                                    '--out', str(tmp_path / 'model'), '--device', 'cpu'])
    assert manifest['quant'] == 'int8-static'
    out = capsys.readouterr().out
    torch.manual_seed(0)
    net = MSRResNet(**{k: v for k, v in net_opt.items() if k != 'type'}).eval()
    with torch.no_grad():
        scales = port_quant.calibrate_act_scales(net, net, [torch.from_numpy(calib)])
        with port_quant.quantized_inference(net, act_scales=scales):
            want = net(torch.from_numpy(calib[:1]))
    assert 'RANDOM weights' in out and f'calibrated {len(scales)} conv sites' in out
    got = port_serving.ServingModel(str(tmp_path / 'model'), device='cpu').run(calib[:1])
    assert torch.equal(got, want)
    assert json.loads((tmp_path / 'model' / 'manifest.json').read_text()) == manifest

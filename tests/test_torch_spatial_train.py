"""The ``spatial`` mesh axis of the port on two gloo ranks (one torchrun of
``tests/torch_dist_worker.py``, job kind ``spatial``): each image's rows
split into two bands, one a rank, the bands joined by halo rows and the
shifted windows' roll (``basicsr4rs_torch/parallel/halo.py``).

* SwinIR (one RSTB of a plain and a shifted block, window 4, LQ 16x16: a
  band holds two window rows, and the shift mask's non-zero rows fall on the
  last band) and MSRResNet x4 (its bilinear skip included), forward and
  gradients in eval and in train mode, against the JAX network on the
  ``(data 4, spatial 2)`` mesh of the eight CPU devices of
  ``tests/conftest.py``, as ``tests/test_parallel_mesh.py`` builds it;
* SwinIR with ``ape``, ``3conv``, ``nearest+conv`` and ``fused_attn: false``
  against the port's own one-process forward in float64 (the JAX SwinIR's
  embedding takes its size from the init input);
* three ``SwinIRModel`` steps of SGD on two ranks at a global batch of 4
  against the JAX ``SwinIRModel`` with ``parallel: {data: 4, spatial: 2}``
  (at a rate of 0.5, so that the steps move the weights by far more than
  the tolerance), then a validation of an image that splits into bands of
  whole window rows and one that runs whole on both ranks, against one port
  process's forward of the same weights;
* SwinIR and MSRResNet under ``quantized_inference`` on two bands, dynamic
  scales and static ones calibrated on the bands, against the same int8
  forward of the whole map in one port process, both in float64; the
  model's validation under ``val.quant_int8: static`` on the same bands;
* ``basicsr4rs_torch.train``'s pipeline (``--launcher pytorch``, the
  config's ``parallel: {data: 1, spatial: 2}``, loader threads, DropPath,
  random crops and flips) for two SGD steps and a validation on two ranks,
  against the same pipeline in one port process without ``parallel``;
* a control: the same runs with each band alone (zero halos, a local roll,
  the band's own mask) must miss the JAX results by more than the
  tolerance, which shows that the checks see the exchange.

Tolerances, as ``test_torch_dist_train.py`` states them: one port process
against two ranks, float32 sums in another order (``F32_ROUNDING``, atol
1e-6 + rtol 1e-5, on forwards of the same weights; the pipeline's losses
rtol 1e-4, its parameters after the steps ``JAX_PARAMS`` and its
validation outputs, of weights that differ by that much, atol 1e-5 + rtol
1e-4); the port against JAX, losses rtol 5e-4 atol 5e-5 and parameters
atol 1e-5 + rtol 1e-3 a entry (``JAX_PARAMS``); gradients of the networks
atol 1e-5 of the tensor's largest entry + rtol 1e-3 (``JAX_GRADS``). The
int8 forwards run in float64, where the two routes round no activation to
another int8 level; the model's int8 validation, in float32, is held to
its float validation within the int8 error (``INT8_ERROR``)."""

import json
from concurrent.futures import ThreadPoolExecutor
from os import path as osp
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from basicsr4rs_torch.archs import build_network as port_build_network
from basicsr4rs_torch.archs.swinir_arch import SwinIR
from basicsr4rs_torch.metrics import calculate_psnr
from basicsr4rs_torch.ops.quant import calibrate_act_scales, quantized_inference
from basicsr4rs_torch.utils.img_util import tensor2img
from basicsr4rs_torch.utils.jax_convert import jax_params_to_state_dict
from basicsr4rs_torch.utils.options import yaml_load
from basicsr4rs_tpu.archs import build_network as jax_build_network
from basicsr4rs_tpu.models import build_model as jax_build_model
from basicsr4rs_tpu.models import sr_model as jax_sr_model
from basicsr4rs_tpu.parallel.mesh import create_mesh as jax_create_mesh
from basicsr4rs_tpu.parallel.mesh import replicate as jax_replicate

from test_torch_swinir import _randomize
from test_torch_swinir_train import grads_to_state_dict
from torch_dist_worker import spatial_pipeline, torchrun

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
CONFIG = osp.join(REPO, 'options', 'train', 'SwinIR', 'train_SwinIR_M_x4_synthetic.yml')
F32_ROUNDING = dict(atol=1e-6, rtol=1e-5)
JAX_LOSSES = dict(rtol=5e-4, atol=5e-5)
JAX_PARAMS = dict(atol=1e-5, rtol=1e-3)
JAX_GRADS = dict(atol=1e-5, rtol=1e-3)   # atol of the tensor's largest entry
SPATIAL, BATCH, LQ, STEPS, LR, EMA = 2, 4, 16, 3, 0.5, 0.9
SWINIR = dict(type='SwinIR', img_size=LQ, in_chans=3, embed_dim=12, depths=[2], num_heads=[2],
              window_size=4, mlp_ratio=2., upscale=2, upsampler='pixelshuffle',
              resi_connection='1conv', drop_path_rate=0.)
MSRRESNET = dict(type='MSRResNet', num_in_ch=3, num_out_ch=3, num_feat=8, num_block=2, upscale=4)
OPTIONS = dict(SWINIR, embed_dim=8, ape=True, resi_connection='3conv', upsampler='nearest+conv',
               upscale=4, fused_attn=False)
MODEL_NET = dict(SWINIR, upscale=4, embed_dim=12)
MODES = ('eval', 'train')
INT8_MODES = ('dynamic', 'static')
INT8_ERROR = dict(atol=5e-2, rtol=0.)
# widths at which most convolutions are int8 sites (16 channels or more)
INT8_NETS = {'SwinIR': dict(SWINIR, embed_dim=16),
             'MSRResNet': dict(MSRRESNET, num_feat=16)}
PIPELINE_STEPS = 2


def jax_net_case(arch, seed, root):
    """The JAX network ``arch`` with random parameters, its weights for the
    port, its inputs, and its loss ``sum(out * v)``'s value, output, input
    and parameter gradients on the (4, 2) mesh in both modes."""
    cfg = {k: v for k, v in arch.items() if k != 'type'}
    net = jax_build_network(dict(arch))
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, LQ, LQ, 3).astype(np.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))['params']
    params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)), rng)
    scale = cfg['upscale']
    v = (rng.randn(BATCH, LQ * scale, LQ * scale, 3) / (BATCH * LQ * LQ)).astype(np.float32)
    rules = getattr(type(port_build_network(dict(arch))), 'JAX_KEY_RULES', ())
    torch.save(jax_params_to_state_dict(params, rules), root / f'{arch["type"]}.pth')
    torch.save({'x': torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                'v': torch.from_numpy(v.transpose(0, 3, 1, 2).copy())},
               root / f'{arch["type"]}_inputs.pt')
    mesh = jax_create_mesh({'parallel': {'data': BATCH, 'spatial': SPATIAL}})
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P('data', 'spatial')))
    ps = jax_replicate(params, mesh)
    want = {}
    for mode in MODES:
        def loss(p, xx):
            kw = {'deterministic': mode == 'eval'} if arch['type'] == 'SwinIR' else {}
            if mode == 'train' and arch['type'] == 'SwinIR':
                kw['rngs'] = {'dropout': jax.random.PRNGKey(0)}
            out = net.apply({'params': p}, xx, **kw)
            return (out * jnp.asarray(v)).sum(), out
        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            ps, xs)
        tree = jax.tree_util.tree_map(np.array, jax.device_get(gp))
        want[mode] = {'out': np.asarray(out).transpose(0, 3, 1, 2),
                      'dx': np.asarray(gx).transpose(0, 3, 1, 2),
                      'grads': jax_params_to_state_dict(tree, rules)}
    return want


def model_opt(root, parallel=None):
    """The synthetic SwinIR-M x4 training config cut to size: SGD, the EMA
    at ``EMA``, no DropPath, one 4x4-window RSTB at width 12, and
    ``parallel`` where given."""
    opt = json.loads(json.dumps(yaml_load(CONFIG)))
    opt.update(num_gpu=0, is_train=True, dist=False, rank=0, world_size=1, manual_seed=0)
    opt['network_g'] = dict(MODEL_NET)
    opt['path'] = {'pretrain_network_g': str(root / 'init.pth'), 'strict_load_g': True}
    opt['train'].update(ema_decay=EMA, optim_g={'type': 'SGD', 'lr': LR},
                        scheduler={'type': 'MultiStepLR', 'milestones': [100], 'gamma': 0.5})
    opt['val'] = {'metrics': {'psnr': {'type': 'calculate_psnr', 'crop_border': 2,
                                       'test_y_channel': False}}}
    opt.pop('datasets')
    if parallel:
        opt['parallel'] = parallel
    return opt


def write_model_inputs(root):
    """The init ``.pth``, 3 global batches of 4 (LQ 16x16, GT 64x64) and two
    validation items: LQ 16x16 (bands of two window rows) and 12x12 (12 rows
    do not split into bands of whole 4-row windows: both ranks run it whole)."""
    init = SwinIR(**{k: v for k, v in MODEL_NET.items() if k != 'type'},
                  generator=torch.Generator().manual_seed(4))
    torch.save({'params': init.state_dict()}, root / 'init.pth')
    gen = torch.Generator().manual_seed(5)
    batches = [{'lq': torch.rand(BATCH, 3, LQ, LQ, generator=gen),
                'gt': torch.rand(BATCH, 3, 4 * LQ, 4 * LQ, generator=gen)} for _ in range(STEPS)]
    torch.save(batches, root / 'batches.pt')
    val = [{'lq': torch.rand(1, 3, size, size, generator=gen),
            'gt': torch.rand(1, 3, 4 * size, 4 * size, generator=gen), 'lq_path': [f'{i}.png']}
           for i, size in enumerate((LQ, 12))]
    torch.save([{k: v[0] for k, v in item.items()} for item in val], root / 'val.pt')
    return batches


def jax_model_steps(root, batches):
    """The JAX ``SwinIRModel`` on the (4, 2) mesh fed the same global
    batches: its losses, parameters and EMA under the port's keys."""
    opt = model_opt(root, {'data': BATCH, 'spatial': SPATIAL})
    opt.pop('val')
    with mock.patch.object(jax_sr_model, 'jit_init', jax.jit):
        model = jax_build_model(opt)
    losses = []
    for step, batch in enumerate(batches, 1):
        model.feed_data({k: v.numpy().transpose(0, 2, 3, 1) for k, v in batch.items()})
        model.optimize_parameters(step)
        losses.append(model.get_current_log()['l_pix'])
    return {'losses': losses, 'params': grads_to_state_dict(model.state.params),
            'ema': grads_to_state_dict(model.state.ema_params)}


def port_options_forward(root):
    """The options network in one process, both modes, in float64 (a
    leaky-ReLU's derivative jumps at 0, where float32 rounding on two routes
    can put an entry on either side): output, input and parameter gradients
    of ``sum(out * v)``."""
    net = SwinIR(**{k: v for k, v in OPTIONS.items() if k != 'type'},
                 generator=torch.Generator().manual_seed(6)).double()
    torch.save(net.state_dict(), root / 'options.pth')
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(BATCH, 3, LQ, LQ, generator=gen, dtype=torch.float64)
    v = torch.randn(BATCH, 3, 4 * LQ, 4 * LQ, generator=gen, dtype=torch.float64) / x.numel()
    torch.save({'x': x, 'v': v}, root / 'options_inputs.pt')
    want = {}
    for mode in MODES:
        net.train(mode == 'train')
        net.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_(True)
        out = net(xg)
        (out * v).sum().backward()
        want[mode] = {'out': out.detach(), 'dx': xg.grad,
                      'grads': {k: p.grad.clone() for k, p in net.named_parameters()}}
    return want


def int8_inputs(root):
    """The int8 networks' weights (from seeds, every convolution at unit
    variance, so that the body's int8 error shows beside the bilinear
    skip) and input, float64, its
    second band 4x the first so that the bands' own absmax differ from the
    map's; each network's int8 forward of the whole map in one process."""
    gen = torch.Generator().manual_seed(8)
    x = torch.rand(1, 3, LQ, LQ, generator=gen, dtype=torch.float64)
    x[:, :, LQ // 2:] *= 4
    torch.save({'x': x}, root / 'int8_inputs.pt')
    want = {}
    for label, arch in INT8_NETS.items():
        torch.manual_seed(8)
        net = port_build_network(dict(arch)).double().eval()
        with torch.no_grad():   # unit-variance convolutions (MSRResNet starts at a tenth)
            for m in net.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0., m.weight[0].numel() ** -0.5)
        torch.save(net.state_dict(), root / f'int8_{label}.pth')
        want[label] = {}
        with torch.no_grad():
            for mode in INT8_MODES:
                scales = calibrate_act_scales(net, net, [x]) if mode == 'static' else None
                with quantized_inference(net, act_scales=scales):
                    want[label][mode] = net(x)
    return want


def write_pipeline_inputs(root):
    """Eight GT 128x128 / LQ 32x32 pairs (the crops at ``gt_size`` 64 are
    random draws) and one validation pair of LQ 16x16, and the pipeline's
    two configs (the SwinIR file at ``MODEL_NET`` with DropPath, SGD, the
    MSE loss): on two ranks with ``parallel: {data: 1, spatial: 2}`` and
    loader threads, and in one process without either."""
    import cv2
    import yaml
    rng = np.random.RandomState(9)
    for sub, count, size in (('train', 8, 128), ('val', 1, 4 * LQ)):
        for kind, scale in (('GT', 1), ('LQ', 4)):
            (root / 'data' / sub / kind).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            gt = (rng.rand(size, size, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / 'data' / sub / 'GT' / f'{i}.png'), gt)
            cv2.imwrite(str(root / 'data' / sub / 'LQ' / f'{i}.png'),
                        cv2.resize(gt, (size // 4, size // 4), interpolation=cv2.INTER_AREA))
    paths = {}
    for label, parallel, workers in (('ranks', {'data': 1, 'spatial': SPATIAL}, 2),
                                     ('one', None, 0)):
        opt = json.loads(json.dumps(yaml_load(CONFIG)))
        opt.update(name=f'spatial_pipeline_{label}', num_gpu=0, manual_seed=0,
                   dist_params={'backend': 'gloo'}, network_g=dict(MODEL_NET, drop_path_rate=0.1))
        opt['datasets']['train'].update(
            dataroot_gt=str(root / 'data/train/GT'), dataroot_lq=str(root / 'data/train/LQ'),
            gt_size=4 * LQ, batch_size_per_gpu=BATCH, num_worker_per_gpu=workers)
        opt['datasets']['val'].update(dataroot_gt=str(root / 'data/val/GT'),
                                      dataroot_lq=str(root / 'data/val/LQ'))
        opt['path'].update(pretrain_network_g=str(root / 'init.pth'))
        # MSE for the file's L1: L1's gradient is the sign of out - gt, which
        # float32 rounding on the two routes flips where they nearly meet
        opt['train'].update(ema_decay=EMA, total_iter=PIPELINE_STEPS,
                            optim_g={'type': 'SGD', 'lr': LR}, scheduler={'type': 'ConstantLR'},
                            pixel_opt={'type': 'MSELoss', 'loss_weight': 1.0, 'reduction': 'mean'})
        opt['val'].update(val_freq=1000, metrics={'psnr': {
            'type': 'calculate_psnr', 'crop_border': 2, 'test_y_channel': False}})
        opt['logger'].update(save_checkpoint_freq=PIPELINE_STEPS)
        if parallel:
            opt['parallel'] = parallel
        paths[label] = root / f'pipeline_{label}.yml'
        paths[label].write_text(yaml.safe_dump(opt, sort_keys=False))
    return paths


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """One torchrun of two ranks (the spatial runs, then the controls) in a
    thread, while this process computes the JAX side and the port's one
    process."""
    root = tmp_path_factory.mktemp('spatial')
    want = {'SwinIR': jax_net_case(SWINIR, 0, root), 'MSRResNet': jax_net_case(MSRRESNET, 1, root)}
    want['options'] = port_options_forward(root)
    batches = write_model_inputs(root)
    opt = model_opt(root, {'data': 1, 'spatial': SPATIAL})
    nets = [{'label': label, 'arch': arch, 'weights': str(root / f'{arch["type"]}.pth'),
             'inputs': str(root / f'{arch["type"]}_inputs.pt')}
            for label, arch in (('SwinIR', SWINIR), ('MSRResNet', MSRRESNET))]
    options = {'label': 'options', 'arch': OPTIONS, 'weights': str(root / 'options.pth'),
               'inputs': str(root / 'options_inputs.pt'), 'float64': True}
    model = {'opt': opt, 'batches': str(root / 'batches.pt'), 'val': str(root / 'val.pt')}
    want['int8'] = int8_inputs(root)
    int8 = [{'label': label, 'arch': arch, 'weights': str(root / f'int8_{label}.pth'),
             'inputs': str(root / 'int8_inputs.pt'), 'modes': list(INT8_MODES)}
            for label, arch in INT8_NETS.items()]
    pipeline = write_pipeline_inputs(root)
    pipelines = [{'label': 'swinir', 'root': str(root),
                  'argv': ['-opt', str(pipeline['ranks']), '--launcher', 'pytorch']}]
    jobs = [{'kind': 'spatial', 'name': 'spatial', 'spatial': SPATIAL, 'nets': nets + [options],
             'model': model, 'int8': int8, 'pipelines': pipelines},
            {'kind': 'spatial', 'name': 'control', 'spatial': SPATIAL, 'nets': nets,
             'model': model, 'control': True}]
    (root / 'jobs.json').write_text(json.dumps(jobs))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(torchrun, 2, 'tests/torch_dist_worker.py', str(root),
                            str(root / 'jobs.json'))
        want['jax_model'] = jax_model_steps(root, batches)
        want['pipeline'] = spatial_pipeline(['-opt', str(pipeline['one'])], str(root))
        ranks.result()
    got = {name: torch.load(root / f'{name}.pt', weights_only=False)
           for name in ('spatial', 'control')}
    got['root'] = root
    return got, want


def grads_close(got, want):
    """Whether every gradient tensor agrees within ``JAX_GRADS``."""
    for key, value in want.items():
        v = torch.as_tensor(np.array(value))
        tol = JAX_GRADS['atol'] * max(1., float(v.abs().max())) + JAX_GRADS['rtol'] * v.abs()
        if not bool(((got[key] - v).abs() <= tol).all()):
            return False
    return True


def net_misses(got, want):
    """What of a network's run misses the JAX result: output, input
    gradient, parameter gradients."""
    misses = []
    for mode in MODES:
        g, w = got[mode], want[mode]
        if not np.allclose(g['out'].numpy(), w['out'], atol=1e-5, rtol=1e-4):
            misses.append(f'{mode} out')
        if not grads_close({'x': g['dx']}, {'x': w['dx']}):
            misses.append(f'{mode} dx')
        if g['grads'].keys() != w['grads'].keys() or not grads_close(g['grads'], w['grads']):
            misses.append(f'{mode} grads')
    return misses


@pytest.mark.parametrize('label', ['SwinIR', 'MSRResNet'])
def test_bands_match_the_jax_mesh(runs, label):
    """Output (atol 1e-5 + rtol 1e-4), input and parameter gradients
    (``JAX_GRADS``) of two bands against the JAX network on the (4, 2)
    mesh, in eval (SwinIR: K1's route) and train mode (K2 to K5's)."""
    got, want = runs
    assert net_misses(got['spatial']['nets'][label], want[label]) == []


@pytest.mark.parametrize('label', ['SwinIR', 'MSRResNet'])
def test_bands_alone_miss_the_jax_mesh(runs, label):
    """The control: each band alone misses every output and gradient."""
    got, want = runs
    assert set(net_misses(got['control']['nets'][label], want[label])) >= {
        f'{mode} {what}' for mode in MODES for what in ('out', 'grads')}


def test_swinir_options_on_bands_match_one_process(runs):
    """``ape`` (the band's tokens), ``3conv``, ``nearest+conv`` and the
    unfused chain (``fused_attn: false``) on two bands against one port
    process, both in float64: ``F32_ROUNDING`` on the output, ``JAX_GRADS``
    on the gradients."""
    got, want = runs
    for mode in MODES:
        g, w = got['spatial']['nets']['options'][mode], want['options'][mode]
        torch.testing.assert_close(g['out'], w['out'], **F32_ROUNDING)
        assert grads_close({'x': g['dx'], **g['grads']}, {'x': w['dx'], **w['grads']}), mode


def test_model_steps_match_the_jax_mesh(runs):
    """Three SGD steps of ``SwinIRModel`` on two bands at the global batch
    against the JAX ``SwinIRModel`` on ``parallel: {data: 4, spatial: 2}``:
    losses (``JAX_LOSSES``), parameters and EMA (``JAX_PARAMS``); each rank
    trained on 8 of the 16 LQ rows, without DDP, and holds the same weights."""
    got, want = runs
    model, jax_model = got['spatial']['model'], want['jax_model']
    assert model['net'] == 'SwinIR' and model['same_on_ranks'] and model['lq_rows'] == LQ // 2
    np.testing.assert_allclose([s['l_pix'] for s in model['losses']], jax_model['losses'],
                               **JAX_LOSSES)
    for key in ('params', 'ema'):
        for name, value in jax_model[key].items():
            np.testing.assert_allclose(model[key][name].numpy(), value.numpy(), **JAX_PARAMS,
                                       err_msg=f'{key} {name}')


def test_validation_on_bands_matches_one_process(runs, tmp_path):
    """The validation after the steps, on the two ranks' EMA: the 16x16
    image on bands gathered by ``gather_rows``, the 12x12 one whole on both
    ranks, against one port process's forward of the same EMA weights
    (``F32_ROUNDING``), and the merged PSNR against theirs."""
    got, _ = runs
    model = got['spatial']['model']
    net = SwinIR(**{k: v for k, v in MODEL_NET.items() if k != 'type'}).eval()
    net.load_state_dict(model['ema'])
    items = torch.load(got['root'] / 'val.pt', weights_only=False)
    assert [tuple(o.shape) for o in model['outputs']] == [(1, 3, 64, 64), (1, 3, 48, 48)]
    assert model['on_bands'] == [True, False]
    psnrs = []
    with torch.no_grad():
        for item, out in zip(items, model['outputs']):
            want = net(item['lq'][None])
            torch.testing.assert_close(out, want, **F32_ROUNDING)
            psnrs.append(calculate_psnr(tensor2img(want), tensor2img(item['gt'][None]),
                                        crop_border=2))
    assert model['metrics'] == {'psnr': pytest.approx(float(np.mean(psnrs)), rel=1e-6)}


def test_model_with_bands_alone_misses_the_jax_mesh(runs):
    """The control: the same steps with each band alone miss the JAX
    parameters by more than ``JAX_PARAMS``."""
    got, want = runs
    model, jax_model = got['control']['model'], want['jax_model']
    missed = [name for name, value in jax_model['params'].items()
              if not np.allclose(model['params'][name].numpy(), value.numpy(), **JAX_PARAMS)]
    assert missed



@pytest.mark.parametrize('label', list(INT8_NETS))
@pytest.mark.parametrize('mode', INT8_MODES)
def test_int8_on_bands_matches_the_whole_map(runs, label, mode):
    """W8A8 on two bands (the halo rows through the int8 convolution, each
    activation's absmax the map's) against the whole map's int8 forward in
    one process, float64: ``F32_ROUNDING``. The second band is 4x the
    first, so a band's own absmax would miss."""
    got, want = runs
    torch.testing.assert_close(got['spatial']['int8'][label][mode], want['int8'][label][mode],
                               **F32_ROUNDING)


def test_model_int8_validation_runs_on_bands(runs):
    """``val.quant_int8: static`` (scales calibrated on the first image's
    bands): the 16x16 image on bands, the 12x12 one whole, each output
    within ``INT8_ERROR`` of the float validation's."""
    got, _ = runs
    model = got['spatial']['model']
    assert model['int8_on_bands'] == [True, False]
    for out, ref in zip(model['int8_outputs'], model['outputs']):
        assert not torch.equal(out, ref)
        torch.testing.assert_close(out, ref, **INT8_ERROR)


def test_train_pipeline_on_bands_matches_one_process(runs):
    """``python -m basicsr4rs_torch.train --launcher pytorch`` with
    ``parallel: {data: 1, spatial: 2}``: each rank steps on 8 of the 16 LQ
    rows of the same crops and flips, without DDP; the losses, the
    checkpoint's parameters and the merged validation against one process
    of the same config without ``parallel``."""
    got, want = runs
    two, one = got['spatial']['pipelines']['swinir'], want['pipeline']
    assert two['net'] == one['net'] == 'SwinIR'
    assert [s['lq_rows'] for s in two['steps']] == [LQ // 2] * PIPELINE_STEPS
    assert [s['lq_rows'] for s in one['steps']] == [LQ] * PIPELINE_STEPS
    np.testing.assert_allclose([s['l_pix'] for s in two['steps']],
                               [s['l_pix'] for s in one['steps']], rtol=1e-4)
    pth = f'net_g_{PIPELINE_STEPS}.pth'
    start = torch.load(got['root'] / 'init.pth', weights_only=True)['params']
    params = {label: torch.load(got['root'] / 'experiments' / f'spatial_pipeline_{label}' /
                                'models' / pth, weights_only=True)['params']
              for label in ('ranks', 'one')}
    assert any(not torch.equal(v, start[k]) for k, v in params['one'].items())
    for name, value in params['one'].items():
        np.testing.assert_allclose(params['ranks'][name].numpy(), value.numpy(), **JAX_PARAMS,
                                   err_msg=name)
    assert two['on_bands'] == [True] and one['on_bands'] == [False]
    torch.testing.assert_close(two['outputs'][0], one['outputs'][0], atol=1e-5, rtol=1e-4)
    assert two['metrics'] == {'psnr': pytest.approx(one['metrics']['psnr'], rel=1e-4)}

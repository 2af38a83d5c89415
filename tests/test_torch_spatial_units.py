"""The port's ``spatial`` mesh axis piece by piece, in this process: the grid
of world ranks, ``shard_batch``'s bands of 4-D and 5-D batches and its
refusal of an H that does not divide, the shift mask cut to a band's window
rows, every route of the Swin block on a band with that mask (K1, K2 + K4
with K3 + K5's gradients, K11, the unfused chain) against the same route on
the whole map, DropPath's draws within a spatial group, and the networks,
losses and model classes without a spatial route refusing to build. The
runs on two ranks are in ``test_torch_spatial_train.py``.

Tolerance of a band against the whole map: the same windows through the
same plain versions, so float32 sums of the same terms (``F32_ROUNDING`` of
``test_torch_dist_train.py``, atol 1e-6 + rtol 1e-5), and the summed
parameter gradients of the bands against the whole map's atol 1e-5 of the
tensor's largest entry + rtol 1e-3 (``JAX_GRADS`` of
``test_torch_spatial_train.py``)."""

import json
from os import path as osp
from unittest import mock

import pytest
import torch

from basicsr4rs_torch.archs import swinir_arch
from basicsr4rs_torch.archs.swinir_arch import SwinTransformerBlock, shift_mask
from basicsr4rs_torch.models import base_model
from basicsr4rs_torch.models import build_model
from basicsr4rs_torch.ops.mlp_block import fused_mlp_block
from basicsr4rs_torch.ops.swin_block import (fused_swin_attn_block, fused_swin_block_full,
                                             swin_block_full_int8)
from basicsr4rs_torch.parallel import Grid, create_mesh, halo_rows, rank_grid, roll_rows, \
    shard_batch, spatial_scope
from basicsr4rs_torch.parallel.halo import SpatialShard, band_of
from basicsr4rs_torch.utils.options import yaml_load

REPO = osp.abspath(osp.join(osp.dirname(__file__), '..'))
CONFIG = osp.join(REPO, 'options', 'train', 'SwinIR', 'train_SwinIR_M_x4_synthetic.yml')
F32_ROUNDING = dict(atol=1e-6, rtol=1e-5)
WS, SHIFT, C, HEADS, H, W = 4, 2, 16, 2, 16, 8


@pytest.mark.parametrize('parallel, world_size, want', [
    ({'spatial': 2}, 2, [(0, 0), (0, 1)]),
    ({'data': 2, 'spatial': 2}, 4, [(0, 0), (0, 1), (1, 0), (1, 1)]),
    ({'spatial': 4}, 4, [(0, 0), (0, 1), (0, 2), (0, 3)]),
    ({'data': 3, 'spatial': 1}, 3, [(0, 0), (1, 0), (2, 0)])])
def test_world_rank_sits_at_divmod_by_spatial(parallel, world_size, want):
    """Row-major, as the JAX ``dev_array.reshape(data, spatial)``."""
    data, spatial = create_mesh({'parallel': parallel}, world_size)
    grids = [rank_grid({'parallel': parallel}, r, world_size) for r in range(world_size)]
    assert [(g.data_rank, g.spatial_rank) for g in grids] == want
    assert all((g.data, g.spatial) == (data, spatial) for g in grids)


def test_shard_batch_keeps_the_band_of_4d_and_5d_batches():
    """Dim 2 of NCHW and dim 3 of (B, T, C, H, W); the GT band is the LQ
    band's rows times the scale; paths and lower ranks kept whole."""
    lq = torch.arange(2 * 3 * 8 * 5.).view(2, 3, 8, 5)
    gt = torch.arange(2 * 3 * 32 * 20.).view(2, 3, 32, 20)
    clip = torch.arange(2 * 3 * 3 * 8 * 5.).view(2, 3, 3, 8, 5)
    batch = {'lq': lq, 'gt': gt, 'clip': clip, 'idx': torch.arange(2), 'lq_path': ['a', 'b']}
    for r in range(2):
        out = shard_batch(batch, torch.device('cpu'), spatial_sharded=True, grid=Grid(1, 2, 0, r))
        assert torch.equal(out['lq'], lq[:, :, 4 * r:4 * r + 4])
        assert torch.equal(out['gt'], gt[:, :, 16 * r:16 * r + 16])
        assert torch.equal(out['clip'], clip[:, :, :, 4 * r:4 * r + 4])
        assert torch.equal(out['idx'], batch['idx']) and out['lq_path'] == ['a', 'b']
    whole = shard_batch(batch, torch.device('cpu'), spatial_sharded=False, grid=Grid(1, 2, 0, 1))
    assert torch.equal(whole['lq'], lq)


def test_shard_batch_refuses_rows_that_do_not_divide_before_moving_any():
    moved = []
    lq = torch.zeros(2, 3, 8, 5)
    gt = torch.zeros(2, 3, 30, 20)   # 30 rows, 4 bands
    with mock.patch.object(torch.Tensor, 'to', lambda t, *a, **k: moved.append(t) or t), \
            pytest.raises(ValueError, match='30 rows'):
        shard_batch({'lq': lq, 'gt': gt}, torch.device('cpu'), spatial_sharded=True,
                    grid=Grid(1, 4, 0, 0))
    assert moved == []


def test_halo_and_roll_without_a_scope_are_the_plain_operations():
    x = torch.randn(2, 3, 6, 5)
    assert torch.equal(halo_rows(x, 1, 2), torch.nn.functional.pad(x, (0, 0, 1, 2)))
    assert torch.equal(roll_rows(x, -2), torch.roll(x, -2, 2))
    t = x.permute(0, 2, 3, 1)
    assert torch.equal(roll_rows(t, 3, dim=1), torch.roll(t, 3, 1))


def band_scope(index, bands=2):
    """A scope of band ``index`` of ``bands`` (no group: nothing here exchanges)."""
    return spatial_scope(SpatialShard(None, tuple(range(bands)), index))


@pytest.mark.parametrize('bands', [2, 4])
def test_shift_mask_on_a_band_is_the_whole_maps_window_rows(bands):
    """The whole map's mask sliced by global window row (``bias_spec =
    P('spatial')``), not the band's own: only the last band holds the
    non-zero rows of the map's last window row."""
    whole = swinir_arch._shift_attn_mask(H, W, WS, SHIFT, torch.device('cpu'))
    per_band = (H // bands // WS) * (W // WS)
    for i in range(bands):
        with band_scope(i, bands):
            got = shift_mask(H // bands, W, WS, SHIFT, torch.device('cpu'))
        assert torch.equal(got, whole[i * per_band:(i + 1) * per_band])
    own = swinir_arch._shift_attn_mask(H // bands, W, WS, SHIFT, torch.device('cpu'))
    assert not torch.equal(own, whole[:per_band])   # the band's own mask is another


@pytest.fixture(scope='module')
def block():
    """A shifted Swin block with every parameter random, its rolled input
    map and the whole map's mask."""
    torch.manual_seed(0)
    blk = SwinTransformerBlock(C, HEADS, WS, SHIFT, mlp_ratio=2.)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn_like(p) * (0.5 if p.dim() == 1 else 1 / p.shape[-1] ** 0.5))
    x = torch.roll(torch.randn(2, H, W, C), (-SHIFT, -SHIFT), (1, 2))
    return blk, x, swinir_arch._shift_attn_mask(H, W, WS, SHIFT, torch.device('cpu'))


def routes(blk):
    """Each route of the block as f(rolled map, mask) (the block's forward
    after its roll)."""
    a = blk.attn
    geometry = (WS, HEADS, a.scale)

    def attn_args(mask):
        return (blk.norm1.weight, blk.norm1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight,
                a.proj.bias, a.relative_position_bias(WS), mask)

    mlp = (blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
           blk.mlp.fc2.weight, blk.mlp.fc2.bias)
    return {
        'K1': lambda x, m: fused_swin_block_full(x, *attn_args(m), *mlp, *geometry),
        'K2+K4': lambda x, m: fused_mlp_block(fused_swin_attn_block(
            x, *attn_args(m), *geometry, add_residual=True), *mlp, add_residual=True),
        'K11': lambda x, m: swin_block_full_int8(x, *attn_args(m), *mlp, *geometry),
        'unfused': lambda x, m: x + a.windowed(blk.norm1(x), WS, m),
    }


@pytest.mark.parametrize('route', ['K1', 'K2+K4', 'K11', 'unfused'])
def test_every_block_route_takes_the_bands_map_and_mask(block, route):
    """Each band through the route with its cut of the mask gives the whole
    map's rows (``F32_ROUNDING``)."""
    blk, x, mask = block
    fn = routes(blk)[route]
    with torch.no_grad():
        whole = fn(x, mask)
        for i in range(2):
            with band_scope(i):
                m = shift_mask(H // 2, W, WS, SHIFT, x.device)
            got = fn(x[:, i * H // 2:(i + 1) * H // 2].contiguous(), m)
            torch.testing.assert_close(got, whole[:, i * H // 2:(i + 1) * H // 2],
                                       **F32_ROUNDING)


def test_training_route_gradients_of_the_bands_add_up_to_the_maps(block):
    """K3 and K5's gradients (the plain versions here): the parameters'
    gradients of the two bands summed, and each band's input gradient,
    against the whole map's."""
    blk, x, mask = block
    fn = routes(blk)['K2+K4']
    v = torch.randn_like(x)
    blk.zero_grad(set_to_none=True)
    xw = x.clone().requires_grad_(True)
    (fn(xw, mask) * v).sum().backward()
    want = {k: p.grad.clone() for k, p in blk.named_parameters() if p.grad is not None}
    blk.zero_grad(set_to_none=True)
    for i in range(2):
        rows = slice(i * H // 2, (i + 1) * H // 2)
        with band_scope(i):
            m = shift_mask(H // 2, W, WS, SHIFT, x.device)
        xb = x[:, rows].clone().requires_grad_(True)
        (fn(xb, m) * v[:, rows]).sum().backward()
        torch.testing.assert_close(xb.grad, xw.grad[:, rows], **F32_ROUNDING)
    for key, value in want.items():
        got = dict(blk.named_parameters())[key].grad
        tol = 1e-5 * max(1., float(value.abs().max())) + 1e-3 * value.abs()
        assert bool(((got - value).abs() <= tol).all()), key


def model_opt(network_g, parallel, rank, world_size, **train):
    opt = json.loads(json.dumps(yaml_load(CONFIG)))
    opt.update(num_gpu=0, is_train=True, dist=True, rank=rank, world_size=world_size,
               manual_seed=7, parallel=parallel)
    opt['network_g'] = network_g
    opt['path'] = {'pretrain_network_g': None}
    opt['train'].update(train)
    opt.pop('datasets')
    return opt


SMALL_SWINIR = dict(type='SwinIR', img_size=16, embed_dim=8, depths=[2], num_heads=[2],
                    window_size=4, mlp_ratio=2., upscale=2, upsampler='pixelshuffle',
                    drop_path_rate=0.5)


def no_groups():
    """``make_shard`` without a process group: a model builds on one rank of
    a grid here (no exchange runs)."""
    return mock.patch.object(base_model, 'make_shard',
                             lambda d, s, n: SpatialShard(None, tuple(range(n)), s))


def test_drop_path_draws_by_data_rank():
    """DropPath's generator is seeded by ``manual_seed + data_rank``: the two
    bands of a spatial group drop the same samples' paths, another data
    rank other ones."""
    parallel = {'data': 2, 'spatial': 2}
    draws = []
    with no_groups(), mock.patch.object(base_model, 'broadcast_module', lambda net: None):
        for rank in range(4):
            model = build_model(model_opt(SMALL_SWINIR, parallel, rank, 4))
            blk = model.net_g.layers[0].residual_group.blocks[1]
            draws.append(torch.cat(blk.drop_path_scales(64, torch.device('cpu'))))
            assert model.grid == Grid(2, 2, rank // 2, rank % 2)
            assert type(model.net_g).__name__ == 'SwinIR'   # no DDP under spatial
    assert torch.equal(draws[0], draws[1]) and torch.equal(draws[2], draws[3])
    assert not torch.equal(draws[0], draws[2])


@pytest.mark.parametrize('what, network_g, train', [
    ('RCAN', {'type': 'RCAN', 'num_feat': 8, 'num_block': 1, 'num_group': 1, 'upscale': 2,
              'squeeze_factor': 4}, {}),
    ('PerceptualLoss', SMALL_SWINIR, {'perceptual_opt': {
        'type': 'PerceptualLoss', 'layer_weights': {'conv1_2': 1.}, 'vgg_type': 'vgg19',
        'perceptual_weight': 1., 'style_weight': 0.}}),
    ('WeightedTVLoss', SMALL_SWINIR, {'pixel_opt': {'type': 'WeightedTVLoss'}}),
    ('L1Loss', SMALL_SWINIR, {'pixel_opt': {'type': 'L1Loss', 'reduction': 'sum'}}),
    ('SwinIR', dict(SMALL_SWINIR, drop_rate=0.1), {})])
def test_networks_and_losses_without_a_spatial_route_refuse_to_build(what, network_g, train):
    """Under ``spatial: 2``: RCAN (its channel attention would pool each band
    alone), the perceptual loss, TV, a summed pixel loss and SwinIR with
    dropout raise ``NotImplementedError`` naming ROADMAP; nothing launched."""
    opt = model_opt(dict(network_g, drop_path_rate=0.) if network_g['type'] == 'SwinIR'
                    else network_g, {'spatial': 2}, 0, 2, **train)
    if network_g['type'] == 'RCAN':
        opt['model_type'] = 'SRModel'
    with no_groups(), mock.patch.object(base_model, 'broadcast_module', lambda net: None), \
            pytest.raises(NotImplementedError, match=f'{what}.*ROADMAP'):
        build_model(opt)


@pytest.mark.parametrize('model_type', ['SRGANModel', 'SwinIRRSModel', 'VideoBaseModel'])
def test_model_classes_without_a_spatial_route_refuse_to_build(model_type):
    opt = model_opt(SMALL_SWINIR, {'spatial': 2}, 0, 2)
    opt['model_type'] = model_type
    with no_groups(), pytest.raises(NotImplementedError, match=f'{model_type}.*ROADMAP'):
        build_model(opt)


def test_band_of_needs_equal_bands():
    shard = SpatialShard(None, (0, 1, 2), 1)
    assert torch.equal(band_of(torch.arange(6.).view(1, 1, 6, 1), shard).flatten(),
                       torch.tensor([2., 3.]))
    with pytest.raises(ValueError, match='3 equal bands'):
        band_of(torch.zeros(1, 1, 7, 1), shard)

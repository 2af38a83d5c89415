"""``basicsr4rs_torch.utils.jax_convert`` for the diffusion architectures: a
parameter tree of each JAX module goes into the port's module under
BasicSR's key names (strict load), is saved as a ``.pth``, and comes back
through the JAX package's own converter, with the JAX module's
``TORCH_KEY_RULES``, as the tree it was: every path, every array, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicsr4rs_torch.archs import autoencoder_arch as port_ae
from basicsr4rs_torch.archs import unet_arch as port_unet
from basicsr4rs_torch.utils.jax_convert import (convert_array, jax_params_to_state_dict,
                                                jax_path_to_torch_key)
from basicsr4rs_tpu.archs import autoencoder_arch as jax_ae
from basicsr4rs_tpu.archs import unet_arch as jax_unet
from basicsr4rs_tpu.utils.torch_convert import load_torch_checkpoint

from test_torch_swinir import _randomize

DD = dict(ch=8, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
          in_channels=3, resolution=16, z_channels=3)
X = jnp.zeros((1, 16, 16, 3), jnp.float32)
T = jnp.zeros((1,), jnp.int32)
UNET = dict(in_channels=3, model_channels=8, out_channels=3, num_res_blocks=1,
            channel_mult=(1, 2))
ARCHS = {
    'UNetModelSwin': (jax_unet.UNetModelSwin, port_unet.UNetModelSwin,
                      dict(UNET, image_size=16, attention_resolutions=(16, 8), num_heads=2,
                           swin_embed_dim=8, window_size=4, lq_size=32, resblock_updown=True),
                      (X, T), dict(lq=jnp.zeros((1, 32, 32, 3)))),
    'UNetModel': (jax_unet.UNetModel, port_unet.UNetModel,
                  dict(UNET, image_size=16, attention_resolutions=(8,), num_heads=2,
                       num_classes=3),
                  (X, T), dict(lq=X, y=jnp.zeros((1,), jnp.int32))),
    'UNetModelConv': (jax_unet.UNetModelConv, port_unet.UNetModelConv, UNET, (X, T),
                      dict(lq=X)),
    'VQModelTorch': (jax_ae.VQModelTorch, port_ae.VQModelTorch,
                     dict(ddconfig=dict(DD, double_z=False), n_embed=16, embed_dim=3), (X,), {}),
    'AutoencoderKLTorch': (jax_ae.AutoencoderKLTorch, port_ae.AutoencoderKLTorch,
                           dict(ddconfig=dict(DD, double_z=True), embed_dim=3), (X,), {}),
}


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.mark.parametrize('name', list(ARCHS))
def test_tree_goes_into_the_port_and_comes_back_through_the_jax_converter(name, tmp_path):
    jax_cls, port_cls, cfg, args, kwargs = ARCHS[name]
    jnet = jax_cls(**cfg)
    params = jax.jit(lambda *a: jnet.init(jax.random.PRNGKey(0), *a, **kwargs))(*args)['params']
    params = _randomize(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                        np.random.RandomState(0))
    net = port_cls(**cfg)
    net.load_state_dict(jax_params_to_state_dict(params, port_cls.JAX_KEY_RULES))   # strict
    path = str(tmp_path / 'net.pth')
    torch.save({'params': net.state_dict()}, path)
    back = load_torch_checkpoint(path, 'params', rules=getattr(jax_cls, 'TORCH_KEY_RULES', None))
    want, got = dict(_flat(params)), dict(_flat(back))
    if name == 'UNetModel':
        # the JAX rules do not name the label embedding: a reference-side gap,
        # a torch checkpoint's `label_emb.weight` stays a `kernel`
        got[('label_emb', 'embedding')] = got.pop(('label_emb', 'kernel')).T
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg='.'.join(key))


def test_one_dimensional_conv_kernels_and_key_rules():
    kernel = np.arange(24, dtype=np.float32).reshape(1, 4, 6)       # (kW, I, O)
    assert convert_array('kernel', kernel).shape == (6, 4, 1)
    rules = port_unet.UNetModelSwin.JAX_KEY_RULES
    assert jax_path_to_torch_key(('input_blocks_1_1', 'blocks_0', 'mlp_fc1', 'kernel'),
                                 rules) == 'input_blocks.1.1.blocks.0.mlp.fc1.weight'
    assert jax_path_to_torch_key(('middle_block_1', 'patch_unembed_norm', 'scale'),
                                 rules) == 'middle_block.1.patch_unembed.norm.weight'
    rules = port_ae.VQModelTorch.JAX_KEY_RULES
    assert jax_path_to_torch_key(('encoder', 'down_1_block_0', 'norm1', 'scale'),
                                 rules) == 'encoder.down.1.block.0.norm1.weight'
    assert jax_path_to_torch_key(('decoder', 'mid_attn_1', 'q', 'kernel'),
                                 rules) == 'decoder.mid.attn_1.q.weight'
    assert jax_path_to_torch_key(('decoder', 'up_1_upsample_conv', 'bias'),
                                 rules) == 'decoder.up.1.upsample.conv.bias'
    assert jax_path_to_torch_key(('quantize', 'embedding'),
                                 rules) == 'quantize.embedding.weight'


@pytest.mark.parametrize('path, key', [
    (('pcd_align', 'offset_conv1_l3', 'kernel'), 'pcd_align.offset_conv1.l3.weight'),
    (('pcd_align', 'dcn_pack_l1', 'conv_offset', 'bias'), 'pcd_align.dcn_pack.l1.conv_offset.bias'),
    (('pcd_align', 'dcn_pack_l2', 'kernel'), 'pcd_align.dcn_pack.l2.weight'),
    (('pcd_align', 'feat_conv_l2', 'kernel'), 'pcd_align.feat_conv.l2.weight'),
    (('pcd_align', 'cas_dcnpack', 'kernel'), 'pcd_align.cas_dcnpack.weight'),
    (('conv_l2_1', 'kernel'), 'conv_l2_1.weight'),
    (('predeblur', 'resblock_l2_2', 'conv1', 'bias'), 'predeblur.resblock_l2_2.conv1.bias'),
    (('predeblur', 'resblock_l1_3', 'conv2', 'kernel'), 'predeblur.resblock_l1.3.conv2.weight'),
    (('predeblur', 'stride_conv_l3', 'kernel'), 'predeblur.stride_conv_l3.weight'),
    (('fusion', 'spatial_attn_l1', 'kernel'), 'fusion.spatial_attn_l1.weight'),
    (('feature_extraction_4', 'conv1', 'kernel'), 'feature_extraction.4.conv1.weight'),
])
def test_edvr_key_rules(path, key):
    from basicsr4rs_torch.archs.edvr_arch import EDVR
    assert jax_path_to_torch_key(path, EDVR.JAX_KEY_RULES) == key


@pytest.mark.parametrize('path, key', [
    (('prop_backward_1', 'deform_align', 'conv_offset_6', 'kernel'),
     'deform_align.backward_1.conv_offset.6.weight'),
    (('prop_forward_2', 'deform_align', 'kernel'), 'deform_align.forward_2.weight'),
    (('prop_forward_2', 'backbone', 'main_2_6', 'conv2', 'bias'),
     'backbone.forward_2.main.2.6.conv2.bias'),
    (('spynet', 'basic_module_3', 'basic_module_8', 'kernel'),
     'spynet.basic_module.3.basic_module.8.weight'),
    (('feat_extract', 'main_0', 'kernel'), 'feat_extract.main.0.weight'),
    (('feat_extract_4', 'main_2_0', 'conv1', 'kernel'), 'feat_extract.4.main.2.0.conv1.weight'),
    (('reconstruction', 'main_2_4', 'conv1', 'bias'), 'reconstruction.main.2.4.conv1.bias'),
])
def test_basicvsrpp_key_rules(path, key):
    from basicsr4rs_torch.archs.basicvsrpp_arch import BasicVSRPlusPlus
    assert jax_path_to_torch_key(path, BasicVSRPlusPlus.JAX_KEY_RULES) == key


def test_deformable_convolution_weight_layout():
    """The DCN weight is a plain 4-d ``kernel``: HWIO -> OIHW."""
    kernel = np.arange(3 * 3 * 4 * 6, dtype=np.float32).reshape(3, 3, 4, 6)
    weight = convert_array('kernel', kernel)
    assert weight.shape == (6, 4, 3, 3) and weight[5, 2, 1, 0] == kernel[1, 0, 2, 5]

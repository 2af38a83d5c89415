"""The port stands alone: it imports with JAX, Flax and the JAX package
blocked, and its sources name none of them."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'basicsr4rs_tpu')


def port_modules():
    """Every module of the port, by its dotted name."""
    package = ROOT / 'basicsr4rs_torch'
    names = []
    for path in sorted(package.rglob('*.py')):
        parts = path.relative_to(ROOT).with_suffix('').parts
        names.append('.'.join(parts[:-1] if parts[-1] == '__init__' else parts))
    return names


def test_port_imports_without_jax():
    """Every module of the port (the diffusion, video, serving-mode,
    alignment, CNN / GAN, recurrent-video, face, FID / taming and
    ahead-of-time serving slices' among them)
    imports with JAX and the JAX package blocked, and none of them is in
    ``sys.modules`` afterwards."""
    modules = port_modules()
    for expected in ('basicsr4rs_torch.ops.window_attention', 'basicsr4rs_torch.archs.unet_arch',
                     'basicsr4rs_torch.archs.autoencoder_arch',
                     'basicsr4rs_torch.utils.gaussian_diffusion',
                     'basicsr4rs_torch.models.srrs_model',
                     'basicsr4rs_torch.models.resshift_model', 'basicsr4rs_torch.train',
                     'basicsr4rs_torch.test', 'basicsr4rs_torch.ops.dcn',
                     'basicsr4rs_torch.archs.edvr_arch', 'basicsr4rs_torch.archs.spynet_arch',
                     'basicsr4rs_torch.archs.basicvsr_arch',
                     'basicsr4rs_torch.archs.basicvsrpp_arch',
                     'basicsr4rs_torch.data.video_test_dataset',
                     'basicsr4rs_torch.data.reds_dataset',
                     'basicsr4rs_torch.models.video_base_model',
                     'basicsr4rs_torch.models.video_recurrent_model',
                     'basicsr4rs_torch.ops.conv3x3', 'basicsr4rs_torch.ops.quant',
                     'basicsr4rs_torch.ops.tile', 'basicsr4rs_torch.archs.srresnet_arch',
                     'basicsr4rs_torch.inference.inference_swinir',
                     'basicsr4rs_torch.archs.alignae_arch',
                     'basicsr4rs_torch.archs.alignae_unet_arch',
                     'basicsr4rs_torch.archs.srcnn_arch', 'basicsr4rs_torch.losses.align_loss',
                     'basicsr4rs_torch.metrics.lpips',
                     'basicsr4rs_torch.utils.gaussian_diffusion_align',
                     'basicsr4rs_torch.models.align_single_model',
                     'basicsr4rs_torch.models.align_frozen_diff_model',
                     'basicsr4rs_torch.models.align_joint_diff_model',
                     'basicsr4rs_torch.archs.edsr_arch', 'basicsr4rs_torch.archs.rcan_arch',
                     'basicsr4rs_torch.archs.rrdbnet_arch', 'basicsr4rs_torch.archs.vgg_arch',
                     'basicsr4rs_torch.archs.discriminator_arch',
                     'basicsr4rs_torch.archs.srvgg_arch', 'basicsr4rs_torch.archs.ridnet_arch',
                     'basicsr4rs_torch.archs.ecbsr_arch', 'basicsr4rs_torch.losses.gan_loss',
                     'basicsr4rs_torch.losses.perceptual_loss',
                     'basicsr4rs_torch.models.srgan_model',
                     'basicsr4rs_torch.models.esrgan_model',
                     'basicsr4rs_torch.data.single_image_dataset',
                     'basicsr4rs_torch.inference.inference_esrgan',
                     'basicsr4rs_torch.inference.inference_ridnet',
                     'basicsr4rs_torch.archs.tof_arch', 'basicsr4rs_torch.archs.duf_arch',
                     'basicsr4rs_torch.data.vimeo90k_dataset',
                     'basicsr4rs_torch.inference.inference_basicvsr',
                     'basicsr4rs_torch.inference.inference_basicvsrpp',
                     'basicsr4rs_torch.ops.fused_act', 'basicsr4rs_torch.ops.upfirdn2d',
                     'basicsr4rs_torch.archs.stylegan2_arch',
                     'basicsr4rs_torch.archs.stylegan2_bilinear_arch',
                     'basicsr4rs_torch.data.ffhq_dataset',
                     'basicsr4rs_torch.models.stylegan2_model',
                     'basicsr4rs_torch.inference.inference_stylegan2',
                     'basicsr4rs_torch.archs.hifacegan_util',
                     'basicsr4rs_torch.archs.hifacegan_arch',
                     'basicsr4rs_torch.models.hifacegan_model',
                     'basicsr4rs_torch.archs.dfdnet_util', 'basicsr4rs_torch.archs.dfdnet_arch',
                     'basicsr4rs_torch.inference.inference_dfdnet',
                     'basicsr4rs_torch.archs.inception', 'basicsr4rs_torch.metrics.fid',
                     'basicsr4rs_torch.models.taming_model',
                     'basicsr4rs_torch.models.optimizers', 'basicsr4rs_torch.utils.flow_util',
                     'basicsr4rs_torch.utils.plot_util',
                     'basicsr4rs_torch.scripts.metrics.calculate_fid_folder',
                     'basicsr4rs_torch.scripts.metrics.calculate_fid_stats_from_datasets',
                     'basicsr4rs_torch.scripts.metrics.calculate_stylegan2_fid',
                     'basicsr4rs_torch.ops.library', 'basicsr4rs_torch.utils.serving',
                     'basicsr4rs_torch.scripts.export_serving',
                     'basicsr4rs_torch.scripts.swinir_host_time',
                     'basicsr4rs_torch.scripts.metrics.calculate_psnr_ssim',
                     'basicsr4rs_torch.scripts.metrics.calculate_niqe',
                     'basicsr4rs_torch.scripts.metrics.calculate_lpips',
                     'basicsr4rs_torch.scripts.metrics.back_projection'):
        assert expected in modules
    code = ('import importlib, sys\n'
            f'for name in {BLOCKED!r}:\n'
            '    sys.modules[name] = None\n'
            f'for name in {modules!r}:\n'
            '    importlib.import_module(name)\n'
            'from basicsr4rs_torch.ops import swin_block\n'
            'assert not any(m.split(".")[0] in {"jax", "flax", "basicsr4rs_tpu"} '
            'for m in sys.modules if sys.modules[m] is not None)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_do_not_import_jax():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|basicsr4rs_tpu)\b',
                         re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in (ROOT / 'basicsr4rs_torch').rglob('*.py')
                 if pattern.search(p.read_text())]
    offenders += [name for name in ('chip_smoke.py',)
                  if (ROOT / name).exists() and pattern.search((ROOT / name).read_text())]
    assert not offenders


@pytest.mark.parametrize('registry, name', [
    ('ARCH_REGISTRY', 'BasicVSR'), ('ARCH_REGISTRY', 'IconVSR'), ('ARCH_REGISTRY', 'TOFlow'),
    ('ARCH_REGISTRY', 'DUF'), ('DATASET_REGISTRY', 'Vimeo90KDataset'),
    ('DATASET_REGISTRY', 'Vimeo90KRecurrentDataset'),
    ('DATASET_REGISTRY', 'VideoTestVimeo90KDataset'), ('DATASET_REGISTRY', 'VideoTestDUFDataset'),
    ('MODEL_REGISTRY', 'VideoRecurrentGANModel'), ('MODEL_REGISTRY', 'VideoGANModel')])
def test_port_registers_the_recurrent_video_slice(registry, name):
    """Under the JAX package's names, once the builders have imported their
    modules."""
    import basicsr4rs_torch.archs  # noqa: F401
    import basicsr4rs_torch.data  # noqa: F401
    import basicsr4rs_torch.models  # noqa: F401
    from basicsr4rs_torch.utils import registry as port_registry
    assert getattr(port_registry, registry).get(name).__name__ == name


@pytest.mark.parametrize('registry, name', [
    ('ARCH_REGISTRY', 'StyleGAN2Generator'), ('ARCH_REGISTRY', 'StyleGAN2Discriminator'),
    ('ARCH_REGISTRY', 'StyleGAN2GeneratorBilinear'), ('ARCH_REGISTRY', 'SPADEGenerator'),
    ('ARCH_REGISTRY', 'HiFaceGAN'), ('ARCH_REGISTRY', 'HiFaceGANDiscriminator'),
    ('ARCH_REGISTRY', 'DFDNet'), ('MODEL_REGISTRY', 'StyleGAN2Model'),
    ('MODEL_REGISTRY', 'HiFaceGANModel'), ('DATASET_REGISTRY', 'FFHQDataset'),
    ('LOSS_REGISTRY', 'GANFeatLoss')])
def test_port_registers_the_face_slice(registry, name):
    """StyleGAN2, HiFaceGAN and DFDNet under the JAX package's names, in both
    packages' registries."""
    import basicsr4rs_torch.archs  # noqa: F401
    import basicsr4rs_torch.data  # noqa: F401
    import basicsr4rs_torch.losses  # noqa: F401
    import basicsr4rs_torch.models  # noqa: F401
    import basicsr4rs_tpu.archs  # noqa: F401
    import basicsr4rs_tpu.data  # noqa: F401
    import basicsr4rs_tpu.losses  # noqa: F401
    import basicsr4rs_tpu.models  # noqa: F401
    from basicsr4rs_torch.utils import registry as port_registry
    from basicsr4rs_tpu.utils import registry as jax_registry
    assert getattr(port_registry, registry).get(name).__name__ == name
    assert getattr(jax_registry, registry).get(name).__name__ == name


@pytest.mark.parametrize('registry, name', [
    ('ARCH_REGISTRY', 'InceptionV3'), ('MODEL_REGISTRY', 'TamingModel'),
    ('LOSS_REGISTRY', 'WeightedTVLoss'), ('METRIC_REGISTRY', 'calculate_psnr_pt'),
    ('METRIC_REGISTRY', 'calculate_ssim_pt'), ('METRIC_REGISTRY', 'calculate_psnr_jax'),
    ('METRIC_REGISTRY', 'calculate_ssim_jax')])
def test_port_registers_the_fid_and_taming_slice(registry, name):
    """Under the names the JAX package registers them by."""
    import basicsr4rs_torch.archs  # noqa: F401
    import basicsr4rs_torch.losses  # noqa: F401
    import basicsr4rs_torch.metrics  # noqa: F401
    import basicsr4rs_torch.models  # noqa: F401
    import basicsr4rs_tpu.archs  # noqa: F401
    import basicsr4rs_tpu.losses  # noqa: F401
    import basicsr4rs_tpu.metrics  # noqa: F401
    import basicsr4rs_tpu.models  # noqa: F401
    from basicsr4rs_torch.utils import registry as port_registry
    from basicsr4rs_tpu.utils import registry as jax_registry
    assert name in getattr(port_registry, registry)._obj_map
    assert name in getattr(jax_registry, registry)._obj_map


# published option files that name a type the port lacks: the RS LPIPS
# metric, which neither package registers
UNPORTED_OPTION_FILES = {'options/test/SRCNN/test_SRCNN_x4.yml': ['calculate_rs_lpips'],
                         'options/test/SwinIR/test_SwinIR_x4.yml': ['calculate_rs_lpips']}


def _type_names(node):
    """The ``type`` and ``model_type`` values of an option tree, outside
    ``io_backend``, the optimizers and the scheduler."""
    if isinstance(node, dict):
        for key, value in node.items():
            if key in ('io_backend', 'scheduler') or key.startswith('optim_'):
                continue
            if key in ('type', 'model_type') and isinstance(value, str):
                yield value
            else:
                yield from _type_names(value)
    elif isinstance(node, list):
        for value in node:
            yield from _type_names(value)


def test_published_option_files_name_registered_types():
    """Every published option file (not ``*_synthetic.yml``) names only
    types of the port's five registries, but the two listed: 87 of 89."""
    import yaml

    import basicsr4rs_torch.archs  # noqa: F401
    import basicsr4rs_torch.data  # noqa: F401
    import basicsr4rs_torch.losses  # noqa: F401
    import basicsr4rs_torch.metrics  # noqa: F401
    import basicsr4rs_torch.models  # noqa: F401
    from basicsr4rs_torch.utils import registry as reg
    registries = (reg.ARCH_REGISTRY, reg.DATASET_REGISTRY, reg.LOSS_REGISTRY,
                  reg.MODEL_REGISTRY, reg.METRIC_REGISTRY)

    def known(name):
        return any(name in r._obj_map for r in registries)

    files = sorted(str(p.relative_to(ROOT)) for p in (ROOT / 'options').rglob('*.yml')
                   if not p.name.endswith('_synthetic.yml'))
    missing = {}
    for path in files:
        names = sorted({n for n in _type_names(yaml.safe_load((ROOT / path).read_text()))
                        if not known(n)})
        if names:
            missing[path] = names
    assert missing == UNPORTED_OPTION_FILES
    assert (len(files), len(files) - len(missing)) == (89, 87)

"""basicsr4rs_torch — the PyTorch and CUDA port of ``basicsr4rs_tpu`` for
NVIDIA Hopper GPUs.

Same config-driven pipeline, registries and module names as the JAX
package, in torch idiom: ``nn.Module``s with BasicSR's key names and NCHW
activations, explicit devices and generators. Every Pallas kernel of the
JAX package becomes a hand-written CUDA kernel (``csrc/``), built with
nvcc at first use; its plain PyTorch version serves CPU tensors. This
package imports neither JAX nor ``basicsr4rs_tpu``.
"""

__version__ = '0.1.0'

import importlib

# the builders and helpers at the package's top level, imported on first use:
# importing a submodule (``ops``, ``utils.serving``) loads no network code
_LAZY = {'build_network': 'archs', 'build_dataloader': 'data', 'build_dataset': 'data',
         'calculate_metric': 'metrics', 'build_model': 'models',
         **dict.fromkeys(('ARCH_REGISTRY', 'DATASET_REGISTRY', 'METRIC_REGISTRY',
                          'MODEL_REGISTRY', 'get_root_logger', 'img2tensor', 'imwrite',
                          'tensor2img'), 'utils')}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f'.{_LAZY[name]}', __name__), name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')

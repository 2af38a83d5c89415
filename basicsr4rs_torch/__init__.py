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

from .archs import build_network  # noqa: F401,E402
from .data import build_dataloader, build_dataset  # noqa: F401,E402
from .metrics import calculate_metric  # noqa: F401,E402
from .models import build_model  # noqa: F401,E402
from .utils import (ARCH_REGISTRY, DATASET_REGISTRY, METRIC_REGISTRY,  # noqa: F401,E402
                    MODEL_REGISTRY, get_root_logger, img2tensor, imwrite, tensor2img)

"""BasicVSR++ x4 inference on a folder of frames (counterpart of the JAX
package's ``inference/inference_basicvsrpp.py``; reference:
inference/inference_basicvsrpp.py).

    python -m basicsr4rs_torch.inference.inference_basicvsrpp --model_path net_g.pth \
        --input datasets/REDS4/000 --output results/BasicVSRPP [--interval 15]

As ``inference_basicvsr``, for a ``BasicVSRPlusPlus`` with
``--mid_channels`` features and ``--num_blocks`` blocks; each output frame is
written as ``<name>_BasicVSRPP.png``.
"""

from __future__ import annotations

from ..archs.basicvsrpp_arch import BasicVSRPlusPlus
from .inference_basicvsr import parser, run_clip


def main(argv=None):
    p = parser('results/BasicVSRPP')
    p.add_argument('--mid_channels', type=int, default=64)
    p.add_argument('--num_blocks', type=int, default=7)
    args = p.parse_args(argv)
    run_clip(BasicVSRPlusPlus(mid_channels=args.mid_channels, num_blocks=args.num_blocks), args,
             'BasicVSRPP')


if __name__ == '__main__':
    main()

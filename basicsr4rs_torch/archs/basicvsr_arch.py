"""Blocks of the recurrent video networks (counterpart of
``basicsr4rs_tpu/archs/basicvsr_arch.py``; reference:
basicsr/archs/basicvsr_arch.py). ``ConvResidualBlocks`` is ported, for
BasicVSR++; BasicVSR and IconVSR themselves are not yet."""

from __future__ import annotations

from torch import nn

from .arch_util import ResidualBlockNoBN, make_layer


class ConvResidualBlocks(nn.Module):
    """A 3x3 convolution, LeakyReLU(0.1) and ``num_block`` residual blocks."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 64, num_block: int = 15):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(num_in_ch, num_out_ch, 3, 1, 1, bias=True),
            nn.LeakyReLU(negative_slope=0.1, inplace=False),
            make_layer(ResidualBlockNoBN, num_block, num_feat=num_out_ch))

    def forward(self, fea):
        return self.main(fea)

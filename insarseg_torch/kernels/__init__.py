"""Hand-written Hopper kernels of the int8 engines, with their plain
PyTorch versions and launch counters.

====  ==========================  =========================================
id    wrapper                      replaces (JAX package)
====  ==========================  =========================================
K1    ``conv3x3_i8``               ``models/unet_int8.py::_conv_i8``
K2    ``se_squeeze_i8`` +          ``models/unet_int8.py::_dc_i8`` SE tail
      ``se_excite_i8``
K3    ``maxpool2x2_i8``            ``models/unet_int8.py::_maxpool_i8``
K3s   ``maxpool_exit_s2d_i8``      ``models/unet_s2d.py::_maxpool_exit_s2d``
                                   on the level-1 codes (H-s2d layout)
K4a   ``sa_stats_i8``              ``models/unet_int8.py::_sa_gate_i8``:
                                   channel mean / max of the codes
K4b   ``sa_gate_i8``               ``models/unet_int8.py::_sa_gate_i8``:
                                   the gate times the codes, requantized
K5a   ``conv_i8``                  ``models/resnet_int8.py::_conv_i8`` and
                                   the residual add of ``_block_i8``
K5b   ``se_residual_i8``           ``models/resnet_int8.py::_block_i8`` SE
                                   excite + residual + ReLU + requant
K6    ``up_concat_i8``             ``models/unet_int8.py::unet_int8_apply``
                                   up path: bf16 ConvT (k2 s2, or the H-s2d
                                   up4) + bias + requant + concat
K7    ``stem_pool_i8``             ``models/resnet_int8.py::
                                   resnet_int8_apply`` stem exit: 3x3/s2
                                   max-pool + requant to NHWC codes
K8a   ``bn_stats``                 ``ops/layers.py`` conv bias add +
                                   BatchNorm train moments (the DoubleConv
                                   train epilogue)
K8b   ``bn_apply_relu``            ``ops/layers.py`` BatchNorm apply +
                                   running statistics, ``ops/blocks.py``
                                   relu
K9a   ``bn_relu_grad_stats``       their autodiff: the beta / gamma
                                   gradients
K9b   ``bn_relu_grad_apply``       their autodiff: the conv output's
                                   gradient
K10a  ``se_squeeze``               ``ops/blocks.py`` ``SELayer`` /
                                   ``SEBlock`` train squeeze: the sums
                                   over H, W (``jnp.mean``)
K10b  ``se_excite``                their rescale ``x * gate``, and for
                                   ``SEBlock`` the residual add + relu
                                   (``models/resnet.py:99``)
K11a  ``se_grad_stats``            their autodiff: the gate's cotangent
K11b  ``se_grad_apply``            their autodiff: x's gradient (and the
                                   identity's)
K12a  ``sa_pool``                  ``ops/blocks.py`` ``SpatialAttentionDC``
                                   / ``SpatialAttentionConv`` train pool:
                                   the channel mean and max (and the max's
                                   ties)
K12b  ``sa_apply``                 their rescale ``x * gate``
K13a  ``sa_grad_stats``            their autodiff: the gate's cotangent
K13b  ``sa_grad_apply``            their autodiff: x's gradient (the
                                   rescale's, the max's and the mean's
                                   cotangents in one pass)
====  ==========================  =========================================

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel (building the library at first use) or raises. Every
int8 kernel but K6 equals its plain version bit for bit; K6 sums on the
tensor cores and is held to its plain version by a counted bar on its codes
(``assert_up_codes_close``). K8a-K9b (``kernels/bn_act.py``, the train
path's, with the autograd function ``bn_relu_train``) sum in another
order than their plain versions; so do K10a-K11b (``kernels/se_train.py``,
the train path's squeeze-excite tail, with the autograd function
``se_train.se_train``) and K12a-K13b (``kernels/sa_train.py``, the train
path's spatial-attention gate, through ``sa_train.sa_tail``).
"""

from insarseg_torch.kernels._lib import (
    LAUNCHES,
    build_info,
    load_library,
    reset_launches,
)
from insarseg_torch.kernels.block_i8 import se_residual_i8, se_residual_i8_plain
from insarseg_torch.kernels.bn_act import (
    bn_apply_relu,
    bn_apply_relu_plain,
    bn_relu_grad_apply,
    bn_relu_grad_apply_plain,
    bn_relu_grad_stats,
    bn_relu_grad_stats_plain,
    bn_relu_train,
    bn_stats,
    bn_stats_plain,
)
from insarseg_torch.kernels.conv_i8 import (
    conv3x3_i8,
    conv3x3_i8_plain,
    conv_i8,
    conv_i8_plain,
    repack_conv_weight,
    tile_n,
)
from insarseg_torch.kernels.maxpool_i8 import (
    maxpool2x2_i8,
    maxpool2x2_i8_plain,
    maxpool_exit_s2d_i8,
    maxpool_exit_s2d_i8_plain,
)
from insarseg_torch.kernels.sa_i8 import (
    sa_gate_i8,
    sa_gate_i8_plain,
    sa_stats_i8,
    sa_stats_i8_plain,
)
from insarseg_torch.kernels.sa_train import (
    sa_apply,
    sa_apply_plain,
    sa_grad_apply,
    sa_grad_apply_plain,
    sa_grad_stats,
    sa_grad_stats_plain,
    sa_pool,
    sa_pool_plain,
)
from insarseg_torch.kernels.se_i8 import (
    se_excite_i8,
    se_excite_i8_plain,
    se_squeeze_i8,
    se_squeeze_i8_plain,
)
from insarseg_torch.kernels.se_train import (
    se_excite,
    se_excite_plain,
    se_grad_apply,
    se_grad_apply_plain,
    se_grad_stats,
    se_grad_stats_plain,
    se_squeeze,
    se_squeeze_plain,
)
from insarseg_torch.kernels.stem_i8 import stem_pool_i8, stem_pool_i8_plain
from insarseg_torch.kernels.up_i8 import (
    UP_SHARE_MAIN,
    UP_SHARE_RANDOM,
    UP_SHARE_TIES,
    assert_up_codes_close,
    pack_up_weight,
    up_concat_i8,
    up_concat_i8_plain,
)

__all__ = [
    "LAUNCHES", "build_info", "load_library", "reset_launches",
    "conv3x3_i8", "conv3x3_i8_plain", "conv_i8", "conv_i8_plain",
    "repack_conv_weight", "maxpool2x2_i8", "maxpool2x2_i8_plain",
    "maxpool_exit_s2d_i8", "maxpool_exit_s2d_i8_plain", "sa_gate_i8",
    "sa_gate_i8_plain", "sa_stats_i8", "sa_stats_i8_plain",
    "se_excite_i8", "se_excite_i8_plain", "se_residual_i8",
    "se_residual_i8_plain", "se_squeeze_i8", "se_squeeze_i8_plain",
    "stem_pool_i8", "stem_pool_i8_plain", "tile_n", "pack_up_weight",
    "up_concat_i8", "up_concat_i8_plain", "assert_up_codes_close",
    "UP_SHARE_MAIN", "UP_SHARE_RANDOM", "UP_SHARE_TIES",
    "bn_stats", "bn_stats_plain", "bn_apply_relu", "bn_apply_relu_plain",
    "bn_relu_grad_stats", "bn_relu_grad_stats_plain", "bn_relu_grad_apply",
    "bn_relu_grad_apply_plain", "bn_relu_train",
    "se_squeeze", "se_squeeze_plain", "se_excite", "se_excite_plain",
    "se_grad_stats", "se_grad_stats_plain", "se_grad_apply",
    "se_grad_apply_plain",
    "sa_pool", "sa_pool_plain", "sa_apply", "sa_apply_plain",
    "sa_grad_stats", "sa_grad_stats_plain", "sa_grad_apply",
    "sa_grad_apply_plain",
]

"""The port's op library: plain PyTorch ops and the CUDA kernel wrappers.

Public surface, the JAX package's (``nlspn_eccv20_tpu/ops/__init__.py``) on
NCHW tensors and torch weight layouts, plus ``small_conv3x3_planar`` (K9):

  * affinity:   normalize_affinity, insert_center_affinity, insert_center_offset
  * propagate:  propagate_local, propagate_local_planar, propagate_deformable,
                propagate_step
  * deformable: deform_conv, deformable_im2col, modulated_deform_conv,
                deform_psroi_pooling, and the six DCN modules
  * kernels:    small_conv3x3_planar; the model's kernels in ``ops.kernels``
"""

from nlspn_eccv20_tpu_torch.ops.affinity import (  # noqa: F401
    insert_center_affinity,
    insert_center_offset,
    normalize_affinity,
)
from nlspn_eccv20_tpu_torch.ops.deform_conv import (  # noqa: F401
    deform_conv,
    deformable_im2col,
    modulated_deform_conv,
)
from nlspn_eccv20_tpu_torch.ops.deform_psroi_pooling import (  # noqa: F401
    deform_psroi_pooling,
)
from nlspn_eccv20_tpu_torch.ops.kernels.small_conv3x3 import (  # noqa: F401
    small_conv3x3_planar,
)
from nlspn_eccv20_tpu_torch.ops.modules import (  # noqa: F401
    DeformConv,
    DeformConvPack,
    DeformRoIPooling,
    DeformRoIPoolingPack,
    ModulatedDeformConv,
    ModulatedDeformConvPack,
)
from nlspn_eccv20_tpu_torch.ops.propagate import (  # noqa: F401
    propagate_deformable,
    propagate_local,
    propagate_local_planar,
    propagate_step,
)

"""tpujoin_torch: the tpujoin join engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``tpujoin`` beside it, which stays the reference.
The v2 sort-merge equi-join runs end to end here; its four hot steps are
CUDA kernels written for ``sm_90a`` (``csrc/``), built with nvcc at first
use. CPU tensors take each kernel's plain PyTorch version instead.
"""

from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.ops.merge_join import merge_join

__all__ = ["JoinConfig", "PRESETS", "merge_join"]

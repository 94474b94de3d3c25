"""tpujoin_torch: the tpujoin join engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``tpujoin`` beside it, which stays the reference.
The v2 sort-merge equi-join runs end to end here, on its low- and
high-selectivity paths, with the factorized (RLE) result beside the pair
columns; its hot steps are CUDA kernels written for ``sm_90a`` (``csrc/``),
built with nvcc at first use. The entry points run on CUDA unless given
``device="cpu"`` or CPU tensors, which take each kernel's plain PyTorch
version instead.
"""

from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.ops.merge_join import merge_join, merge_join_rle

__all__ = ["JoinConfig", "PRESETS", "merge_join", "merge_join_rle"]

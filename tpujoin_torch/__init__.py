"""tpujoin_torch: the tpujoin engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``tpujoin`` beside it, which stays the reference.
The v2 sort-merge equi-join runs end to end here, on its low- and
high-selectivity paths, with the factorized (RLE) result beside the pair
columns; so do the filter, the group-by aggregate and the nested-loop
join. Their hot steps are CUDA kernels written for ``sm_90a`` (``csrc/``),
built with nvcc at first use. The entry points run on CUDA unless given
``device="cpu"`` or CPU tensors, which take each kernel's plain PyTorch
version instead.
"""

from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.core.table import Table
from tpujoin_torch.ops.aggregate import group_by_agg, group_by_count
from tpujoin_torch.ops.filter import filter_table
from tpujoin_torch.ops.merge_join import merge_join, merge_join_rle
from tpujoin_torch.ops.nested_loop_join import nested_loop_join

__all__ = ["JoinConfig", "PRESETS", "Table", "filter_table", "group_by_agg",
           "group_by_count", "merge_join", "merge_join_rle",
           "nested_loop_join"]

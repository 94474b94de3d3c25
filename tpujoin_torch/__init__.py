"""tpujoin_torch: the tpujoin engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``tpujoin`` beside it, which stays the reference.
The v2 sort-merge equi-join runs end to end here, on its low- and
high-selectivity paths, with the factorized (RLE) result beside the pair
columns, and so does the v1 searchsorted join; so do the semi, anti and
left-outer joins, the multi-column join with filter pushdown, the table
joins and table I/O, the filter, the group-by aggregate and the
nested-loop join. Their hot steps are CUDA kernels written for ``sm_90a``
(``csrc/``), built with nvcc at first use. The entry points run on CUDA
unless given ``device="cpu"`` or CPU tensors, which take each kernel's
plain PyTorch version instead.
"""

from tpujoin_torch.core.config import PRESETS, JoinConfig
from tpujoin_torch.core.table import Table
from tpujoin_torch.ops.aggregate import group_by_agg, group_by_count
from tpujoin_torch.ops.filter import filter_table
from tpujoin_torch.ops.hash_join import HashJoinTable, hash_join
from tpujoin_torch.ops.merge_join import (anti_join, left_outer_join,
                                          merge_join, merge_join_rle,
                                          semi_join)
from tpujoin_torch.ops.multi_join import hash_join_multi, join_with_pushdown
from tpujoin_torch.ops.nested_loop_join import nested_loop_join
from tpujoin_torch.ops.sort import sort_by_key
from tpujoin_torch.ops.table_join import join_tables

__all__ = ["HashJoinTable", "JoinConfig", "PRESETS", "Table", "anti_join",
           "filter_table", "group_by_agg", "group_by_count", "hash_join",
           "hash_join_multi", "join_tables", "join_with_pushdown",
           "left_outer_join", "merge_join", "merge_join_rle",
           "nested_loop_join", "semi_join", "sort_by_key"]

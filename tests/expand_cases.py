"""The expand path's test cases and the pair step K7b replaced, shared by
tests/test_torch_join.py (on the CPU) and tests/test_torch_cuda.py (on the
card). Imports no JAX."""
import numpy as np
import torch

from tpujoin_torch.kernels.expand import expand_plain
from tpujoin_torch.ops import merge_join as mj
from tpujoin_torch.ops.hash_join import HashJoinTable


def expand_case(shape: str, n: int, device="cpu", seed: int = 23):
    """(table, state) of one probe over ``n`` build rows: ``one_slot``
    gives every probe row one match, 1 to 7 rows an order (a primary-key
    join, ``lo`` ascending); ``dup`` gives each row 0 to 7 matches. The
    same arguments give the same data on every device."""
    rng = np.random.default_rng(seed)
    if shape == "one_slot":
        lo = np.repeat(np.arange(n), rng.integers(1, 8, n))
        cnt = np.ones_like(lo)
    else:
        lo = np.sort(rng.integers(0, n - 7, 3 * n))
        cnt = rng.integers(0, 8, lo.shape[0])
    table = HashJoinTable.from_numpy(np.arange(n), rng.permutation(n),
                                     device)
    return table, mj.SortedProbe.from_numpy(rng.permutation(lo.shape[0]), lo,
                                            cnt, device)


def previous_expand_path(ht, state, k_cap, cap, probe_base, total, nonzero):
    """The expand path's columns and ``fits`` as K4 and its glue made
    them, on the CPU: expand's build positions, the int64 slot mask, the
    clamp and gather of the sorted build ids, and the two ``where``."""
    lo_c, _, sid_c, offs_c = mj._compact(state, k_cap)
    bpos, sid_out = expand_plain(offs_c, lo_c, sid_c, cap)
    valid = torch.arange(cap, dtype=torch.int64) < total
    bpos = bpos.clamp(0, ht.num_rows - 1).long()
    neg = torch.tensor(-1, dtype=torch.int32)
    return (torch.where(valid, ht.sorted_ids[bpos], neg),
            torch.where(valid, sid_out + probe_base, neg),
            total <= cap and nonzero <= k_cap)

"""The build layer: ``tpujoin_torch.ops.hash_join.build``, the build keys
sorted with their row ids (K1). Its output, the sorted ids, is checked
through the pairs."""
from __future__ import annotations

from tpujoin_torch.ops import hash_join

LAYER = "build"
KEEP = ()


def run(join: dict, cfg: dict) -> None:
    join["table"] = hash_join.build(join["build_keys"])

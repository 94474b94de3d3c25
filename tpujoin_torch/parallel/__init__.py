from tpujoin_torch.parallel.mesh import make_mesh
from tpujoin_torch.parallel.shuffle_join import distributed_hash_join

__all__ = ["make_mesh", "distributed_hash_join"]

"""Evidence for the pipelined shuffle join's overlap, the counterpart of
tests/test_dist_overlap.py (which walks the JAX program's jaxpr).

The pipelined step issues chunk c + 1's all_to_all before chunk c's local
join, so on a process group (``async_op``) the exchange can run while the
join computes. One card cannot show real overlap; what the port's eager
program can show is the order in which it issues its work and the data
each collective consumes. A tracer records, in order, every torch call the
step makes (a ``TorchFunctionMode``), each mesh collective, and each call
of the kernel wrappers K1 ``sort_pairs``, K2 ``merge_count``, K3
``compact3`` and K4 ``expand``, with the tensors each takes and gives; the
producer of a tensor is the last recorded call that gave it.
"""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tpujoin_torch.parallel import shuffle_join as sj
from tpujoin_torch.parallel.mesh import Mesh, _Done

KERNELS = {"sort_pairs": "K1", "merge_count": "K2", "compact3": "K3",
           "expand": "K4"}
ROWS_PER_SHARD = 512


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    return []


class Trace(TorchFunctionMode):
    """Calls in order as (name, input tensors, output tensors); the
    tensors are kept alive so that their ids stay unique."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self.producer = {}
        self.keep = []
        self.depth = 0        # > 0 inside a recorded wrapper or collective

    def record(self, name, args, out):
        ins, outs = _tensors(args), _tensors(out)
        self.keep += ins + outs
        self.calls.append((name, ins, outs))
        for t in outs:
            self.producer[id(t)] = len(self.calls) - 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.depth:
            self.record(getattr(func, "__name__", str(func)),
                        (args, kwargs), out)
        return out

    def wrap(self, name, fn):
        def call(*args, **kwargs):
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            self.record(name, (args, kwargs), out)
            return out
        return call

    def closure(self, index):
        """The calls that the inputs of call ``index`` depend on."""
        seen, stack = set(), list(self.calls[index][1])
        while stack:
            p = self.producer.get(id(stack.pop()))
            if p is not None and p not in seen:
                seen.add(p)
                stack += self.calls[p][1]
        return seen


class RecordingMesh(Mesh):
    """An in-process CPU mesh whose collectives the trace records."""

    def __init__(self, size, trace):
        super().__init__(size, torch.device("cpu"))
        self.trace = trace

    def all_to_all(self, bufs, async_op=False):
        out = self.trace.wrap("all_to_all",
                              lambda b: Mesh.all_to_all(self, b))(bufs)
        return _Done(out) if async_op else out


def _traced_step(monkeypatch, p, chunks=2):
    trace = Trace()
    for name in KERNELS:
        monkeypatch.setattr(sj, name, trace.wrap(name, getattr(sj, name)))
    mesh = RecordingMesh(p, trace)
    rng = np.random.default_rng(p)
    n = ROWS_PER_SHARD * p
    keys = [mesh.put_rows(rng.integers(1, 300, n).astype(np.int32))
            for _ in range(2)]
    ids = mesh.put_rows(np.arange(n, dtype=np.int32))
    step = sj.make_shuffle_join_pipelined_fn(mesh, n, n, 1 << 16, chunks)
    with trace:
        step(keys[0], ids, keys[1], ids)
    return trace


@pytest.mark.parametrize("p,chunks", [(4, 2), (8, 4)])
def test_last_exchange_is_issued_before_the_previous_chunk_joins(
        monkeypatch, p, chunks):
    """Each chunk joins on every shard: P calls of K2, K3 and K4. The last
    chunk's exchange (keys, then ids) comes before the joins of the last
    two chunks, and after those of the chunks before them."""
    trace = _traced_step(monkeypatch, p, chunks)
    names = [c[0] for c in trace.calls]
    a2a = [i for i, n in enumerate(names) if n == "all_to_all"]
    assert len(a2a) == 2 + 2 * chunks      # the build side, then each chunk
    for kernel in ("merge_count", "compact3", "expand"):
        calls = [i for i, n in enumerate(names) if n == kernel]
        assert len(calls) == p * chunks
        assert sum(i < a2a[-1] for i in calls) == p * (chunks - 2)


@pytest.mark.parametrize("p,chunks", [(4, 2), (8, 4)])
def test_last_exchange_is_fed_only_by_its_chunks_packing(monkeypatch, p,
                                                         chunks):
    """The last exchange depends on no earlier exchange, no K2/K3/K4 and
    no sort of exchanged rows: only on local work, the build sorts whose
    samples gave the splitters and its own chunk's sorts (one K1 a
    shard each) and gathers."""
    trace = _traced_step(monkeypatch, p, chunks)
    names = [c[0] for c in trace.calls]
    last = max(i for i, n in enumerate(names) if n == "all_to_all")
    deps = trace.closure(last)
    dep_names = [names[i] for i in deps]
    assert "all_to_all" not in dep_names
    assert not {"merge_count", "compact3", "expand"} & set(dep_names)
    sorts = [i for i in deps if names[i] == "sort_pairs"]
    assert len(sorts) == 2 * p
    assert not any(names[j] == "all_to_all" for i in sorts
                   for j in trace.closure(i))
    assert "__getitem__" in dep_names


def test_first_chunk_exchange_feeds_the_join(monkeypatch):
    """The control of the test above: the closure machinery does see join
    work where it depends on an exchange."""
    trace = _traced_step(monkeypatch, 4)
    names = [c[0] for c in trace.calls]
    a2a = [i for i, n in enumerate(names) if n == "all_to_all"]
    first_k2 = names.index("merge_count")
    assert {a2a[2], a2a[3]} <= trace.closure(first_k2)


def test_packing_is_one_gather_whatever_the_mesh(monkeypatch):
    """Packing a shard's send buffer makes the same calls at P = 2, 4 and
    8: one gather a column, no loop over peers."""
    counts = {}
    for p in (2, 4, 8):
        trace = Trace()
        rng = np.random.default_rng(0)
        keys = torch.sort(torch.from_numpy(
            rng.integers(1, 1000, 4096).astype(np.int32))).values
        ids = torch.arange(4096, dtype=torch.int32)
        spl = keys[torch.arange(1, p) * (4096 // p)]
        starts, cnt = sj._segment_bounds(
            keys, spl, torch.tensor(4096, dtype=torch.int32))
        with trace:
            bk, bi, _ = sj._pack_sorted(keys, ids, starts, cnt, 4096, -7)
        assert bk.shape == bi.shape == (p, 4096)
        for q in range(p):
            c = int(cnt[q])
            assert torch.equal(bk[q, :c], keys[starts[q]:starts[q] + c])
            assert torch.equal(bi[q, :c], ids[starts[q]:starts[q] + c])
            assert bool((bk[q, c:] == -7).all() and (bi[q, c:] == -1).all())
        counts[p] = [c[0] for c in trace.calls]
        gathers = [c for c in trace.calls
                   if c[0] == "__getitem__" and len(c[1]) == 2]
        assert len(gathers) == 2           # indexed by a tensor
    assert counts[2] == counts[4] == counts[8]

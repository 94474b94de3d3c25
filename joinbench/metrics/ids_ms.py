"""ids_ms: the device ms a join spends on its row ids, the program's spans
``build.ids`` and ``count.ids`` (the two ``torch.arange``), over the
profiled slices' joins."""
from joinbench import spans


def read(r):
    return spans.per_join(r, lambda s: s["name"] in ("build.ids", "count.ids"),
                          "device_ms")

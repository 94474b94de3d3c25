"""import_s: the seconds of the program's own imports, its set-up record
``setup.import`` (``tpujoin_torch/__init__.py`` times them from its first
line; torch is loaded before)."""
from joinbench import spans


def read(r):
    return spans.setup_s(r, "setup.import")

"""``mfu.train`` (see its file), in the cells that report ``train_s.caltech``."""
from portbench.harness import cells

_same = cells.metric_module("mfu.train")
read, examples = _same.read, _same.examples

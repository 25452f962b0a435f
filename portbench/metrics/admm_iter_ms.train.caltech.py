"""``admm_iter_ms.train`` (see its file), in the cells that report ``train_s.caltech``."""
from portbench.harness import cells

_same = cells.metric_module("admm_iter_ms.train")
read, examples = _same.read, _same.examples

"""``layer_stats_ms.train`` (see its file), in the cells that report ``train_s.caltech``."""
from portbench.harness import cells

_same = cells.metric_module("layer_stats_ms.train")
read, examples = _same.read, _same.examples

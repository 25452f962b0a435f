from repro_torch.data.synthetic import (
    PAPER_DATASETS,
    PARTITIONS,
    Dataset,
    make_classification,
    paper_dataset,
    partition_by_spec,
    partition_workers,
    partition_workers_noniid,
)
from repro_torch.data.tokens import TokenStream, batches

__all__ = [
    "PAPER_DATASETS",
    "PARTITIONS",
    "Dataset",
    "TokenStream",
    "batches",
    "make_classification",
    "paper_dataset",
    "partition_by_spec",
    "partition_workers",
    "partition_workers_noniid",
]

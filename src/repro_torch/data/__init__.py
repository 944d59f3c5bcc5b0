from repro_torch.data.partition import (label_coverage_score,
                                        label_distribution,
                                        partition_class_imbalanced,
                                        partition_dirichlet, partition_iid,
                                        partition_noniid_a,
                                        partition_noniid_b)
from repro_torch.data.pipeline import (BatchIterator, PackedLMBatcher,
                                       client_iterators)
from repro_torch.data.synthetic import (SyntheticImageDataset, make_dataset,
                                        make_lm_dataset)

__all__ = ["SyntheticImageDataset", "make_dataset", "make_lm_dataset",
           "BatchIterator", "PackedLMBatcher", "client_iterators",
           "partition_iid", "partition_noniid_a", "partition_noniid_b",
           "partition_dirichlet",
           "partition_class_imbalanced", "label_distribution",
           "label_coverage_score"]

from repro_torch.data.partition import (label_coverage_score,
                                        label_distribution, partition_iid,
                                        partition_noniid_b)
from repro_torch.data.synthetic import SyntheticImageDataset, make_dataset

__all__ = ["SyntheticImageDataset", "make_dataset", "partition_iid",
           "partition_noniid_b", "label_distribution",
           "label_coverage_score"]

from repro_torch.data.partition import make_partition
from repro_torch.data.synthetic import (ClusterClassification, SequenceCopy,
                                        batches)

__all__ = ["ClusterClassification", "SequenceCopy", "batches",
           "make_partition"]

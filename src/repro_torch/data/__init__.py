from repro_torch.data.partition import make_partition
from repro_torch.data.synthetic import ClusterClassification, batches

__all__ = ["ClusterClassification", "batches", "make_partition"]

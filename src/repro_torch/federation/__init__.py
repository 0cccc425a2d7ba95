from repro_torch.federation.experiment import (FLExperiment, build_experiment,
                                               fedvit_config)
from repro_torch.federation.server import FederatedLoRA, RoundStats
from repro_torch.federation.topology import ClientRegistry

__all__ = ["ClientRegistry", "FLExperiment", "FederatedLoRA", "RoundStats",
           "build_experiment", "fedvit_config"]

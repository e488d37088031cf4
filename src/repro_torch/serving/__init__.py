from repro_torch.serving import (admission, cluster, engine,  # noqa: F401
                                 governor, scheduler, split_runtime)
from repro_torch.serving.cluster import (CellId,  # noqa: F401
                                         SplitInferenceCluster)
from repro_torch.serving.governor import (GovernorDecision,  # noqa: F401
                                          QoSGovernor)

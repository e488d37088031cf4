from repro_torch.loadgen.driver import LoadReport, run_load  # noqa: F401
from repro_torch.loadgen.traces import (AdversarialTrace,  # noqa: F401
                                        ArrivalTrace, DiurnalTrace,
                                        FlashCrowdTrace, PoissonTrace,
                                        RandomWaypointTrace, make_trace)

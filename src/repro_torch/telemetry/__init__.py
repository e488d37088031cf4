from repro_torch.telemetry import spans  # noqa: F401
from repro_torch.telemetry.bus import (Event, StreamSummary,  # noqa: F401
                                 TelemetryBus)
from repro_torch.telemetry.sinks import FileSink  # noqa: F401

from repro_torch.runtime.fault import (  # noqa: F401
    FaultTolerantLoop, LinkFault, PreemptionSignal)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticScheduleSet, RankLossSignal, rank_remap, remesh_plan,
    shrink_topology)
from repro_torch.runtime.tuning_daemon import (  # noqa: F401
    DriftReport, TuningDaemon)

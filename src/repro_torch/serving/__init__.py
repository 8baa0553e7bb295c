from repro_torch.serving.engine import DecodeEngine, GenerationResult  # noqa: F401
from repro_torch.serving.faults import (FaultInjector, FaultPlan,  # noqa: F401
                                        FaultPlanConfig, FaultSpec,
                                        InjectedFault, generate_fault_plan,
                                        plan_from_text, plan_to_text,
                                        validate_plan)
from repro_torch.serving.memory import BlockAllocator, PrefixCache  # noqa: F401
from repro_torch.serving.sampling import sample  # noqa: F401
from repro_torch.serving.scheduler import SlotScheduler  # noqa: F401
from repro_torch.serving.session import (ContinuousResult,  # noqa: F401
                                         SessionRequest, SessionResult)
from repro_torch.serving.trace import (SessionClass, Trace,  # noqa: F401
                                       TraceConfig, bursty_config,
                                       generate_trace, poisson_config,
                                       slo_report, trace_from_text,
                                       trace_to_text, validate_trace)

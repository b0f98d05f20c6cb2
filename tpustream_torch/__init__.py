"""tpustream_torch — the tpustream streaming framework on PyTorch and CUDA.

A port of the ``tpustream`` package (JAX on a TPU) to PyTorch on an
NVIDIA GPU, with the same Flink DataStream-style surface and the same
output bytes. The layout mirrors ``tpustream``'s module for module; this
package imports nothing from it and nothing of JAX.

Keyed state lives in dense device tensors indexed by interned key ids,
and the record-at-a-time keyed rolling reduce runs as a hand-written
CUDA kernel (``kernels/seq_rolling.cu``). Jobs run on
``StreamConfig.device`` ("cuda" by default; "cpu" only when asked for).

Ported so far, on one device: the tutorial's jobs (chapters 1-3: the
stateless filter, rolling aggregates, tumbling and sliding windows with
``reduce``/``aggregate``/``process()``, allowed lateness and the late
side output), session windows, count windows, chained keyed stages,
chapter 4's CEP pattern matching (``CEP``, ``Pattern``), chapter 5's
dynamic rules over a broadcast control stream (``RuleSet``,
``DataStream.broadcast``), chapter 6's multi-tenant job server
(``JobServer``, ``TenantPlan``, ``TenantQuota``: many tenants' rule
sets in one built program) and the observability layer a job reports
through with ``ObsConfig(enabled=True)`` (``tpustream_torch.obs``:
registry, spans, latency markers, health rules, flight recorder,
snapshots, the ``MetricsServer`` scrape, tenant SLOs and the build
registry), and the executor pipeline every job runs through (staged
uploads, steps in flight, the packed wire, device-side compaction,
grouped fetches, parse-ahead), ingest lanes with in-place self-healing
(``StreamConfig.ingest_lanes``), dead-letter quarantine
(``StreamConfig.dead_letter``) and the adaptive pipeline controller
(``ObsConfig.adaptive``), and the pre-flight plan analyzer
(``env.analyze()``, ``StreamConfig.strict_analysis``, ``Finding``,
``PlanAnalysisError``; ``python -m tpustream_torch.analysis.lint``) with
the checkpoint state-layout audit (``env.audit_checkpoint``). ``ROADMAP.md``
lists what is still to come.
"""

import os as _os

if _os.environ.get("TPUSTREAM_LANE_WORKER") == "1":
    # Ingest-lane worker process (runtime/ingest.py starts it with this
    # set): the worker runs only the columnar parse plane (hostparse,
    # records, native), so the package imports no torch and none of the
    # API surface, and a worker starts on a numpy import. Under the
    # "spawn" start method the child re-executes the user's __main__,
    # whose top-level ``from tpustream_torch import ...`` must still
    # resolve: the public names resolve lazily, through the ordinary
    # submodule imports, on first use.
    _LAZY_API = {
        "Tuple2": "api.tuples", "Tuple3": "api.tuples",
        "Tuple4": "api.tuples",
        "Time": "api.timeapi", "TimeCharacteristic": "api.timeapi",
        "StreamExecutionEnvironment": "api.environment",
        "AssignerWithPeriodicWatermarks": "api.watermarks",
        "BoundedOutOfOrdernessTimestampExtractor": "api.watermarks",
        "Watermark": "api.watermarks",
        "AggregateFunction": "api.functions",
        "FilterFunction": "api.functions",
        "KeySelector": "api.functions", "MapFunction": "api.functions",
        "ProcessWindowFunction": "api.functions",
        "ReduceFunction": "api.functions",
        "OutputTag": "api.output",
        "Finding": "analysis", "PlanAnalysisError": "analysis",
        "BroadcastStream": "broadcast", "RuleDescriptor": "broadcast",
        "RuleParam": "broadcast", "RuleSet": "broadcast",
        "RuleUpdate": "broadcast",
        "CEP": "cep", "Pattern": "cep",
        "PatternSelectFunction": "cep",
        "StreamConfig": "config",
        "MetricsServer": "obs", "TenantSLO": "obs",
        "JobServer": "tenancy", "TenantPlan": "tenancy",
        "TenantQuota": "tenancy",
        "RestartStrategies": "runtime.supervisor",
    }

    def __getattr__(name):
        target = _LAZY_API.get(name)
        if target is None:
            raise AttributeError(name)
        import importlib

        mod = importlib.import_module("." + target, __name__)
        val = getattr(mod, name)
        globals()[name] = val
        return val
else:
    from .api.tuples import Tuple2, Tuple3, Tuple4  # noqa: E402
    from .api.timeapi import Time, TimeCharacteristic  # noqa: E402
    from .api.environment import StreamExecutionEnvironment  # noqa: E402
    from .api.watermarks import (  # noqa: E402
        AssignerWithPeriodicWatermarks,
        BoundedOutOfOrdernessTimestampExtractor,
        Watermark,
    )
    from .api.functions import (  # noqa: E402
        AggregateFunction,
        FilterFunction,
        KeySelector,
        MapFunction,
        ProcessWindowFunction,
        ReduceFunction,
    )
    from .api.output import OutputTag  # noqa: E402
    from .analysis import Finding, PlanAnalysisError  # noqa: E402
    from .broadcast import (  # noqa: E402
        BroadcastStream,
        RuleDescriptor,
        RuleParam,
        RuleSet,
        RuleUpdate,
    )
    from .cep import CEP, Pattern, PatternSelectFunction  # noqa: E402
    from .config import StreamConfig  # noqa: E402
    from .obs import MetricsServer, TenantSLO  # noqa: E402
    from .tenancy import JobServer, TenantPlan, TenantQuota  # noqa: E402
    from .runtime.supervisor import RestartStrategies  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AggregateFunction",
    "AssignerWithPeriodicWatermarks",
    "BoundedOutOfOrdernessTimestampExtractor",
    "BroadcastStream",
    "CEP",
    "FilterFunction",
    "Finding",
    "JobServer",
    "KeySelector",
    "MapFunction",
    "MetricsServer",
    "OutputTag",
    "Pattern",
    "PatternSelectFunction",
    "PlanAnalysisError",
    "ProcessWindowFunction",
    "ReduceFunction",
    "RestartStrategies",
    "RuleDescriptor",
    "RuleParam",
    "RuleSet",
    "RuleUpdate",
    "StreamConfig",
    "StreamExecutionEnvironment",
    "TenantPlan",
    "TenantQuota",
    "TenantSLO",
    "Time",
    "TimeCharacteristic",
    "Tuple2",
    "Tuple3",
    "Tuple4",
    "Watermark",
]

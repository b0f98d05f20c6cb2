"""Chapter 1: CPU threshold alert.

PyTorch port of reference chapter1/.../Main.java:15-34: socket source
-> parse ``ts host cpu usage`` -> Tuple3(host, cpu, usage) -> keep
usage > 90 -> print. The quirky job name "Window WordCount" is preserved
(Main.java:34). The parse runs on the host, the ``> 90`` filter on the
device, and only the kept rows come back (``runtime/step.py::
StatelessProgram``).


:func:`health_rules` re-expresses the same idea one level up: chapter
1's "alert when a threshold is crossed" applied to the runtime's OWN
metrics (the obs/health.py engine), so the monitoring job is itself
monitored. ``main`` installs them when obs is enabled.
"""

from __future__ import annotations

from tpustream_torch import StreamExecutionEnvironment, Tuple3
from tpustream_torch.javacompat import Double
from tpustream_torch.obs import AlertRule


def parse(value: str) -> Tuple3:
    items = value.split(" ")
    host = items[1]
    cpu = items[2]
    usage = Double.parseDouble(items[3])
    return Tuple3(host, cpu, usage)


def build(env: StreamExecutionEnvironment, text):
    return text.map(parse).filter(lambda value: value.f2 > 90)


def health_rules(stall_s: float = 30.0):
    """The chapter-1 threshold pattern turned on the runtime itself:
    alert when the pipeline stops moving or falls behind.

    * ``ingest_stalled`` — ``operator_records_in`` stopped changing
      between snapshot ticks for ``stall_s`` (the ``records rate == 0``
      liveness idiom; WARN, sources legitimately idle).
    * ``emit_stalled`` — records keep arriving but nothing has been
      emitted for ``stall_s`` (CRIT: the filter/sink path is stuck).
    * ``backpressure`` — the source queue keeps growing for ``stall_s``
      (CRIT: the device side cannot keep up with ingest).
    """
    return (
        AlertRule(
            name="ingest_stalled", metric="operator_records_in",
            kind="absence", for_s=stall_s, severity="warn",
        ),
        AlertRule(
            name="emit_stalled", metric="operator_records_emitted",
            kind="absence", for_s=stall_s, severity="crit",
        ),
        AlertRule(
            name="backpressure", metric="source_queue_depth",
            kind="rate", op=">", value=0.0, for_s=stall_s,
            severity="crit",
        ),
    )


def lint_env() -> StreamExecutionEnvironment:
    """Constructed-but-never-executed env for the pre-flight analyzer
    (``python -m tpustream_torch.analysis.lint``)."""
    env = StreamExecutionEnvironment.get_execution_environment()
    build(env, env.from_collection([])).print()
    return env


def main(host: str = "localhost", port: int = 8080) -> None:
    env = StreamExecutionEnvironment.get_execution_environment()
    if env.config.obs.enabled and not env.config.obs.health_rules:
        env.config = env.config.replace(
            obs=env.config.obs.replace(health_rules=health_rules())
        )
    text = env.socket_text_stream(host, port)
    build(env, text).print()
    env.execute("Window WordCount")


if __name__ == "__main__":
    main()

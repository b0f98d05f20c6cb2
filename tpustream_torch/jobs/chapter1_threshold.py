"""Chapter 1: CPU threshold alert.

PyTorch port of reference chapter1/.../Main.java:15-34: socket source
-> parse ``ts host cpu usage`` -> Tuple3(host, cpu, usage) -> keep
usage > 90 -> print. The quirky job name "Window WordCount" is preserved
(Main.java:34). The parse runs on the host, the ``> 90`` filter on the
device, and only the kept rows come back (``runtime/step.py::
StatelessProgram``).

The JAX package's copy also carries ``health_rules``, the same
threshold idea applied to the runtime's own metrics through its
observability layer, which ``main`` installs when obs is enabled. The
port has no observability layer yet (roadmap queue item 13), so both
are left out here.
"""

from __future__ import annotations

from tpustream_torch import StreamExecutionEnvironment, Tuple3
from tpustream_torch.javacompat import Double


def parse(value: str) -> Tuple3:
    items = value.split(" ")
    host = items[1]
    cpu = items[2]
    usage = Double.parseDouble(items[3])
    return Tuple3(host, cpu, usage)


def build(env: StreamExecutionEnvironment, text):
    return text.map(parse).filter(lambda value: value.f2 > 90)


def lint_env() -> StreamExecutionEnvironment:
    """Constructed-but-never-executed env for the pre-flight analyzer."""
    env = StreamExecutionEnvironment.get_execution_environment()
    build(env, env.from_collection([])).print()
    return env


def main(host: str = "localhost", port: int = 8080) -> None:
    env = StreamExecutionEnvironment.get_execution_environment()
    text = env.socket_text_stream(host, port)
    build(env, text).print()
    env.execute("Window WordCount")


if __name__ == "__main__":
    main()

"""Chapter 5: the chapter-1 threshold alert with a DYNAMIC threshold.

The reference bakes ``usage > 90`` into the job at build time
(chapter1/.../Main.java:27-33); changing it means redeploying. Flink's
production answer is broadcast state — a control stream whose rule
updates reach every parallel instance without a restart. This job is
that pattern, the PyTorch port of
tpustream/jobs/chapter5_dynamic_rules.py (tpustream_torch/broadcast):

* the threshold is a :class:`~tpustream_torch.RuleSet` parameter,
  materialized as a 0-d tensor on the device riding the program's state;
* a second (control) source carries ``threshold <value> <after_records>``
  lines; the executor applies each at its exact record boundary by
  splitting the straddling data batch — records before position N run
  under the old threshold, records at/after N under the new;
* an update writes that tensor in place; the program is not rebuilt.

``oracle`` computes the expected alert set host-side so tests (and the
``main`` demo) can assert the pre/post-update split exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from tpustream_torch import RuleSet, StreamExecutionEnvironment, Tuple3
from tpustream_torch.javacompat import Double

DEFAULT_THRESHOLD = 90.0


def make_rules() -> RuleSet:
    """One RuleSet per job run: the chapter-1 threshold as a dynamic
    parameter (a fresh set per env keeps runs independent)."""
    rules = RuleSet()
    rules.declare(
        "threshold", DEFAULT_THRESHOLD, "f64",
        description="alert when usage exceeds this",
    )
    return rules


def parse(value: str) -> Tuple3:
    items = value.split(" ")
    host = items[1]
    cpu = items[2]
    usage = Double.parseDouble(items[3])
    return Tuple3(host, cpu, usage)


def build(env: StreamExecutionEnvironment, text, control, rules: RuleSet):
    """Chapter 1's map+filter with the threshold read from ``rules``;
    ``control`` becomes the job's broadcast stream."""
    control.broadcast(rules)
    threshold = rules.param("threshold")
    return text.map(parse).filter(lambda value: value.f2 > threshold)


def oracle(
    lines: Sequence[str],
    updates: Sequence[Tuple[int, float]],
    threshold: float = DEFAULT_THRESHOLD,
) -> List[Tuple3]:
    """Host-side expected output: ``updates`` is [(after_records, new
    threshold)] — record i alerts iff its usage exceeds the threshold
    active AT position i (the record-boundary semantics the executor
    implements by batch splitting)."""
    timeline = sorted(updates)
    out = []
    for i, line in enumerate(lines):
        t = threshold
        for pos, v in timeline:
            if i >= pos:
                t = v
        rec = parse(line)
        if rec.f2 > t:
            out.append(rec)
    return out


def control_lines(updates: Sequence[Tuple[int, float]]) -> List[str]:
    """Render [(after_records, value)] as default-parser control lines."""
    return [f"threshold {v} {pos}" for pos, v in updates]


def lint_env() -> StreamExecutionEnvironment:
    """Constructed-but-never-executed env for the pre-flight analyzer."""
    env = StreamExecutionEnvironment.get_execution_environment()
    rules = make_rules()
    text = env.from_collection([])
    control = env.from_collection([])
    build(env, text, control, rules).print()
    return env


def main(
    host: str = "localhost",
    port: int = 8080,
    control_port: int = 8081,
) -> None:
    """Live demo: data records on ``port``, control lines (``threshold
    95``) on ``control_port`` — raise the threshold mid-stream with
    ``echo 'threshold 95' | nc localhost 8081``; alerts change with no
    rebuild and no restart."""
    env = StreamExecutionEnvironment.get_execution_environment()
    rules = make_rules()
    text = env.socket_text_stream(host, port)
    control = env.socket_text_stream(host, control_port)
    build(env, text, control, rules).print()
    env.execute("Dynamic Threshold Alert")


if __name__ == "__main__":
    main()

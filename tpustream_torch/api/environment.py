"""StreamExecutionEnvironment — the job entry point.

Mirrors the reference's phase-A/phase-B shape
(chapter1/README.md:57-61): operator calls build a lazy graph;
``execute(job_name)`` plans it, builds the PyTorch step program on the
configured device (``StreamConfig.device``), and streams batches through
it until the source is exhausted.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..config import StreamConfig
from .datastream import DataStream
from .graph import Node
from .timeapi import TimeCharacteristic


class StreamExecutionEnvironment:
    def __init__(self, config: Optional[StreamConfig] = None):
        self.config = config or StreamConfig()
        self.time_characteristic = TimeCharacteristic.ProcessingTime
        self._sinks: list[Node] = []
        self.job_name: Optional[str] = None
        self.metrics = None        # populated by execute()
        # a snapshot to resume from (restore_from_checkpoint); a
        # supervised restart sets it to the newest valid checkpoint
        self._checkpoint_restore_path: Optional[str] = None
        # dynamic-rules control stream (DataStream.broadcast): ONE
        # BroadcastStream per job; its RuleSet threads through every
        # program of the plan chain (tpustream_torch/broadcast)
        self._broadcast = None
        # multi-tenant fleet root (tenancy/server.py JobServer.build_job
        # sets it): the executor attaches it to the job's obs root
        self._tenancy = None
        # dead-letter output (StreamConfig.dead_letter): (line, error)
        # pairs quarantined by the host parse stage instead of failing
        # the job; survives supervised restarts (rolled back with the
        # sinks on recovery so counts stay exactly-once)
        self.dead_letters: list = []
        # savepoints (runtime/checkpoint.py save_savepoint): tags
        # requested via savepoint(), consumed by the executor at the
        # next batch boundary; written paths accumulate in savepoints
        self._savepoint_requests: list = []
        self.savepoints: list[str] = []

    # -- construction --------------------------------------------------------
    @staticmethod
    def get_execution_environment(
        config: Optional[StreamConfig] = None,
    ) -> "StreamExecutionEnvironment":
        return StreamExecutionEnvironment(config)

    getExecutionEnvironment = get_execution_environment

    # -- configuration -------------------------------------------------------
    def set_stream_time_characteristic(self, tc: TimeCharacteristic) -> None:
        self.time_characteristic = tc

    setStreamTimeCharacteristic = set_stream_time_characteristic

    def set_parallelism(self, n: int) -> None:
        self.config = self.config.replace(parallelism=n)

    setParallelism = set_parallelism

    def enable_checkpointing(
        self, interval_batches: int, directory: Optional[str] = None
    ) -> None:
        """Snapshot the job's state every ``interval_batches`` source
        batches into ``directory`` (runtime/checkpoint.py), in the JAX
        package's snapshot format."""
        self.config = self.config.replace(
            checkpoint_interval_batches=interval_batches,
            checkpoint_dir=directory or self.config.checkpoint_dir,
        )

    enableCheckpointing = enable_checkpointing

    def restore_from_checkpoint(self, path: str) -> None:
        """Resume the next ``execute()`` from the snapshot at ``path`` (a
        file, or a checkpoint directory's newest valid snapshot)."""
        self._checkpoint_restore_path = path

    def savepoint(self, tag: Optional[str] = None) -> None:
        """Request a pinned, self-contained snapshot (Flink's savepoint:
        the operator-triggered artifact for migration, distinct from the
        periodic checkpoints retention may prune). The executor writes it
        at the next batch boundary — requests registered before
        ``execute()`` land after the first batch — into
        ``config.checkpoint_dir`` as ``savepoint-<source_pos>[-<tag>]
        .npz``; written paths accumulate in ``env.savepoints``. Restore
        one explicitly via :meth:`restore_from_checkpoint` (savepoints
        are never automatic recovery candidates)."""
        if not self.config.checkpoint_dir:
            raise RuntimeError(
                "savepoint() needs config.checkpoint_dir — savepoints "
                "are written next to the job's checkpoints"
            )
        self._savepoint_requests.append(tag)

    def set_restart_strategy(self, strategy) -> None:
        """Flink 1.8 parity (env.setRestartStrategy(
        RestartStrategies.fixedDelayRestart(3, ...))): failures consult
        ``strategy`` and restarts resume from the latest checkpoint —
        see runtime/supervisor.py."""
        self.config = self.config.replace(restart_strategy=strategy)

    setRestartStrategy = set_restart_strategy

    # -- sources -------------------------------------------------------------
    def socket_text_stream(
        self, host: str, port: int, raw: bool = False
    ) -> DataStream:
        """nc-compatible line source (reference chapter1/.../Main.java:17,
        run with ``nc -lk 8080`` per chapter1/README.md:65-68).

        ``raw=True`` streams byte blocks instead of lines; the host stage
        decodes them into lines (this package has no native parser)."""
        from ..runtime.sources import SocketTextSource

        return self.add_source(SocketTextSource(host, port, raw=raw))

    socketTextStream = socket_text_stream

    def from_collection(self, lines: Iterable) -> DataStream:
        from ..runtime.sources import ReplaySource

        return self.add_source(ReplaySource(list(lines)))

    fromCollection = from_collection

    def add_source(self, source) -> DataStream:
        node = Node("source", None, {"source": source})
        return DataStream(self, node)

    addSource = add_source

    # -- execution -----------------------------------------------------------
    def _register_sink(self, node: Node) -> None:
        self._sinks.append(node)

    def _register_broadcast(self, bs) -> None:
        if self._broadcast is not None:
            raise RuntimeError(
                "a job supports one broadcast control stream; declare "
                "all dynamic parameters in one RuleSet"
            )
        self._broadcast = bs

    def analyze(self) -> list:
        """Pre-flight static analysis of the constructed graph: every
        plan-lint and purity finding (tpustream_torch/analysis), worst
        first. Pure inspection — nothing plans, builds or launches, and
        the graph is not mutated. ``execute()`` runs the same analysis
        automatically when ``config.strict_analysis`` or obs is on."""
        from ..analysis import analyze

        return analyze(self, self._sinks)

    def audit_checkpoint(self, path: str):
        """Audit an on-disk checkpoint's state layout against THIS job
        graph without loading its arrays or building a program: returns
        an :class:`tpustream_torch.analysis.state_audit.AuditReport` whose
        verdict (compatible/incompatible/unknown) matches what an
        actual restore would do, with TSM04x findings explaining any
        drift. ``python -m tpustream_torch.analysis.audit`` is the CLI
        form."""
        from ..analysis.state_audit import audit_checkpoint

        return audit_checkpoint(self, path, self._sinks)

    def execute(self, job_name: str = "tpustream job"):
        """Phase B: plan, build the device program, and run the job to
        source exhaustion.

        Returns the executor's JobResult (collected metrics etc.).
        Raises ``RuntimeError`` when ``config.device`` names CUDA and no
        card is visible: the job never silently moves to the CPU.
        """
        from ..runtime.executor import execute_job

        self.job_name = job_name
        if not self._sinks:
            raise RuntimeError("no sinks registered; nothing to execute")
        return execute_job(self, self._sinks)

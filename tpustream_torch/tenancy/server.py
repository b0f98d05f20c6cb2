"""JobServer: multiplex N logical jobs onto ONE built device program.

Counterpart of tpustream/tenancy/server.py, on torch tensors. The
serving layer over :class:`TenantPlan`. Every admitted tenant runs the
fleet's template chain, and the whole fleet shares one built program —
tenant isolation is a data-layout property, never a build property:

* **key namespace** — the tenant's slot id is folded into the template's
  STR key field at parse time (``"<slot>\\x1f<key>"``), so the existing
  device key table partitions into per-tenant namespaces and dynamic key
  growth / checkpoint restore work unchanged;
* **rule rows** — the dynamic rule leaves become ``[T]`` vectors
  (:meth:`RuleSet.enable_tenancy`); each record carries its tenant slot
  as a trailing i64 field and every proxied user fn runs under
  :meth:`RuleSet.bound_tenant`, so a RuleParam resolves to
  ``leaf[slot]`` — one batched gather per rule inside the step;
* **liveness** — a reserved ``__tenant_active__`` BOOL rule row gates
  every record through a prepended filter: ``remove_tenant`` is a
  buffer write that starts dropping the tenant's rows at an exact
  record boundary, no program rebuild;
* **control plane** — ``add_tenant`` / ``remove_tenant`` /
  ``update_tenant_rules`` land as tenant-scoped
  :class:`~tpustream_torch.broadcast.RuleUpdate`\\ s on the standard broadcast
  feed, applied at existing batch-split barriers, replay-deterministic
  across supervised restarts;
* **quota** — per-tenant record quotas divert over-quota lines to a
  ``quota_exceeded`` side output at admission, before they cost any
  device time;
* **demux** — sink output lands in one collect handle (so checkpoint
  sink-count rollback works unchanged) and splits back per tenant on
  read, with the namespace prefix stripped — a tenant's output is
  byte-identical to running its job alone;
* **observability** — the server is the fleet's tenant-attribution
  root: it labels the round-robin latency markers
  (:meth:`JobServer.marker_tenant_provider`), refreshes per-tenant
  admission/emit/error/step-share gauges at every snapshot tick
  (:meth:`JobServer.refresh_obs`), compiles declared
  :class:`~tpustream_torch.obs.slo.TenantSLO` objectives into per-tenant
  health rules, serves the ``/tenants.json`` fleet view, and retires a
  removed tenant's series at the exact record boundary the removal
  lands (:meth:`JobServer.retire_tenant_obs`). Label cardinality is
  bounded by ``ObsConfig.tenant_series_topk``: only the top-K active
  tenants by admitted records get their own label value; the rest fold
  into one ``__other__`` bucket.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..api.datastream import DataStream, KeyedStream, WindowedStream
from ..api.functions import Collector, as_callable
from ..api.graph import Node
from ..api.tuples import TupleBase, make_tuple
from ..broadcast.rules import (
    TENANT_ACTIVE_RULE,
    RuleParam,
    RuleSet,
    RuleUpdate,
)
from ..config import StreamConfig
from ..obs.slo import (
    OTHER_TENANT,
    TenantSLO,
    compile_tenant_slo,
    slo_rule_names,
)
from ..runtime.device import as_tensor
from .plan import TenantPlan, TenantQuota

#: separates the tenant slot from the payload in tagged source lines and
#: from the user key in namespaced key strings (an ASCII unit separator
#: — vanishingly unlikely in monitoring keys, and cheap to strip)
TENANT_SEP = "\x1f"


def _vals(rec) -> List[Any]:
    if isinstance(rec, (TupleBase, tuple)):
        return list(rec)
    return [rec]


def _pack(vals: Sequence[Any]):
    if len(vals) == 1:
        return vals[0]
    if len(vals) <= 4:
        return make_tuple(*vals)
    return tuple(vals)


def _wrap_map(rules: RuleSet, fn):
    """Trace the user map fn with (a) the tenant field hidden and (b)
    the record's tenant slot bound, so RuleParams gather their row."""

    def tenant_map(rec):
        vals = _vals(rec)
        tid = vals[-1]
        with rules.bound_tenant(tid):
            out = fn(_pack(vals[:-1]))
            out_vals = _vals(out)
        return _pack(out_vals + [tid])

    return tenant_map


def _wrap_filter(rules: RuleSet, fn):
    def tenant_filter(rec):
        vals = _vals(rec)
        tid = vals[-1]
        with rules.bound_tenant(tid):
            keep = fn(_pack(vals[:-1]))
            # a bare RuleParam (e.g. a BOOL rule used AS the predicate)
            # must resolve INSIDE the tenant binding, not later at the
            # mask logical_and
            if isinstance(keep, RuleParam):
                keep = as_tensor(keep)
        return keep

    return tenant_filter


def _wrap_reduce(rules: RuleSet, fn):
    """Two-record reduce: both carry the same tenant slot (keys are
    tenant-namespaced), so bind from the first and reattach it."""

    def tenant_reduce(a, b):
        va, vb = _vals(a), _vals(b)
        tid = va[-1]
        with rules.bound_tenant(tid):
            out = fn(_pack(va[:-1]), _pack(vb[:-1]))
            out_vals = _vals(out)
        return _pack(out_vals + [tid])

    return tenant_reduce


def _wrap_raw_flat_map(fn):
    """Lift a user ``flat_map`` (``str -> iterable[str]``) onto the
    TAGGED raw stream: strip the ``"<slot>\\x1f"`` admission tag, run
    the user fn on the bare payload line, and re-tag every output line
    so fan-out records stay attributed to their tenant."""
    call = as_callable(fn, "flat_map")

    def tenant_flat_map(line: str):
        slot_s, payload = line.split(TENANT_SEP, 1)
        prefix = slot_s + TENANT_SEP
        return [prefix + out for out in call(payload)]

    return tenant_flat_map


class _TenantStream:
    """The DataStream the template build fn sees: every user fn is
    wrapped so the trailing tenant field stays invisible and rule
    resolution is per-tenant. Mirrors the DataStream surface the
    TenantPlan shape probe accepts.

    The underlying stream starts RAW (tagged lines, pre-parse) and is
    parsed lazily: ``flat_map`` lowers onto the raw host stage — the
    only stage the single-job planner supports it on
    (runtime/plan.py) — while the first parsed-record op (map / filter
    / assign_ts / key_by) triggers ``parse_hook`` to append the shared
    tagged parse plus the ``__tenant_active__`` liveness gate."""

    def __init__(self, stream: DataStream, rules: RuleSet,
                 parse_hook=None, parsed: bool = True):
        self._stream = stream
        self._rules = rules
        self._parse_hook = parse_hook
        self._parsed = parsed

    def _ensure_parsed(self) -> DataStream:
        if not self._parsed:
            self._stream = self._parse_hook(self._stream)
            self._parsed = True
        return self._stream

    @property
    def node(self) -> Node:
        return self._ensure_parsed().node

    @property
    def env(self):
        return self._stream.env

    def map(self, fn) -> "_TenantStream":
        return _TenantStream(
            self._ensure_parsed().map(_wrap_map(self._rules, fn)),
            self._rules,
        )

    def filter(self, fn) -> "_TenantStream":
        return _TenantStream(
            self._ensure_parsed().filter(_wrap_filter(self._rules, fn)),
            self._rules,
        )

    def flat_map(self, fn) -> "_TenantStream":
        if self._parsed:
            raise NotImplementedError(
                "flat_map on a tenant fleet stream must come before "
                "every parsed-record op (map/filter/key_by/assign_ts): "
                "the fleet lowers it onto the raw host stage, the same "
                "constraint the single-job planner enforces "
                "(runtime/plan.py)"
            )
        return _TenantStream(
            self._stream.flat_map(_wrap_raw_flat_map(fn)),
            self._rules,
            parse_hook=self._parse_hook,
            parsed=False,
        )

    flatMap = flat_map

    def assign_timestamps_and_watermarks(self, assigner) -> "_TenantStream":
        return _TenantStream(
            self._ensure_parsed().assign_timestamps_and_watermarks(assigner),
            self._rules,
        )

    assignTimestampsAndWatermarks = assign_timestamps_and_watermarks

    def key_by(self, key) -> "_TenantKeyedStream":
        # the tenant field is LAST, so positional keys are unchanged;
        # the key column itself is already tenant-namespaced at parse
        return _TenantKeyedStream(
            self._ensure_parsed().key_by(key), self._rules
        )

    keyBy = key_by


class _TenantKeyedStream(_TenantStream):
    _stream: KeyedStream

    def _rolling(self, kind: str, pos: int) -> _TenantStream:
        # rolling Flink semantics: only the aggregated field updates,
        # others keep first-seen values — within a (namespaced) key the
        # tenant field is constant, so it rides through correctly
        return _TenantStream(self._stream._rolling(kind, pos), self._rules)

    def max(self, pos: int) -> _TenantStream:
        return self._rolling("max", pos)

    def min(self, pos: int) -> _TenantStream:
        return self._rolling("min", pos)

    def sum(self, pos: int) -> _TenantStream:
        return self._rolling("sum", pos)

    def max_by(self, pos: int) -> _TenantStream:
        return self._rolling("max_by", pos)

    def min_by(self, pos: int) -> _TenantStream:
        return self._rolling("min_by", pos)

    maxBy = max_by
    minBy = min_by

    def reduce(self, fn) -> _TenantStream:
        return _TenantStream(
            self._stream.reduce(_wrap_reduce(self._rules, fn)), self._rules
        )

    def time_window(self, size, slide=None) -> "_TenantWindowedStream":
        return _TenantWindowedStream(
            self._stream.time_window(size, slide), self._rules
        )

    timeWindow = time_window

    def count_window(self, count: int, slide=None) -> "_TenantWindowedStream":
        return _TenantWindowedStream(
            self._stream.count_window(count, slide), self._rules
        )

    countWindow = count_window

    def window(self, spec) -> "_TenantWindowedStream":
        return _TenantWindowedStream(self._stream.window(spec), self._rules)


class _TenantAggregate:
    """AggregateFunction proxy for fleets: the accumulator carries the
    tenant slot as a trailing field (mirroring the record layout), so
    ``merge``/``get_result`` — which see only accumulators — can still
    bind the tenant's rule rows. The placeholder slot minted by
    ``create_accumulator`` is overwritten by the first ``add`` (the
    window runtime always lifts via ``add(value, create())``, so every
    live accumulator holds a real slot; padding rows hold garbage the
    fire mask drops)."""

    def __init__(self, rules: RuleSet, fn):
        self._rules = rules
        self._create = as_callable(fn, "create_accumulator")
        self._add = as_callable(fn, "add")
        self._merge = as_callable(fn, "merge")
        self._get_result = as_callable(fn, "get_result")

    def create_accumulator(self):
        return _pack(_vals(self._create()) + [0])

    def add(self, value, accumulator):
        vv, va = _vals(value), _vals(accumulator)
        tid = vv[-1]
        with self._rules.bound_tenant(tid):
            out = self._add(_pack(vv[:-1]), _pack(va[:-1]))
            out_vals = _vals(out)
        return _pack(out_vals + [tid])

    def merge(self, a, b):
        va, vb = _vals(a), _vals(b)
        tid = va[-1]  # same (namespaced) key -> same tenant on both
        with self._rules.bound_tenant(tid):
            out = self._merge(_pack(va[:-1]), _pack(vb[:-1]))
            out_vals = _vals(out)
        return _pack(out_vals + [tid])

    def get_result(self, accumulator):
        va = _vals(accumulator)
        tid = va[-1]
        with self._rules.bound_tenant(tid):
            out = self._get_result(_pack(va[:-1]))
            out_vals = _vals(out)
        return _pack(out_vals + [tid])

    createAccumulator = create_accumulator
    getResult = get_result


def _wrap_process(rules: RuleSet, fn):
    """ProcessWindowFunction proxy: recover the tenant slot from the
    namespaced key (host-evaluated fire, so it is a plain string),
    strip the namespace prefix and the elements' trailing tenant field,
    run the user fn under the tenant's rule binding, and re-tag every
    collected item so demux keeps working."""
    call = as_callable(fn, "process")

    def tenant_process(key, ctx, elements, out):
        elements = list(elements)
        if isinstance(key, str) and TENANT_SEP in key:
            slot_s, user_key = key.split(TENANT_SEP, 1)
            tid = int(slot_s)
        else:
            # un-namespaced key (explicit key_field=None template):
            # every element still carries its slot as the last field
            user_key = key
            tid = int(_vals(elements[0])[-1]) if elements else 0
        stripped = [_pack(_vals(e)[:-1]) for e in elements]
        inner = Collector()
        with rules.bound_tenant(tid):
            call(user_key, ctx, stripped, inner)
        for item in inner.items:
            out.collect(_pack(_vals(item) + [tid]))

    return tenant_process


class _TenantWindowedStream:
    def __init__(self, stream: WindowedStream, rules: RuleSet):
        self._stream = stream
        self._rules = rules

    def allowed_lateness(self, t) -> "_TenantWindowedStream":
        self._stream.allowed_lateness(t)
        return self

    allowedLateness = allowed_lateness

    def side_output_late_data(self, tag) -> "_TenantWindowedStream":
        self._stream.side_output_late_data(tag)
        return self

    sideOutputLateData = side_output_late_data

    def reduce(self, fn) -> _TenantStream:
        return _TenantStream(
            self._stream.reduce(_wrap_reduce(self._rules, fn)), self._rules
        )

    def aggregate(self, fn) -> _TenantStream:
        return _TenantStream(
            self._stream.aggregate(_TenantAggregate(self._rules, fn)),
            self._rules,
        )

    def process(self, fn) -> _TenantStream:
        return _TenantStream(
            self._stream.process(_wrap_process(self._rules, fn)),
            self._rules,
        )

    def sum(self, pos: int) -> _TenantStream:
        from ..api.datastream import _field_sum

        return self.reduce(_field_sum(pos))

    def max(self, pos: int) -> _TenantStream:
        from ..api.datastream import _field_extreme

        return self.reduce(_field_extreme(pos, True))

    def min(self, pos: int) -> _TenantStream:
        from ..api.datastream import _field_extreme

        return self.reduce(_field_extreme(pos, False))


class TenantDemuxHandle:
    """The fleet's single collect sink. A FLAT ``items`` list, exactly
    like CollectHandle, so checkpoint sink-count rollback (``del
    items[keep:]``) restores the fleet's output exactly-once; the
    per-tenant split happens at read time (JobServer.output)."""

    def __init__(self) -> None:
        self.items: list = []

    def append(self, item) -> None:
        self.items.append(item)


class JobServer:
    """Front-end of a multi-tenant fleet over one TenantPlan.

    Lifecycle: construct → ``add_tenant`` / ``ingest`` /
    ``update_tenant_rules`` / ``remove_tenant`` in any interleaving
    (control calls take effect at the exact stream position they were
    made at) → ``run()`` once → read ``output(tenant)`` /
    ``quota_output(tenant)``.
    """

    def __init__(
        self,
        plan: TenantPlan,
        config: Optional[StreamConfig] = None,
    ):
        self.plan = plan
        self.config = config or StreamConfig()
        plan.rules.enable_tenancy(plan.tenant_capacity)
        plan.validate_fleet_ops()
        self._key_field = plan.inferred_key_field()
        self._tenants: Dict[str, int] = {}          # tenant id -> slot
        self._active: Dict[str, bool] = {}
        self._quota: Dict[str, Optional[int]] = {}
        self._admitted: Dict[str, int] = {}
        self._rejected: Dict[str, int] = {}
        self._lines: List[str] = []                 # tagged, admission order
        self._positions: Dict[str, List[int]] = {}  # per-tenant absolute pos
        self._updates: List[RuleUpdate] = []        # the control schedule
        self._quota_log: Dict[str, List[str]] = {}
        self._handle = TenantDemuxHandle()
        self.env = None
        # -- per-tenant observability (docs/multitenancy.md) -----------
        self._slo: Dict[str, TenantSLO] = {}    # declared objectives
        self._obs = None                        # JobObs once attached
        self._rr = -1                           # marker round-robin cursor
        self._demux_scan = 0                    # _handle.items scan cursor
        self._dead_scan = 0                     # env.dead_letters cursor
        self._emitted_by_slot: Dict[int, int] = {}
        self._dead_by_slot: Dict[int, int] = {}
        self._prev_admitted: Dict[str, int] = {}  # step-share window base

    # -- fleet control (position-addressed: effective at the stream
    # -- position of the call, exactly) ---------------------------------
    def add_tenant(
        self,
        tenant: str,
        rules: Optional[Dict[str, Any]] = None,
        quota: Optional[TenantQuota] = None,
        build=None,
        slo: Optional[TenantSLO] = None,
    ) -> int:
        """Admit a tenant at the current stream position: verify its job
        shape (when it submits one), assign a slot, and schedule its
        activation + initial rule rows. An optional :class:`TenantSLO`
        declares the tenant's latency/error objectives (see
        :meth:`set_tenant_slo`). Returns the slot."""
        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already admitted")
        if build is not None:
            self.plan.verify(build)
        if slo is not None:
            self._slo[tenant] = slo
        slot = len(self._tenants)
        pos = len(self._lines)
        self._tenants[tenant] = slot
        self._active[tenant] = True
        self._quota[tenant] = quota.max_records if quota is not None else None
        self._admitted[tenant] = 0
        self._rejected[tenant] = 0
        self._positions[tenant] = []
        self._quota_log[tenant] = []
        for name, value in (rules or {}).items():
            self._updates.append(RuleUpdate(name, value, pos, tenant=slot))
        self._updates.append(
            RuleUpdate(TENANT_ACTIVE_RULE, True, pos, tenant=slot)
        )
        return slot

    addTenant = add_tenant

    def update_tenant_rules(
        self, tenant: str, rules: Dict[str, Any],
        after_records: Optional[int] = None,
    ) -> None:
        """Schedule rule-row writes for one tenant, effective at the
        current stream position (or an explicit absolute one)."""
        slot = self._slot(tenant)
        pos = len(self._lines) if after_records is None else after_records
        for name, value in rules.items():
            self._updates.append(RuleUpdate(name, value, pos, tenant=slot))

    updateTenantRules = update_tenant_rules

    def remove_tenant(self, tenant: str) -> None:
        """Deactivate at the current stream position: later records of
        this tenant drop inside the device step (active-row gather), no
        program rebuild. The slot and tenant id are retained — earlier
        output stays addressable; re-admitting the same id raises."""
        slot = self._slot(tenant)
        self._active[tenant] = False
        self._updates.append(
            RuleUpdate(
                TENANT_ACTIVE_RULE, False, len(self._lines), tenant=slot
            )
        )

    removeTenant = remove_tenant

    def ingest(self, tenant: str, lines: Sequence[str]) -> int:
        """Route records into the shared stream; over-quota lines divert
        to the tenant's quota_exceeded side output. Returns the number
        admitted."""
        slot = self._slot(tenant)
        tag = f"{slot}{TENANT_SEP}"
        quota = self._quota[tenant]
        n = 0
        for line in lines:
            if quota is not None and self._admitted[tenant] >= quota:
                self._rejected[tenant] += 1
                self._quota_log[tenant].append(line)
                continue
            self._positions[tenant].append(len(self._lines))
            self._lines.append(tag + line)
            self._admitted[tenant] += 1
            n += 1
        return n

    def position(self, tenant: str, n: int) -> int:
        """Absolute stream position of the tenant's n-th ADMITTED
        record — the coordinate update_tenant_rules(after_records=...)
        speaks."""
        return self._positions[tenant][n]

    def tenants(self) -> List[str]:
        return list(self._tenants)

    def tenant_label(self, slot: int) -> str:
        """Obs label for a slot: the tenant id, or the slot number for
        a slot no admitted tenant maps to."""
        for tenant, s in self._tenants.items():
            if s == slot:
                return tenant
        return str(slot)

    def _slot(self, tenant: str) -> int:
        try:
            return self._tenants[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r}; admitted: {sorted(self._tenants)}"
            ) from None

    # -- execution -------------------------------------------------------
    def _parse_tagged(self, line: str):
        """The fleet's host parse: split the tenant tag, run the shared
        template parse, fold the slot into the key namespace, and append
        the slot as the trailing i64 field."""
        slot_s, payload = line.split(TENANT_SEP, 1)
        slot = int(slot_s)
        vals = _vals(self.plan.parse(payload))
        kf = self._key_field
        if kf is not None:
            key = vals[kf]
            if not isinstance(key, str):
                raise TypeError(
                    f"tenant key field {kf} must parse to str (the key "
                    f"namespace folds the tenant id into it), got "
                    f"{type(key).__name__}"
                )
            vals[kf] = f"{slot}{TENANT_SEP}{key}"
        vals.append(slot)
        return _pack(vals)

    def build_job(self, env) -> None:
        """Wire the fleet onto ``env``: tagged data source, control
        schedule as the broadcast stream, wrapped template chain behind
        the active-row gate, demux collect sink."""
        from ..runtime.sources import ReplaySource

        rules = self.plan.rules
        env._tenancy = self
        env.add_source(ReplaySource(list(self._updates))).broadcast(rules)

        def _attach_parse(raw: DataStream) -> DataStream:
            # the shared tagged parse, then the liveness gate: resolves
            # per record to the tenant's __tenant_active__ row; removed
            # tenants' rows drop here
            parsed = raw.map(self._parse_tagged)
            active = rules.param(TENANT_ACTIVE_RULE)
            return parsed.filter(
                _wrap_filter(
                    rules, lambda _rec: as_tensor(active).to(torch.bool)
                )
            )

        # the stream starts RAW so template flat_map lowers onto the
        # host stage; the first parsed-record op attaches the parse
        stream = _TenantStream(
            env.from_collection(self._lines),
            rules,
            parse_hook=_attach_parse,
            parsed=False,
        )
        out = self.plan.build(stream, rules)
        node = Node("sink_collect", out.node, {"handle": self._handle})
        env._register_sink(node)

    def run(self, job_name: str = "tenant fleet", restart_strategy=None):
        """Build the env (once) and execute the fleet to exhaustion."""
        from ..api.environment import StreamExecutionEnvironment

        if self.env is None:
            self.env = StreamExecutionEnvironment(self.config)
            if restart_strategy is not None:
                self.env.set_restart_strategy(restart_strategy)
            self.build_job(self.env)
        result = self.env.execute(job_name)
        self._mint_obs(job_name)
        return result

    def _mint_obs(self, job_name: str) -> None:
        """Post-run per-tenant series (docs/observability.md): fleet
        size plus per-tenant admission/quota counters for every ACTIVE
        tenant — removed tenants' series were retired at their removal
        boundary and must not resurrect here."""
        metrics = getattr(self.env, "metrics", None)
        registry = getattr(metrics, "registry", None)
        if registry is None:
            return
        g = registry.group(job=job_name)
        g.gauge("tenant_count").set(
            sum(1 for t in self._tenants if self._active[t])
        )
        for tenant in self._tenants:
            if not self._active[tenant]:
                continue
            tg = g.group(tenant=self._obs_label(tenant))
            tg.counter("tenant_records_total").set_total(
                self._admitted[tenant]
            )
            tg.counter("tenant_quota_exceeded_total").set_total(
                self._rejected[tenant]
            )

    # -- per-tenant SLO observability (docs/multitenancy.md) -------------
    def set_tenant_slo(self, tenant: str, slo: Optional[TenantSLO]) -> None:
        """Declare (or clear, with None) one tenant's SLO. Compiled into
        per-tenant health rules when the fleet's obs root attaches — or
        immediately, when it already has."""
        self._slot(tenant)
        if slo is None:
            self._slo.pop(tenant, None)
        else:
            self._slo[tenant] = slo
        obs = self._obs
        if obs is None or not getattr(obs, "enabled", False):
            return
        engine = obs.ensure_health()
        engine.remove_rules(slo_rule_names(tenant))
        if slo is not None:
            engine.add_rules(compile_tenant_slo(tenant, slo))

    setTenantSLO = set_tenant_slo

    def on_obs_attached(self, job_obs) -> None:
        """JobObs.attach_tenancy calls back here once per attempt: keep
        the obs root, reset the incremental demux cursors (a supervised
        restart replays the handle from its rollback point), and compile
        every declared SLO into the engine."""
        self._obs = job_obs
        self._demux_scan = 0
        self._dead_scan = 0
        self._emitted_by_slot = {}
        self._dead_by_slot = {}
        self._prev_admitted = {}
        if not getattr(job_obs, "enabled", False):
            return
        slos = {t: s for t, s in self._slo.items() if self._active.get(t)}
        if slos:
            engine = job_obs.ensure_health()
            for tenant, slo in slos.items():
                engine.remove_rules(slo_rule_names(tenant))
                engine.add_rules(compile_tenant_slo(tenant, slo))

    def _bounded_labels(self) -> List[str]:
        """Active tenants that get their OWN series label value, plus
        ``__other__`` when the fleet overflows
        ``ObsConfig.tenant_series_topk`` (0 = unbounded). Ranking is by
        admitted records (the attribution that matters for a noisy
        fleet), tenant id as the tiebreak."""
        active = [t for t in self._tenants if self._active[t]]
        k = int(getattr(self.config.obs, "tenant_series_topk", 0) or 0)
        if k <= 0 or len(active) <= k:
            return active
        ranked = sorted(active, key=lambda t: (-self._admitted[t], t))
        return ranked[:k] + [OTHER_TENANT]

    def _obs_label(self, tenant: str) -> str:
        labels = self._bounded_labels()
        return tenant if tenant in labels else OTHER_TENANT

    def marker_tenant_provider(self):
        """Round-robin tenant labeler for the source MarkerStamper: each
        minted latency marker is attributed to the next bounded label,
        so every active tenant's ``tenant_e2e_latency_ms`` series keeps
        filling at 1/N of the marker rate."""

        def next_tenant() -> Optional[str]:
            labels = self._bounded_labels()
            if not labels:
                return None
            self._rr = (self._rr + 1) % len(labels)
            return labels[self._rr]

        return next_tenant

    def refresh_obs(self) -> None:
        """Snapshot pre-hook (obs/snapshot.py): refresh every derived
        per-tenant series so each snapshot/scrape sees current values.
        Incremental — the demux handle and dead-letter list are scanned
        from the previous cursor, never from zero."""
        obs = self._obs
        if obs is None or not getattr(obs, "enabled", False):
            return
        g = obs.group
        active = [t for t in self._tenants if self._active[t]]
        g.gauge("tenant_count").set(len(active))
        # emitted records, attributed by the trailing slot field
        items = self._handle.items
        for item in items[self._demux_scan:]:
            try:
                slot = int(_vals(item)[-1])
            except (TypeError, ValueError, IndexError):
                continue
            self._emitted_by_slot[slot] = (
                self._emitted_by_slot.get(slot, 0) + 1
            )
        self._demux_scan = len(items)
        # dead letters carry the admission tag prefix on the raw line
        dead = getattr(self.env, "dead_letters", None) or []
        for entry in dead[self._dead_scan:]:
            line = entry[0] if isinstance(entry, tuple) else str(entry)
            if TENANT_SEP not in line:
                continue
            try:
                slot = int(line.split(TENANT_SEP, 1)[0])
            except ValueError:
                continue
            self._dead_by_slot[slot] = self._dead_by_slot.get(slot, 0) + 1
        self._dead_scan = len(dead)
        # keyed-state attribution from every runner's key namespace
        # (obs/memory.py's state trackers)
        state: Dict[int, Dict[str, int]] = {}
        for tracker in getattr(obs, "state_trackers", ()):
            for slot, entry in tracker.tenant_breakdown().items():
                agg = state.setdefault(slot, {"keys": 0, "hbm_bytes": 0})
                agg["keys"] += entry["keys"]
                agg["hbm_bytes"] += entry["hbm_bytes"]
        # fold per-tenant numbers into the bounded label buckets
        totals: Dict[str, Dict[str, float]] = {}
        window_total = 0
        for tenant in active:
            slot = self._tenants[tenant]
            label = self._obs_label(tenant)
            agg = totals.setdefault(
                label,
                {
                    "admitted": 0, "rejected": 0, "emitted": 0,
                    "dead": 0, "keys": 0, "hbm": 0, "delta": 0,
                },
            )
            agg["admitted"] += self._admitted[tenant]
            agg["rejected"] += self._rejected[tenant]
            agg["emitted"] += self._emitted_by_slot.get(slot, 0)
            agg["dead"] += self._dead_by_slot.get(slot, 0)
            st = state.get(slot)
            if st is not None:
                agg["keys"] += st["keys"]
                agg["hbm"] += st["hbm_bytes"]
            delta = self._admitted[tenant] - self._prev_admitted.get(
                tenant, 0
            )
            agg["delta"] += delta
            window_total += delta
        for label, agg in totals.items():
            tg = g.group(tenant=label)
            tg.counter("tenant_records_total").set_total(agg["admitted"])
            tg.counter("tenant_quota_exceeded_total").set_total(
                agg["rejected"]
            )
            tg.counter("tenant_emitted_total").set_total(agg["emitted"])
            tg.counter("tenant_dead_letter_total").set_total(agg["dead"])
            offered = agg["admitted"] + agg["rejected"]
            tg.gauge("tenant_error_rate").set(
                (agg["rejected"] + agg["dead"]) / offered if offered else 0.0
            )
            tg.gauge("tenant_step_share").set(
                agg["delta"] / window_total if window_total else 0.0
            )
            tg.gauge("tenant_state_keys").set(agg["keys"])
            tg.gauge("tenant_hbm_state_bytes").set(agg["hbm"])
        self._prev_admitted = {t: self._admitted[t] for t in active}

    def retire_tenant_obs(self, slot: int, job_obs) -> None:
        """A tenant's removal landed at its record boundary: drop every
        series labeled with the tenant and its compiled SLO rules, so
        scrapes stop carrying gauges for a job that no longer exists
        (the fix for lingering ``tenant_rule_version`` gauges)."""
        label = self.tenant_label(slot)
        registry = getattr(job_obs, "registry", None)
        n = (
            registry.retire(labels={"tenant": label})
            if registry is not None
            else 0
        )
        health = getattr(job_obs, "health", None)
        if health is not None:
            health.remove_rules(slo_rule_names(label))
        job_obs.flight.record(
            "tenant_obs_retired", tenant=label, slot=slot, series=n
        )

    def tenants_snapshot(self) -> dict:
        """The ``/tenants.json`` body: one entry per tenant (active and
        removed) with admission/emit/error attribution, the declared
        SLO, its compiled rules' live health levels, and budget burn."""
        self.refresh_obs()
        obs = self._obs
        health_rules: Dict[str, dict] = {}
        if obs is not None and getattr(obs, "health", None) is not None:
            health_rules = {
                r["rule"]: r for r in obs.health.state().get("rules", [])
            }
        p99 = {}
        if obs is not None and getattr(obs, "enabled", False):
            registry = obs.registry
            base = dict(obs.group.labels)
            for label in self._bounded_labels():
                hist = registry.find(
                    "tenant_e2e_latency_ms", {**base, "tenant": label}
                )
                if hist is not None:
                    p99[label] = round(hist.percentile(99), 3)
        tenants = {}
        for tenant, slot in self._tenants.items():
            offered = self._admitted[tenant] + self._rejected[tenant]
            dead = self._dead_by_slot.get(slot, 0)
            entry = {
                "slot": slot,
                "active": self._active[tenant],
                "admitted": self._admitted[tenant],
                "quota_exceeded": self._rejected[tenant],
                "emitted": self._emitted_by_slot.get(slot, 0),
                "dead_letters": dead,
                "error_rate": (
                    (self._rejected[tenant] + dead) / offered
                    if offered else 0.0
                ),
                "label": self._obs_label(tenant),
            }
            if tenant in p99:
                entry["e2e_p99_ms"] = p99[tenant]
            slo = self._slo.get(tenant)
            if slo is not None:
                entry["slo"] = {
                    "p99_ms": slo.p99_ms,
                    "max_error_rate": slo.max_error_rate,
                    "budget_window_s": slo.budget_window_s,
                }
                rules = {}
                for name in slo_rule_names(tenant):
                    st = health_rules.get(name)
                    if st is not None:
                        rules[name] = {
                            "level": st.get("level"),
                            "budget_burn": st.get("budget_burn"),
                        }
                if rules:
                    entry["health"] = rules
            tenants[tenant] = entry
        return {
            "tenant_count": sum(
                1 for t in self._tenants if self._active[t]
            ),
            "series_topk": int(
                getattr(self.config.obs, "tenant_series_topk", 0) or 0
            ),
            "tenants": tenants,
        }

    tenantsSnapshot = tenants_snapshot

    # -- output demux ----------------------------------------------------
    def _strip(self, vals: List[Any], slot: int) -> List[Any]:
        prefix = f"{slot}{TENANT_SEP}"
        return [
            v[len(prefix):]
            if isinstance(v, str) and v.startswith(prefix)
            else v
            for v in vals
        ]

    def output(self, tenant: str) -> list:
        """This tenant's records from the shared sink, namespace
        stripped — byte-identical to a solo run of its job."""
        slot = self._slot(tenant)
        return self._demux({slot})[slot]

    def outputs(self) -> Dict[str, list]:
        """Every tenant's :meth:`output` (active and removed tenants),
        from one pass over the shared sink."""
        by_slot = self._demux(set(self._tenants.values()))
        return {t: by_slot[s] for t, s in self._tenants.items()}

    def _demux(self, slots) -> Dict[int, list]:
        out = {s: [] for s in slots}
        for item in self._handle.items:
            vals = _vals(item)
            slot = int(vals[-1])
            rows = out.get(slot)
            if rows is not None:
                rows.append(_pack(self._strip(vals[:-1], slot)))
        return out

    def quota_output(self, tenant: str) -> List[str]:
        """The tenant's quota_exceeded side output: raw lines diverted
        at admission."""
        self._slot(tenant)
        return list(self._quota_log[tenant])

    # -- checkpoint integration -----------------------------------------
    def state_dict(self) -> dict:
        """Host fleet state for checkpoint meta (the per-tenant rule
        VECTORS ride RuleSet.values() separately)."""
        return {
            "capacity": self.plan.rules.tenant_capacity,
            "tenants": dict(self._tenants),
            "active": dict(self._active),
            "quota": dict(self._quota),
            "admitted": dict(self._admitted),
            "rejected": dict(self._rejected),
        }

    def load_state_dict(self, state: dict) -> None:
        cap = int(state.get("capacity", 0))
        if cap:
            self.plan.rules.enable_tenancy(cap)
        self._tenants = {k: int(v) for k, v in state["tenants"].items()}
        self._active = dict(state.get("active", {}))
        self._quota = dict(state.get("quota", {}))
        self._admitted = {
            k: int(v) for k, v in state.get("admitted", {}).items()
        }
        self._rejected = {
            k: int(v) for k, v in state.get("rejected", {}).items()
        }

"""Dynamic rules: operator parameters as device data, not build constants.

Counterpart of tpustream/broadcast/rules.py, on torch tensors.

The reference tutorial bakes every threshold into the job at build time
(``usage > 90`` at chapter1/.../Main.java:27-33); Flink's production
answer is broadcast state — a control stream whose rule updates reach
every parallel instance and are checkpointed with the job. Here the
runtime half of that pattern: a :class:`RuleSet` declares named dynamic
parameters, each materialized as a 0-d tensor on the program's device
riding its state (``state["__rules__"][name]``). User functions hold a
:class:`RuleParam` handle that resolves *contextually*:

* inside a program step (``RuleSet.bound`` active) it resolves to the
  state's tensor, so ``value.f2 > param`` reads DATA — updating the rule
  later writes that tensor, and no program is rebuilt;
* everywhere else (DeviceChain output inference at build time, host-side
  oracles in tests) it resolves to the current host value.

A ``RuleParam`` works on either side of a torch operator: its reflected
dunders resolve it when a tensor's own operator declines, and its
``__torch_function__`` resolves it inside any torch function
(``torch.where``, ``torch.as_tensor``, ...). ``tensor / param`` is an
IEEE division, as the JAX package's division by a traced leaf is (the
reciprocal rewrite of ``tpustream_torch.arith`` applies to Python
numbers only).

``version`` counts applied updates monotonically; it rides the state as
``state["__rule_version__"]``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

F64 = "f64"
I64 = "i64"
BOOL = "bool"

# Reserved per-tenant liveness flag: rows of a removed tenant are dropped
# by a filter on this rule, so remove_tenant is a buffer write, not a
# rebuild. Declared automatically by RuleSet.enable_tenancy().
TENANT_ACTIVE_RULE = "__tenant_active__"

# Key under which per-tenant vectors ride RuleSet.values() / load() —
# checkpoints carry the whole tenant rule table through the existing
# rule_values meta field without a schema change of their own.
TENANT_VALUES_KEY = "__tenant__"

def _to_bool(v) -> bool:
    # control lines arrive as text: "false"/"off"/"0" must not truthy
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


_KIND_DTYPES = {F64: torch.float64, I64: torch.int64, BOOL: torch.bool}
_KIND_COERCE = {F64: float, I64: lambda v: int(float(v)), BOOL: _to_bool}


@dataclass(frozen=True)
class RuleDescriptor:
    """Declares one dynamic operator parameter: a name, its initial
    value, and the device dtype it travels as ("f64"/"i64"/"bool")."""

    name: str
    default: Any
    kind: str = F64
    description: str = ""

    def __post_init__(self):
        if self.kind not in _KIND_DTYPES:
            raise ValueError(
                f"rule {self.name!r}: kind must be one of "
                f"{sorted(_KIND_DTYPES)}, got {self.kind!r}"
            )
        if not self.name or not isinstance(self.name, str):
            raise ValueError("a rule needs a non-empty string name")


@dataclass(frozen=True)
class RuleUpdate:
    """One control-stream record: set ``name`` to ``value`` for every
    data record with stream position >= ``after_records`` (0-based
    absolute index into the source). Position-addressed updates keep the
    schedule replay-deterministic across restarts and batch sizes."""

    name: str
    value: Any
    after_records: int = 0
    #: None = a global update (every tenant slot); an int = that tenant's
    #: slot only. Scoped updates are what make one control feed serve a
    #: whole fleet — same barriers, same replay determinism.
    tenant: Optional[int] = None


class RuleParam:
    """A handle to one rule value, usable directly in map/filter/CEP
    predicates. Resolution is contextual — see the module docstring."""

    __slots__ = ("_rules", "_name")

    def __init__(self, rules: "RuleSet", name: str):
        self._rules = rules
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def _resolve(self):
        leaf = self._rules._bound_leaf(self._name)
        if leaf is not None:
            return leaf
        desc = self._rules.descriptor(self._name)
        # host-side per-tenant resolution: a fleet's HOST-evaluated fns
        # (window process() fires) run under bound_tenant with a plain
        # int slot but no bound step leaves — resolve that tenant's row.
        # A slot vector (build-time output inference) falls through to
        # the scalar host value, as before.
        tid = getattr(self._rules._tls, "tenant", None)
        if tid is not None and self._rules.tenant_capacity:
            try:
                return torch.tensor(
                    self._rules.tenant_value(self._name, int(tid)),
                    dtype=_KIND_DTYPES[desc.kind],
                )
            except (TypeError, ValueError, RuntimeError):
                pass  # a slot vector: not one tenant's row
        return torch.tensor(self._rules.value(self._name),
                            dtype=_KIND_DTYPES[desc.kind])

    # torch functions given a RuleParam (torch.where, torch.as_tensor,
    # and a tensor's operators) resolve it to its tensor first
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        def res(a):
            if isinstance(a, RuleParam):
                return a._resolve()
            if isinstance(a, (list, tuple)):
                return type(a)(res(x) for x in a)
            return a

        return func(*res(tuple(args)), **{k: res(v) for k, v in (kwargs or {}).items()})

    def __repr__(self):
        return f"RuleParam({self._name}={self._rules.value(self._name)!r})"

    def __float__(self):
        return float(self._rules.value(self._name))

    def __int__(self):
        return int(self._rules.value(self._name))

    def __bool__(self):
        return bool(self._rules.value(self._name))

    # arithmetic / comparison dunders delegate to the resolved value
    def __add__(self, o): return self._resolve() + o
    def __radd__(self, o): return o + self._resolve()
    def __sub__(self, o): return self._resolve() - o
    def __rsub__(self, o): return o - self._resolve()
    def __mul__(self, o): return self._resolve() * o
    def __rmul__(self, o): return o * self._resolve()
    def __truediv__(self, o): return self._resolve() / o
    def __rtruediv__(self, o): return o / self._resolve()
    def __floordiv__(self, o): return self._resolve() // o
    def __rfloordiv__(self, o): return o // self._resolve()
    def __mod__(self, o): return self._resolve() % o
    def __rmod__(self, o): return o % self._resolve()
    def __neg__(self): return -self._resolve()
    def __abs__(self): return abs(self._resolve())
    def __lt__(self, o): return self._resolve() < o
    def __le__(self, o): return self._resolve() <= o
    def __gt__(self, o): return self._resolve() > o
    def __ge__(self, o): return self._resolve() >= o
    def __eq__(self, o): return self._resolve() == o  # type: ignore[override]
    def __ne__(self, o): return self._resolve() != o  # type: ignore[override]

    def __hash__(self):  # pragma: no cover - params aren't dict keys
        raise TypeError("RuleParam is not hashable")


class RuleSet:
    """An ordered set of dynamic rules with a monotonic version.

    ``version`` is the COUNT of updates applied so far — after a restore
    the control feed skips exactly the first ``version`` scheduled
    updates, which is what makes crash-replay of rule application
    idempotent (values are absolute, not increments).
    """

    def __init__(self, *descriptors: RuleDescriptor):
        self._desc: Dict[str, RuleDescriptor] = {}
        self._values: Dict[str, Any] = {}
        #: 0 = scalar mode (0-d leaves). > 0 = tenant
        #: mode: every rule is a [tenant_capacity] vector leaf and each
        #: record's row is gathered by its tenant slot inside the step.
        self.tenant_capacity = 0
        self._tenant_values: Dict[str, list] = {}
        self.version = 0
        self._tls = threading.local()
        for d in descriptors:
            self._add(d)

    def _add(self, d: RuleDescriptor) -> RuleParam:
        if d.name in self._desc:
            raise ValueError(f"rule {d.name!r} declared twice")
        self._desc[d.name] = d
        self._values[d.name] = _KIND_COERCE[d.kind](d.default)
        if self.tenant_capacity:
            self._tenant_values[d.name] = (
                [self._values[d.name]] * self.tenant_capacity
            )
        return RuleParam(self, d.name)

    # ---- multi-tenant vector mode -------------------------------------
    def enable_tenancy(self, capacity: int = 64) -> None:
        """Switch every rule leaf from a 0-d scalar to a [capacity]
        vector (capacity rounded up to a power of two so growth follows
        the key-table doubling discipline). Slots start at the scalar
        value; the reserved ``__tenant_active__`` BOOL rule is declared
        with default False so unclaimed slots contribute nothing."""
        if capacity < 1:
            raise ValueError(f"tenant capacity must be >= 1, got {capacity}")
        cap = 1
        while cap < capacity:
            cap *= 2
        if TENANT_ACTIVE_RULE not in self._desc:
            self._add(RuleDescriptor(
                TENANT_ACTIVE_RULE, False, BOOL,
                "reserved: per-tenant liveness mask",
            ))
        if self.tenant_capacity and cap <= self.tenant_capacity:
            return
        old = self.tenant_capacity
        self.tenant_capacity = cap
        for name in self._desc:
            have = self._tenant_values.get(name, []) if old else []
            fill = [self._values[name]] * (cap - len(have))
            self._tenant_values[name] = list(have) + fill

    def ensure_tenant_slot(self, slot: int) -> None:
        """Grow (doubling) until ``slot`` is addressable. A capacity
        change alters leaf SHAPES, so a program's rule leaves must then
        be replaced, not written in place."""
        if not self.tenant_capacity:
            raise RuntimeError("enable_tenancy() before addressing slots")
        if slot < 0:
            raise ValueError(f"tenant slot must be >= 0, got {slot}")
        cap = self.tenant_capacity
        while slot >= cap:
            cap *= 2
        if cap != self.tenant_capacity:
            self.enable_tenancy(cap)

    def declare(self, name: str, default: Any, kind: str = F64,
                description: str = "") -> RuleParam:
        """Declare a rule and return its :class:`RuleParam` handle."""
        return self._add(RuleDescriptor(name, default, kind, description))

    def param(self, name: str) -> RuleParam:
        self.descriptor(name)
        return RuleParam(self, name)

    def descriptor(self, name: str) -> RuleDescriptor:
        try:
            return self._desc[name]
        except KeyError:
            raise KeyError(
                f"unknown rule {name!r}; declared: {sorted(self._desc)}"
            ) from None

    def names(self) -> Tuple[str, ...]:
        """Rule names in the canonical (sorted) state order."""
        return tuple(sorted(self._desc))

    def value(self, name: str):
        self.descriptor(name)
        return self._values[name]

    def values(self) -> Dict[str, Any]:
        out = dict(self._values)
        if self.tenant_capacity:
            out[TENANT_VALUES_KEY] = {
                "capacity": self.tenant_capacity,
                "vectors": {
                    name: list(vec)
                    for name, vec in self._tenant_values.items()
                },
            }
        return out

    def __len__(self) -> int:
        return len(self._desc)

    def __contains__(self, name: str) -> bool:
        return name in self._desc

    def apply(self, update: RuleUpdate) -> None:
        """Apply one update to the host-side values and bump version."""
        d = self.descriptor(update.name)
        v = _KIND_COERCE[d.kind](update.value)
        if update.tenant is not None:
            if not self.tenant_capacity:
                raise RuntimeError(
                    f"tenant-scoped update for {update.name!r} but "
                    "tenancy is not enabled on this RuleSet"
                )
            self.ensure_tenant_slot(update.tenant)
            self._tenant_values[update.name][update.tenant] = v
        else:
            self._values[update.name] = v
            if self.tenant_capacity:
                # a global update reaches every tenant, claimed or not
                self._tenant_values[update.name] = (
                    [v] * self.tenant_capacity
                )
        self.version += 1

    def tenant_value(self, name: str, slot: int):
        """Host-side value of one rule for one tenant slot."""
        self.descriptor(name)
        if not self.tenant_capacity:
            return self._values[name]
        return self._tenant_values[name][slot]

    def reset(self) -> None:
        """Back to the declared defaults at version 0. A from-scratch
        restart replays the data stream from record 0, so the rule
        timeline must replay with it — the control feed re-applies
        every update (tenant-scoped ones included) at its original
        record boundary. Tenant CAPACITY is kept: the replayed schedule
        addresses the same slots, and shrinking leaves mid-restart would
        force an untagged rebuild."""
        for name, d in self._desc.items():
            self._values[name] = _KIND_COERCE[d.kind](d.default)
            if self.tenant_capacity:
                self._tenant_values[name] = (
                    [self._values[name]] * self.tenant_capacity
                )
        self.version = 0

    def load(self, values: Dict[str, Any], version: int) -> None:
        """Restore host values + version from a checkpoint."""
        values = dict(values)
        tenant = values.pop(TENANT_VALUES_KEY, None)
        for name, v in values.items():
            if name in self._desc:
                self._values[name] = _KIND_COERCE[self._desc[name].kind](v)
        if tenant:
            self.enable_tenancy(int(tenant.get("capacity", 1)))
            for name, vec in tenant.get("vectors", {}).items():
                if name in self._desc:
                    co = _KIND_COERCE[self._desc[name].kind]
                    vec = [co(v) for v in vec]
                    # pad to capacity with the scalar fallback
                    pad = self.tenant_capacity - len(vec)
                    if pad > 0:
                        vec = vec + [self._values[name]] * pad
                    self._tenant_values[name] = vec[: self.tenant_capacity]
        self.version = int(version)

    def device_leaves(self, device=None) -> Dict[str, Any]:
        """The rule leaves of the CURRENT values on ``device``: {name: 0-d
        tensor} in scalar mode, {name: [tenant_capacity] tensor} in
        tenant mode."""
        vals = self._tenant_values if self.tenant_capacity else self._values
        return {
            name: torch.tensor(
                vals[name], dtype=_KIND_DTYPES[self._desc[name].kind],
                device=device,
            )
            for name in self.names()
        }

    # ---- step-time binding --------------------------------------------
    @contextmanager
    def bound(self, leaves: Dict[str, Any]):
        """Bind {name: leaf} for the duration of a program step: every
        RuleParam of this set resolves to its leaf inside the block."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(leaves)
        try:
            yield
        finally:
            stack.pop()

    @contextmanager
    def bound_tenant(self, tid):
        """Bind the records' tenant slots for the duration of one user
        fn call inside a step. While active, a RuleParam whose bound
        leaf is a [T] vector resolves to ``leaf[tid]``: with ``tid`` a
        [B] tensor of slots, one gather a rule, so N tenants share one
        program."""
        prev = getattr(self._tls, "tenant", None)
        self._tls.tenant = tid
        try:
            yield
        finally:
            self._tls.tenant = prev

    def _bound_leaf(self, name: str):
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return None
        leaf = stack[-1].get(name)
        if leaf is None:
            return None
        tid = getattr(self._tls, "tenant", None)
        if tid is not None and getattr(leaf, "ndim", 0) == 1:
            idx = torch.clamp(
                torch.as_tensor(tid, device=leaf.device).to(torch.int64),
                0, leaf.shape[0] - 1,
            )
            return leaf[idx]
        return leaf

    def get_version(self) -> int:
        return self.version

    # Flink-flavored camelCase aliases (javacompat surface)
    getParam = param
    getValue = value
    getVersion = get_version

"""Dataflow conservation ledger: per-edge record accounting + digests.

Counterpart of tpustream/obs/ledger.py (the port's own copy, on the
port's ``api/tuples._java_str``).

The framework's headline contract — byte-identical output across
recovery, ingest lanes, and sharding — is proven in CI by ad-hoc sha256
comparisons. This module makes that contract an always-on observability
plane, the way Flink's continuous ``numRecordsIn/Out`` accounting does:

* **Conservation accounting** — the executor reports record counts on
  every edge where conservation is a *theorem*, and the ledger evaluates
  the declared invariant per snapshot tick:

  - ``source``:   offered + flat_map_out
                  == admitted + quarantined + host_dropped + flat_map_in
  - ``chain:<op>``: rows handed to a chained stage
                  == rows received + rows still buffered at the hand-off
  - ``sink<i>`` / ``side:<tag>``: rows reaching the branch
                  == rows emitted + rows its map/filter tail dropped
  - ``contents:<sink>``: rows appended to a re-derivable sink
                  == growth of its retained contents (a hand-tampered
                  sink trips this one)

  Residuals land as ``ledger_conservation_residual{edge=...}`` gauges;
  the first nonzero residual on an edge latches one
  ``ledger_violations_total`` increment and a ``ledger_violation``
  flight breadcrumb, and the executor auto-installs a CRIT health rule
  over that counter — so a lost or duplicated record is an alert, not a
  diff in some later test run. The operator in/out table across an
  *aggregating* device stage is intentionally NOT an invariant (100
  records in, 1 window result out is correct); those counters stay
  informational in the registry.

* **Checkpoint-anchored digests** — every re-derivable sink (collect
  handles, the dead-letter list, print line buffers, tenant demux
  handles) folds each appended row into an incremental order-sensitive
  sha256. Checkpoints carry the per-sink ``(count, digest)`` anchors in
  meta (an optional key beside the ingest cursor — no format bump);
  after a supervised restore truncates the sinks back to the snapshot,
  :meth:`ConservationLedger.on_restore` re-derives each digest over the
  truncated contents and flags any mismatch
  (``ledger_restore_digest_mismatch`` breadcrumb + the same CRIT rule),
  so recovery *proves* byte parity live instead of assuming it.

Lifecycle: one ledger per execution attempt, built by ``_execute_job``
right after JobObs when ``ObsConfig.ledger`` resolves on (None = auto:
on whenever obs is on). Forced off under multi-host execution — local
counts are partial there. Per-record work is a handful of int adds and
(with ``ledger_digests``) one hash update per emitted row; everything
else happens at snapshot cadence.

Threading: source-edge terms are written by the parse-ahead thread, so
they commit through one per-batch ``account_source`` call under a lock
the evaluator shares — residuals read a consistent cut, never a torn
mid-batch one. All sink/chain terms are main-thread only.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, List, Optional

from ..api.tuples import _java_str

#: Series the ledger mints (obs/catalog.py lists both).
RESIDUAL_SERIES = "ledger_conservation_residual"
VIOLATIONS_SERIES = "ledger_violations_total"


def ledger_effective(obs_cfg) -> bool:
    """Whether the ledger runs for this config. ``ObsConfig.ledger`` is
    tri-state: None = auto (on whenever obs is on), True/False explicit.
    The ledger can never run without obs (it lives on the registry), so
    an explicit True with obs off is dead config — analyzer rule TSM051
    reports it; this helper just answers "will it run"."""
    if not bool(getattr(obs_cfg, "enabled", False)):
        return False
    return getattr(obs_cfg, "ledger", None) is not False


def encode_row(value) -> bytes:
    """Canonical digest encoding of one sink row: the exact formatting
    PrintSink uses (strings verbatim, ``_FIELDS`` records via repr,
    everything else Java-``toString`` style), newline-framed so the
    rolling digest is order- and boundary-sensitive."""
    if isinstance(value, str):
        body = value
    elif hasattr(value, "_FIELDS"):
        body = repr(value)
    else:
        body = _java_str(value)
    return body.encode("utf-8", "replace") + b"\n"


class SinkAccount:
    """Per-sink ledger account: emitted-row count + rolling digest.

    ``contents_fn`` returns the sink's retained contents list when the
    sink is re-derivable (collect handle ``.items``, PrintSink
    ``.lines``, the dead-letter list); the digest then always equals a
    fresh sha256 over the whole list, because folds read the appended
    tail element — so a restore can re-derive and compare.  None marks
    an opaque sink (FnSink): the digest folds forward from empty and the
    anchor is informational only. ``persistent`` marks contents that
    outlive a restart attempt (env-owned collect handles, dead letters)
    — only those are verified against restored checkpoint anchors; a
    PrintSink's line buffer is rebuilt empty each attempt.
    """

    __slots__ = ("name", "contents_fn", "persistent", "digests",
                 "count", "base", "_hasher")

    def __init__(self, name: str, contents_fn: Optional[Callable],
                 persistent: bool = False, digests: bool = True):
        self.name = name
        self.contents_fn = contents_fn
        self.persistent = bool(persistent)
        self.digests = bool(digests)
        self.count = 0   # rows folded since registration / reseed
        self.base = 0    # contents length at registration / reseed
        self._hasher = hashlib.sha256() if self.digests else None
        if contents_fn is not None:
            self.reseed()

    @property
    def verifiable(self) -> bool:
        return self.contents_fn is not None and self.persistent

    def reseed(self) -> None:
        """Re-anchor on the sink's CURRENT contents: digest over the
        whole list, zero rows counted since."""
        contents = list(self.contents_fn()) if self.contents_fn else []
        self.base = len(contents)
        self.count = 0
        if self.digests:
            h = hashlib.sha256()
            for v in contents:
                h.update(encode_row(v))
            self._hasher = h

    def fold_tail(self) -> None:
        """One row was appended to the retained contents: fold it."""
        self.count += 1
        if self._hasher is not None:
            c = self.contents_fn()
            if c:
                self._hasher.update(encode_row(c[-1]))

    def fold_value(self, value) -> None:
        """Opaque sink (no retained contents): fold the emitted value."""
        self.count += 1
        if self._hasher is not None:
            self._hasher.update(encode_row(value))

    def digest(self) -> Optional[str]:
        return self._hasher.hexdigest() if self._hasher is not None else None

    def contents_residual(self) -> Optional[int]:
        """Rows counted at emit minus actual contents growth — the
        cheap per-tick check that catches a hand-broken sink (a row
        dropped or injected behind the emit path). None when the sink
        retains nothing to compare against."""
        if self.contents_fn is None:
            return None
        return self.count - (len(self.contents_fn()) - self.base)

    def anchor(self) -> dict:
        """The checkpoint anchor for this sink: absolute retained-row
        count + the rolling digest over those rows (JSON-safe)."""
        n = (
            len(self.contents_fn())
            if self.contents_fn is not None
            else self.count
        )
        return {
            "count": int(n),
            "digest": self.digest(),
            "verifiable": self.verifiable,
        }


class ConservationLedger:
    """Per-attempt conservation accounting + digest anchoring root."""

    enabled = True

    def __init__(self, job_obs, digests: bool = True):
        self._group = job_obs.group
        self._flight = job_obs.flight
        self.digests = bool(digests)
        self._lock = threading.Lock()
        # -- source edge terms (written under the lock: the parse-ahead
        # thread owns them, the evaluator reads a consistent cut)
        self.offered = 0
        self.admitted = 0
        self.quarantined = 0
        self.host_dropped = 0
        self.host_fm_in = 0
        self.host_fm_out = 0
        # sharded ingestion parses in lane worker processes, where this
        # ledger's host-op counters cannot see; jobs with host-side
        # filter/flat_map then report the source edge informationally
        self.source_exact = True
        self.source_note: Optional[str] = None
        # -- edges -------------------------------------------------------
        # chained hand-offs: name -> () -> (handed, received, buffered)
        self._chain_edges: Dict[str, Callable] = {}
        # terminal/side emit fan-out: name -> {"in": n, "filtered": n}
        self._emit_edges: Dict[str, dict] = {}
        # sink digest accounts, keyed sink0/sink1/side:<tag>/dead_letter
        self.accounts: Dict[str, SinkAccount] = {}
        # -- violation latching -----------------------------------------
        self._tripped: set = set()
        self._violations = job_obs.counter(VIOLATIONS_SERIES)
        self._gauges: Dict[str, object] = {}
        self._restore: Optional[dict] = None
        self._ticks = 0

    # -- registration (executor wiring) -----------------------------------

    def register_sink(self, name: str, contents_fn: Optional[Callable],
                      persistent: bool = False) -> SinkAccount:
        """Mint the digest account for one sink. Names are made unique
        defensively; in practice only the terminal stage owns sinks."""
        base = name
        i = 2
        while name in self.accounts:
            name = f"{base}#{i}"
            i += 1
        acct = SinkAccount(
            name, contents_fn, persistent=persistent, digests=self.digests
        )
        self.accounts[name] = acct
        return acct

    def register_dead_letters(self, dead_letters: list) -> SinkAccount:
        return self.register_sink(
            "dead_letter", lambda: dead_letters, persistent=True
        )

    def emit_edge(self, name: str) -> dict:
        """The mutable in/filtered cell for one emit edge; the runner
        increments it per row, the evaluator reads it per tick."""
        return self._emit_edges.setdefault(name, {"in": 0, "filtered": 0})

    def register_chain_edge(self, name: str, terms: Callable) -> None:
        """``terms()`` -> (handed, received, buffered) rows for one
        chained stage hand-off (closures over the runner pair)."""
        self._chain_edges[name] = terms

    # -- per-batch / per-row hooks -----------------------------------------

    def account_source(self, offered: int, admitted: int,
                       host: Optional[dict] = None) -> None:
        """Commit one source batch's worth of edge terms atomically
        (``host`` is the HostStage's pending filter/flat_map/quarantine
        delta dict, consumed and zeroed here)."""
        with self._lock:
            self.offered += int(offered)
            self.admitted += int(admitted)
            if host:
                self.host_dropped += host["dropped"]
                self.host_fm_in += host["fm_in"]
                self.host_fm_out += host["fm_out"]
                self.quarantined += host["quarantined"]
                host["dropped"] = host["fm_in"] = 0
                host["fm_out"] = host["quarantined"] = 0

    def note_dead_letter(self, dead_letters: list, entry) -> None:
        """Append one quarantined record and fold it, atomically with
        respect to the evaluator — the contents edge never reads an
        append without its fold."""
        acct = self.accounts.get("dead_letter")
        with self._lock:
            dead_letters.append(entry)
            if acct is not None:
                acct.fold_tail()

    # -- evaluation ---------------------------------------------------------

    def edges(self) -> List[dict]:
        """Every declared edge with its terms and residual (None =
        informational, not evaluated). Read-only: safe from any thread."""
        out: List[dict] = []
        with self._lock:
            residual = (
                self.offered + self.host_fm_out - self.admitted
                - self.quarantined - self.host_dropped - self.host_fm_in
            )
            e = {
                "edge": "source",
                "offered": self.offered,
                "admitted": self.admitted,
                "quarantined": self.quarantined,
                "host_dropped": self.host_dropped,
                "flat_map_in": self.host_fm_in,
                "flat_map_out": self.host_fm_out,
                "residual": residual if self.source_exact else None,
            }
            if self.source_note:
                e["note"] = self.source_note
            out.append(e)
        for name, terms in self._chain_edges.items():
            handed, received, buffered = terms()
            out.append({
                "edge": name,
                "handed": handed,
                "received": received,
                "buffered": buffered,
                "residual": handed - received - buffered,
            })
        for name, cell in self._emit_edges.items():
            acct = self.accounts.get(name)
            emitted = acct.count if acct is not None else 0
            out.append({
                "edge": name,
                "in": cell["in"],
                "emitted": emitted,
                "filtered": cell["filtered"],
                "residual": cell["in"] - emitted - cell["filtered"],
            })
        for name, acct in self.accounts.items():
            r = acct.contents_residual()
            if r is None:
                continue
            out.append({
                "edge": f"contents:{name}",
                "emitted": acct.count,
                "retained": acct.count - r,
                "residual": r,
            })
        return out

    def _gauge(self, edge: str):
        g = self._gauges.get(edge)
        if g is None:
            g = self._group.group(edge=edge).gauge(RESIDUAL_SERIES)
            self._gauges[edge] = g
        return g

    def refresh(self) -> None:
        """The Snapshotter pre-hook: evaluate every invariant, mint the
        residual gauges, and latch one violation (counter + breadcrumb)
        per edge on its first nonzero residual — latched, so the CRIT
        health rule holds even if later terms re-balance the edge."""
        self._ticks += 1
        for e in self.edges():
            residual = e.get("residual")
            if residual is None:
                continue
            self._gauge(e["edge"]).set(float(residual))
            if residual != 0 and e["edge"] not in self._tripped:
                self._tripped.add(e["edge"])
                self._violations.inc()
                self._flight.record(
                    "ledger_violation",
                    edge=e["edge"],
                    residual=int(residual),
                    terms={
                        k: v for k, v in e.items()
                        if k not in ("edge", "residual")
                    },
                )

    # -- surfaces -----------------------------------------------------------

    def state(self) -> dict:
        """The snapshot ``ledger`` section / the ``/ledger.json`` body."""
        return {
            "digests": self.digests,
            "ticks": self._ticks,
            "edges": self.edges(),
            "violations": {
                "total": int(self._violations.value),
                "edges": sorted(self._tripped),
            },
            "anchors": {
                name: acct.anchor()
                for name, acct in sorted(self.accounts.items())
            },
            "restore": self._restore,
        }

    def anchors(self) -> dict:
        """Checkpoint meta payload: per-sink (count, digest) anchors."""
        return {
            name: acct.anchor()
            for name, acct in sorted(self.accounts.items())
        }

    # -- restore verification -----------------------------------------------

    def verify_anchors(self, saved: Optional[dict]) -> Optional[str]:
        """Restore-drill hook (runtime/checkpoint.py restore_drill):
        re-derive each verifiable sink's digest over the FIRST
        ``count`` rows of its current contents — the snapshot anchored
        a prefix of a still-running sink — and compare to the saved
        anchor. Pure read: no reseed, no gauges, no latched violation
        (the drill surfaces failures through its own metric/breadcrumb).
        Returns None when every checkable anchor matches, else a
        reason string."""
        if not saved or not self.digests:
            return None
        for name, a in sorted(saved.items()):
            acct = self.accounts.get(name)
            if (
                acct is None or not acct.verifiable
                or not a.get("verifiable") or a.get("digest") is None
            ):
                continue
            contents = list(acct.contents_fn())
            n = int(a.get("count", 0))
            if n > len(contents):
                return (
                    f"sink {name} anchored {n} rows but now holds "
                    f"{len(contents)} — output shrank past the snapshot"
                )
            h = hashlib.sha256()
            for v in contents[:n]:
                h.update(encode_row(v))
            if h.hexdigest() != a["digest"]:
                return (
                    f"sink {name} digest over the anchored {n}-row prefix "
                    "no longer matches the snapshot anchor"
                )
        return None

    def on_restore(self, saved: Optional[dict], verify: bool = True) -> None:
        """After a supervised restore truncated the persistent sinks
        back to the snapshot: re-derive each verifiable sink's digest
        over the truncated contents and compare it to the checkpoint's
        anchor. ``verify=False`` (cross-session snapshot: the truncation
        targets this session's baselines, not the anchors) skips the
        comparison and just re-anchors. Every account reseeds either
        way, so post-restore accounting starts from the rolled-back
        contents."""
        results: List[dict] = []
        for name, acct in self.accounts.items():
            a = (saved or {}).get(name) if verify else None
            if a is None or not acct.verifiable or not a.get("verifiable"):
                acct.reseed()
                continue
            contents = list(acct.contents_fn())
            expect_n = int(a.get("count", -1))
            expect_d = a.get("digest")
            got_d = None
            ok = len(contents) == expect_n
            if ok and self.digests and expect_d is not None:
                h = hashlib.sha256()
                for v in contents:
                    h.update(encode_row(v))
                got_d = h.hexdigest()
                ok = got_d == expect_d
            results.append({
                "sink": name,
                "count": len(contents),
                "expected_count": expect_n,
                "digest": got_d,
                "expected_digest": expect_d,
                "ok": ok,
            })
            if not ok:
                edge = f"restore:{name}"
                self._gauge(edge).set(1.0)
                if edge not in self._tripped:
                    self._tripped.add(edge)
                    self._violations.inc()
                self._flight.record(
                    "ledger_restore_digest_mismatch",
                    sink=name,
                    count=len(contents),
                    expected_count=expect_n,
                    digest=got_d,
                    expected_digest=expect_d,
                )
            acct.reseed()
        self._restore = {
            "verified": len(results),
            "mismatches": sum(1 for r in results if not r["ok"]),
            "sinks": results,
        }

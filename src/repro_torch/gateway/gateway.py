"""The multi-tenant fleet gateway: many runtimes behind one launch a bucket.

Port of :mod:`repro.gateway.gateway`. One :class:`FleetGateway` serves many
independent tenants, each with its own fleet spec or
:class:`~repro_torch.fleet.topology.TopologySpec` and routing, policy,
billing calendar, horizon and demand stream, from shared capacity-bucketed
pools (:mod:`repro_torch.gateway.pool`). Per gateway hour, or per chunk of
hours (:meth:`FleetGateway.tick_many`), each non-empty bucket costs exactly
ONE kernel launch: the pooled instance of ``stream_chunk`` (fleet buckets)
or ``stream_chunk_routed`` (topology buckets), which steps every slot's rows
with the slot's own clock, as the reference's ``jax.vmap`` of the
standalone tick over the pool's slot axis does (``gateway.py:402-428``,
``:522-552``). Membership churn (join, leave, resize, reroute) is operand
traffic: in-place writes into fixed-shape pools, so a bucket prepares its
launch shape once per chunk length.

The contract is the reference's: a pooled tenant's per-hour outputs equal,
bit for bit, those of its own standalone
:class:`~repro_torch.fleet.runtime.FleetRuntime` on the same device fed the
same demand, whatever its neighbours do. That holds because (a) tenant
operands resolve through the same
:func:`~repro_torch.fleet.runtime.resolve_runtime_operands`, (b) padding is
inert (:mod:`repro_torch.gateway.pool`), (c) the pooled kernel is the
standalone one with a per-row clock, and (d) the host's sequential float64
work (prefix rings, billing) is the standalone runtime's, vectorised over
slots, each slot's adds in hour order.

Billing stays on the host per tenant (float64 accumulators, carried across
bucket moves). Metrics ride the observability ring with a slot axis
(:func:`repro_torch.obs.metrics.init_tenant_ring`), updated on the host from
the planes each chunk brings home (:func:`~repro_torch.obs.metrics.update_ring_slots`,
one call for the bucket, not one a slot), drained per tenant on the gateway
cadence and checked by :class:`~repro_torch.obs.monitors.TenantSLOMonitor`:
breaches are recorded as typed
:class:`~repro_torch.obs.monitors.ContractViolation` values. Admission is
bounded: a FIFO join queue with a hard limit, and typed
:class:`AdmissionError` rejections that touch no pool.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.planner import collective_mode
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.policy import fsm_carry
from repro_torch.fleet.routing import RoutingOperand, as_routing_plan, index_legs, padded_operand_np
from repro_torch.fleet.runtime import RuntimeConfig, resolve_runtime_operands
from repro_torch.kernels import ops
from repro_torch.kernels.stream_chunk import block_size
from repro_torch.obs.metrics import (
    SCALARS,
    DrainedMetrics,
    MetricsRing,
    default_hist_edges,
    init_tenant_ring,
    reset_ring_slot,
    update_ring_slots,
)
from repro_torch.obs.monitors import ContractViolation, TenantSLOMonitor

from .pool import BucketKey, bucket_key_for, pack_tenant, set_slot, stack_slots


class AdmissionError(RuntimeError):
    """A typed join rejection: the gateway's backpressure signal.

    ``reason`` is machine-readable: ``"queue_full"`` (a burst exceeded the
    bounded join queue) or ``"too_large"`` (the tenant's padded capacities
    exceed the gateway's pool ceiling). Rejections are decided on the host:
    no pool is allocated, no launch shape prepared.
    """

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class TenantSLO:
    """What the tenant was sold: a realized-cost budget checked per drained
    window (``None`` disables the check; billing reconciliation always runs)."""

    max_hourly_cost: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's admission request: spec + config + demand + contract.

    ``config`` is the same frozen :class:`~repro_torch.fleet.runtime.RuntimeConfig`
    that drives ``FleetRuntime.from_config``: one validation path for
    standalone and pooled construction. ``demand`` is the tenant's (rows, T)
    GB/hour stream; ``horizon`` defaults to its full length.
    """

    spec: object
    demand: np.ndarray
    config: RuntimeConfig = RuntimeConfig()
    horizon: Optional[int] = None
    slo: Optional[TenantSLO] = None

    def resolved_horizon(self) -> int:
        h = self.horizon
        if h is None:
            h = int(np.asarray(self.demand).shape[1])
        if h < 1:
            raise ValueError(f"tenant horizon {h} < 1")
        return int(h)


@dataclasses.dataclass
class TenantHandle:
    """The gateway's view of one tenant: where it lives and how far it is."""

    name: str
    status: str                     # "queued" | "active" | "done" | "left"
    key: Optional[BucketKey] = None
    bucket: Optional[int] = None    # index within the key's bucket list
    slot: Optional[int] = None
    joined_at: int = 0              # gateway hour of activation

    @property
    def placed(self) -> bool:
        return self.status == "active"


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Gateway-level knobs (tenant-level ones live in the TenantSpec)."""

    slots_per_bucket: int = 8
    max_buckets: Optional[int] = None   # pool-count ceiling (None: unbounded)
    queue_limit: int = 16               # bounded join queue (backpressure)
    max_rows: int = 4096                # per-tenant padded-capacity ceiling
    obs: bool = True                    # tenant-axis metrics ring + monitors
    cadence: int = 64                   # gateway drain cadence (hours)
    hist_bins: int = 8

    def __post_init__(self):
        if self.slots_per_bucket < 1 or self.queue_limit < 0 or self.cadence < 1 \
                or self.hist_bins < 2:
            raise ValueError(f"invalid GatewayConfig {self}")


class _Bucket:
    """One capacity bucket: fixed-shape device pools + vectorised host state.

    Device pools hold the chunk kernel's operands with S slots of rows
    stacked (slot ``s`` is rows ``s·cap ..``): the per-row operands, the FSM
    carry and the calendar and prefix twins (after each chunk, views of the
    result's tail, as the standalone runtime keeps them), the per-row clocks,
    the replay gate's planes, and in topology mode the block-diagonal routing
    operand with its port-major index. Host state is the standalone
    runtime's numpy float64 block, one row per slot, plus the host copies
    the metrics ring reads.
    """

    def __init__(self, key: BucketKey, n_slots: int, packed, obs_dims, device: torch.device):
        self.key = key
        self.n_slots = S = n_slots
        self.device = device
        M, P, hb = key.rows_cap, key.pairs_cap, key.hbuf_cap
        i32, f64 = torch.int32, torch.float64
        # Every slot starts as a copy of the first joiner's padded operands:
        # placeholders for free slots, whose outputs are masked by `alive`.
        rows, fsm_carry0 = self._rows(packed)
        if key.topology:
            self.pair_rows, self.port_rows, self.lease_parts = (
                stack_slots([r] * S) for r in rows)
            self.legs = [packed.routing] * S
            self._set_routing()
        else:
            self.rows = stack_slots([rows] * S)
        self.fsm = stack_slots([fsm_carry0] * S, dim=1)
        self.cal = torch.zeros((2, S * P), dtype=f64, device=device)
        self.pref = torch.zeros((2, S * M), dtype=f64, device=device)
        hpm = packed.hours_per_month
        self.t0_row = torch.zeros(S * M, dtype=i32, device=device)
        self.hpm_row = torch.full((S * M,), hpm, dtype=i32, device=device)
        self.t0_pair = torch.zeros(S * P, dtype=i32, device=device) if key.topology else None
        self.hpm_pair = torch.full((S * P,), hpm, dtype=i32, device=device) if key.topology \
            else None
        self.gate = None
        if key.pred_source == "replay":
            self.gate = (*stack_slots([packed.gate] * S, dim=1),
                         stack_slots([packed.policy.margin] * S), key.pred_cap)
        self.ring = None
        if obs_dims is not None:
            cadence, n_bins = obs_dims
            self.ring = init_tenant_ring(S, M, cadence, n_bins, key.n_tiers)
        z = lambda *s: np.zeros((S,) + s, np.float64)
        self.alive = np.zeros(S, bool)
        self.t = np.zeros(S, np.int64)
        self.hpm = np.ones(S, np.int64)
        self.horizon = np.zeros(S, np.int64)
        self.m = np.zeros(S, np.int64)      # real decision rows
        self.p = np.zeros(S, np.int64)      # real demand rows
        self.h_np = np.ones((S, M), np.int64)
        self.dcum, self.dcum_month = z(P), z(P)
        self.vpn_pref, self.cci_pref = z(M), z(M)
        self.ring_vpn, self.ring_cci = z(hb, M), z(hb, M)   # hour-major
        self.bill_real, self.bill_vpn, self.bill_cci = z(M), z(M), z(M)
        self.gb = z(P)
        self.demand = np.zeros((S, P, 1), np.float64)
        self.cap_np = np.zeros((S, P), np.float64)          # demand rows' capacities
        self.port_cap_np = np.zeros((S, M), np.float64)     # topology: the ports'
        self.bounds_np = np.zeros((S, P, key.n_tiers), np.float64)
        self.pred_np = np.zeros((S, M, key.pred_cap), np.float64) if self.gate else None
        self.slots: List[Optional[str]] = [None] * S
        self.free: List[int] = list(range(S))[::-1]
        self.buffers: Dict[int, tuple] = {}                # K -> (host block, device block)

    @staticmethod
    def _rows(packed):
        """The chunk kernel's per-row operands of one padded tenant, in the
        wrapper's order (fleet: one tuple; topology: pair rows, port rows
        and the lease's two terms), and its FSM carry."""
        a, pol = packed.arrays, packed.policy
        tog = a.toggle
        fsm_rows = (tog.theta1, tog.theta2, tog.h, tog.D, tog.T_cci, *pol.holds())
        if packed.key.topology:
            rows = ((a.pair_capacity, a.L_vpn, a.tier_bounds, a.tier_rates),
                    (a.c_cci, a.port_capacity, *fsm_rows), (a.L_cci, a.V_cci))
        else:
            # The CCI lease is (L + V·1) before the volume term, as the
            # standalone runtime sums it.
            rows = (a.capacity, a.L_vpn, a.L_cci + a.V_cci, a.c_cci, a.tier_bounds,
                    a.tier_rates, *fsm_rows)
        return rows, fsm_carry(pol)

    def _set_routing(self) -> None:
        """The pooled routing operand from the slots' padded leg lists: slot
        s's legs offset to its own pairs and ports, one block-diagonal list
        over S·pairs_cap pairs and S·rows_cap ports, its port-major index
        built on the host (each real port folds exactly its tenant's legs,
        in the tenant's leg order), and the ports' leases ``L_cci +
        V_cci·n_attach``, the standalone runtime's sum."""
        S, M, P = self.n_slots, self.key.rows_cap, self.key.pairs_cap
        cat = lambda f, off: np.concatenate(
            [np.asarray(getattr(op, f)) + s * off for s, op in enumerate(self.legs)])
        lp, lm = cat("leg_pair", P).astype(np.int32), cat("leg_port", M).astype(np.int32)
        vw, aw = cat("vpn_w", 0), cat("attach_w", 0)
        primary = np.stack([np.asarray(op.primary, np.int64) for op in self.legs])
        dev = self.device
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)
        op = RoutingOperand(leg_pair=t(lp, torch.int32), leg_port=t(lm, torch.int32),
                            vpn_w=t(vw, torch.float64), attach_w=t(aw, torch.float64),
                            primary=t((primary + np.arange(S)[:, None] * M).ravel(),
                                      torch.int32))
        self.routing = index_legs(op, S * M)
        L_cci, V_cci = self.lease_parts
        self.lease = L_cci + V_cci * self.routing.index.n_attach
        self.legs_np = (lp.astype(np.int64), lm.astype(np.int64), aw)
        self.primary = primary                          # (S, P) slot-local ports
        self._fold = {}                                 # K -> flat bincount index

    @property
    def occupied(self) -> int:
        return self.n_slots - len(self.free)

    def ensure_T(self, T: int) -> None:
        cur = self.demand.shape[2]
        if T > cur:
            self.demand = np.pad(self.demand, ((0, 0), (0, 0), (0, T - cur)))

    def write_slot(self, s: int, name: str, packed, demand, horizon) -> None:
        """Allocate slot ``s``: in-place per-slot writes, fixed shapes."""
        key = self.key
        M, P = key.rows_cap, key.pairs_cap
        rows, carry = self._rows(packed)
        if key.topology:
            for pool, r in zip((self.pair_rows, self.port_rows, self.lease_parts), rows):
                set_slot(pool, s, r)
            self.legs[s] = packed.routing
            self._set_routing()
        else:
            set_slot(self.rows, s, rows)
        set_slot(self.fsm, s, carry, dim=1)
        self.cal[:, s * P:(s + 1) * P] = 0.0
        self.pref[:, s * M:(s + 1) * M] = 0.0
        self.t0_row[s * M:(s + 1) * M] = 0
        self.hpm_row[s * M:(s + 1) * M] = packed.hours_per_month
        if key.topology:
            self.t0_pair[s * P:(s + 1) * P] = 0
            self.hpm_pair[s * P:(s + 1) * P] = packed.hours_per_month
        if self.gate is not None:
            set_slot(self.gate[:2], s, packed.gate, dim=1)
            set_slot(self.gate[2], s, packed.policy.margin)
            self.pred_np[s] = packed.policy.pred_demand.cpu().numpy()
        if self.ring is not None:
            self.ring = reset_ring_slot(self.ring, s)
        a = packed.arrays
        self.alive[s] = True
        self.t[s] = 0
        self.hpm[s] = packed.hours_per_month
        self.horizon[s] = horizon
        self.m[s], self.p[s] = packed.n_rows, packed.n_pairs
        self.h_np[s] = packed.h_np
        for arr in (self.dcum, self.dcum_month, self.vpn_pref, self.cci_pref, self.ring_vpn,
                    self.ring_cci, self.bill_real, self.bill_vpn, self.bill_cci, self.gb):
            arr[s] = 0.0
        self.cap_np[s] = (a.pair_capacity if key.topology else a.capacity).cpu().numpy()
        self.bounds_np[s] = a.tier_bounds.cpu().numpy()
        if key.topology:
            self.port_cap_np[s] = a.port_capacity.cpu().numpy()
        d = np.asarray(demand, np.float64)
        self.ensure_T(d.shape[1])
        self.demand[s] = 0.0
        self.demand[s, : d.shape[0], : d.shape[1]] = d
        self.slots[s] = name

    def clear_slot(self, s: int) -> None:
        self.alive[s] = False
        self.demand[s] = 0.0
        self.slots[s] = None
        self.free.append(s)

    def chunk_args(self, block: torch.Tensor, K: int) -> tuple:
        """``(args, kwargs)`` of the pooled chunk call over ``block`` at the
        current carries and clocks: ``ops.stream_chunk_routed``'s in topology
        mode, ``ops.stream_chunk``'s in fleet mode."""
        key = self.key
        kw = dict(renew_in_chunks=key.renew_in_chunks, gate=self.gate)
        if key.topology:
            kw["clocks"] = (self.t0_row, self.hpm_pair, self.t0_pair)
            return (block, K, False, *self.pair_rows, self.lease, *self.port_rows, self.routing,
                    self.cal, self.fsm, self.pref), kw
        kw["clocks"] = (self.t0_row, self.hpm_row)
        return (block, K, False, *self.rows, self.cal, self.fsm, self.pref), kw

    def launch(self, block: torch.Tensor, K: int) -> torch.Tensor:
        """One chunk of K hours of every slot: one pooled kernel call. The
        carries become the FSM carry out and views of the result's tail, and
        every clock advances K hours. Returns the packed float64 result."""
        S, M, P = self.n_slots, self.key.rows_cap, self.key.pairs_cap
        chunk = ops.stream_chunk_routed if self.key.topology else ops.stream_chunk
        args, kw = self.chunk_args(block, K)
        host, self.fsm = chunk(*args, **kw)
        tail = host.view(-1)[8 * K * S * M:]
        self.cal = tail[:2 * S * P].view(2, S * P)
        self.pref = tail[2 * S * P:].view(2, S * M)
        self.t0_row.add_(K)
        if self.key.topology:
            self.t0_pair.add_(K)
        return host


class FleetGateway:
    """Admit, pool and step many tenant runtimes: one launch per bucket.

    See the module docstring for the architecture. ``device=None`` runs on
    CUDA and raises without a card; ``device="cpu"`` runs the chunk kernels'
    plain versions. ``compiles`` counts the distinct launch shapes prepared
    (:meth:`BucketKey.compile_key`: a bucket shape and a chunk length; a
    ``tick()`` is a chunk of one hour). The reference counts its jitted
    variants, a drain variant among them, so one bucket ticking hourly
    counts 2 there and 1 here: the port's metrics ring is host work and a
    drain hour launches the same shape. Churn prepares nothing new.
    """

    def __init__(self, config: GatewayConfig = GatewayConfig(), *,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.cadence = int(config.cadence)
        self.hist_bins = int(config.hist_bins)
        self._obs = bool(config.obs)
        self._edges = (torch.from_numpy(default_hist_edges(self.hist_bins))
                       if self._obs else None)
        self._buckets: Dict[BucketKey, List[_Bucket]] = {}
        self._tenants: Dict[str, TenantHandle] = {}
        self._specs: Dict[str, TenantSpec] = {}
        self._resolved: Dict[str, object] = {}
        self._monitors: Dict[str, TenantSLOMonitor] = {}
        self._billing_carry: Dict[str, Dict[str, float]] = {}
        self._drained: Dict[str, List[DrainedMetrics]] = {}
        self._queue: collections.deque = collections.deque()
        self._prepared: set = set()
        self.compiles = 0               # launch shapes prepared
        self.violations: List[ContractViolation] = []
        self.hours = 0                  # the gateway clock

    # --- admission ---------------------------------------------------------

    def _admit(self, name: str, tenant: TenantSpec, what: str):
        """Resolve and bucket a tenant on the gateway's device; raises
        ``AdmissionError("too_large")`` past the pool ceiling."""
        resolved = resolve_runtime_operands(tenant.spec, tenant.config, self.device)
        key = bucket_key_for(resolved)
        if max(key.rows_cap, key.pairs_cap) > self.config.max_rows:
            raise AdmissionError(
                "too_large",
                f"tenant {name!r}{what} pads to {key.rows_cap} rows x {key.pairs_cap} pairs, "
                f"over the gateway ceiling {self.config.max_rows}",
            )
        return resolved, key

    def join(self, name: str, tenant: TenantSpec) -> TenantHandle:
        """Admit a tenant: place it in a pool slot now, or queue it (FIFO,
        bounded), or reject it with a typed :class:`AdmissionError`."""
        if name in self._tenants and self._tenants[name].status not in ("done", "left"):
            raise ValueError(f"tenant {name!r} already admitted")
        resolved, key = self._admit(name, tenant, "")
        packed = pack_tenant(resolved, key)
        handle = TenantHandle(name=name, status="queued", key=key)
        self._tenants[name] = handle
        self._specs[name] = tenant
        self._resolved[name] = resolved
        self._billing_carry.setdefault(name, self._zero_totals())
        if not self._try_place(handle, packed, tenant):
            if len(self._queue) >= self.config.queue_limit:
                del self._tenants[name], self._specs[name], self._resolved[name]
                raise AdmissionError(
                    "queue_full",
                    f"no bucket has headroom for tenant {name!r} and the join queue is at its "
                    f"limit ({self.config.queue_limit})",
                )
            self._queue.append((name, packed, tenant))
        return handle

    @staticmethod
    def _zero_totals() -> Dict[str, float]:
        return {"realized": 0.0, "vpn": 0.0, "cci": 0.0, "gb": 0.0}

    def _try_place(self, handle, packed, tenant: TenantSpec) -> bool:
        key = packed.key
        buckets = self._buckets.setdefault(key, [])
        for bi, b in enumerate(buckets):
            if b.free:
                self._activate(handle, packed, tenant, bi, b)
                return True
        if not self._may_create_bucket():
            return False
        b = _Bucket(key, self.config.slots_per_bucket, packed,
                    (self.cadence, self.hist_bins) if self._obs else None, self.device)
        buckets.append(b)
        self._activate(handle, packed, tenant, len(buckets) - 1, b)
        return True

    def _may_create_bucket(self) -> bool:
        if self.config.max_buckets is None:
            return True
        if self.n_buckets < self.config.max_buckets:
            return True
        # Free one fully empty pool to make room (its launch shapes stay
        # counted: re-creating the same key later prepares nothing new).
        for lst in self._buckets.values():
            for i, b in enumerate(lst):
                if b.occupied == 0:
                    del lst[i]
                    return True
        return False

    def _activate(self, handle, packed, tenant: TenantSpec, bi, bucket) -> None:
        s = bucket.free.pop()
        bucket.write_slot(s, handle.name, packed, tenant.demand, tenant.resolved_horizon())
        handle.status, handle.bucket, handle.slot = "active", bi, s
        handle.joined_at = self.hours
        slo = tenant.slo or TenantSLO()
        self._monitors[handle.name] = TenantSLOMonitor(handle.name,
                                                       max_hourly_cost=slo.max_hourly_cost)
        self._drained.setdefault(handle.name, [])

    def _drain_admission_queue(self) -> None:
        still = collections.deque()
        while self._queue:
            name, packed, tenant = self._queue.popleft()
            if not self._try_place(self._tenants[name], packed, tenant):
                still.append((name, packed, tenant))
        self._queue = still

    # --- stepping ----------------------------------------------------------

    def tick(self, *, collect: bool = True) -> Dict[str, Dict[str, np.ndarray]]:
        """Advance EVERY active tenant one hour: one pooled launch per
        non-empty bucket (a chunk of K = 1). Returns per-tenant step outputs
        (the standalone ``FleetRuntime.step`` dict, sliced to real rows) when
        ``collect``; pass ``collect=False`` on the hot path to skip building
        them."""
        drain = self._obs and (self.hours + 1) % self.cadence == 0
        return self._advance(1, drain, collect, tick=True)

    def tick_many(self, K: int, *, collect: bool = True) -> Dict[str, Dict[str, np.ndarray]]:
        """Advance EVERY active tenant K hours: one pooled chunk launch per
        non-empty bucket (:meth:`~repro_torch.fleet.runtime.FleetRuntime.step_many`
        over the pool's slots). Decisions and host float64 billing equal, bit
        for bit, K sequential :meth:`tick` calls; per-tenant outputs come back
        stacked ``(rows, K)`` when ``collect``.

        Chunk-boundary semantics: lifecycle resolves at chunk ends (queued
        joins admit after the chunk), and every active tenant must have at
        least K hours of horizon left (``ValueError``; finish a ragged tail
        with smaller chunks or :meth:`tick`). With observability on, the drain
        cadence must not fall strictly inside the chunk (pick K dividing the
        cadence); drains then fire at the per-tick hours with the per-tick
        windows, bit for bit.
        """
        K = int(K)
        if K < 1:
            raise ValueError(f"tick_many: K {K} < 1")
        hour = self.hours
        drain = False
        if self._obs:
            boundary = ((hour // self.cadence) + 1) * self.cadence
            if boundary < hour + K:
                raise ValueError(
                    f"gateway drain cadence {self.cadence} falls mid-chunk (hour {boundary} "
                    f"inside ({hour}, {hour + K})): pick K dividing the cadence, or tick() "
                    "across the boundary")
            drain = boundary == hour + K
        for b in self._live_buckets():
            remaining = b.horizon[b.alive] - b.t[b.alive]
            if int(remaining.min()) < K:
                raise ValueError(
                    f"tick_many({K}) would overrun a tenant's horizon (min remaining "
                    f"{int(remaining.min())}h): chunk the tail with a smaller K or finish it "
                    "with tick()")
        return self._advance(K, drain, collect, tick=False)

    def _live_buckets(self):
        return [b for lst in self._buckets.values() for b in lst if b.occupied]

    def _advance(self, K: int, drain: bool, collect: bool, *, tick: bool):
        outs: Dict[str, Dict[str, np.ndarray]] = {}
        finished: List[str] = []
        for b in self._live_buckets():
            self._step_bucket(b, K, drain, collect, tick, outs, finished)
        self.hours += K
        for name in finished:
            self._finish(name, "done")
        self._drain_admission_queue()
        return outs

    def _block(self, b: _Bucket, K: int) -> tuple:
        """The bucket's prepared host and device blocks for a chunk of K
        hours, allocated the first time (pinned on a card, so the copy is one
        DMA); the first bucket of a compile key prepares a launch shape."""
        ck = b.key.compile_key(n_slots=b.n_slots, obs=self._obs, chunk=K)
        if ck not in self._prepared:
            self._prepared.add(ck)
            self.compiles += 1
        buf = b.buffers.get(K)
        if buf is None:
            n = block_size(K, b.n_slots * b.key.rows_cap, False, b.n_slots * b.key.pairs_cap)
            cuda = self.device.type == "cuda"
            host = torch.empty(n, dtype=torch.float64, pin_memory=cuda)
            dev = torch.empty(n, dtype=torch.float64, device=self.device) if cuda else host
            buf = b.buffers[K] = (host, dev)
        return buf

    def _pack(self, b: _Bucket, K: int) -> tuple:
        """Fill the chunk's block on the host, as the standalone runtime's
        ``_pack`` does for each slot: the demand (hour-major (K, S·P) in
        fleet mode, pair-major (S·P, K) in topology mode), then the pre-chunk
        window reads pre_v, pre_c (K, S·M) gathered from the host rings, each
        slot at its own clock (``src/repro/gateway/gateway.py:603-643``), all
        times ``alive``. Returns the device block and the clipped demand (K,
        S, P) the commit and the ring read."""
        key = b.key
        S, M, P, hb = b.n_slots, key.rows_cap, key.pairs_cap, key.hbuf_cap
        host_t, dev_t = self._block(b, K)
        blk = host_t.numpy()
        cols = np.minimum(b.t[:, None] + np.arange(K), b.demand.shape[2] - 1)
        dem = np.take_along_axis(b.demand, cols[:, None, :], axis=2)      # (S, P, K)
        alive = b.alive.astype(np.float64)
        nd = K * S * P
        if key.topology:
            np.multiply(dem, alive[:, None, None], out=blk[:nd].reshape(S, P, K))
        else:
            np.multiply(dem.transpose(2, 0, 1), alive[None, :, None],
                        out=blk[:nd].reshape(K, S, P))
        # Flat indices into each slot's hour-major (hb, M) ring: slot*M + row,
        # one wrap fixup; hours before a slot's hour 0 clip to its slot 0.
        Kw = min(K, hb)
        rows = np.arange(M)
        flat = ((b.t[:, None] - b.h_np) % hb) * M + rows[None, :]
        flat = flat[:, None, :] + (np.arange(Kw) * M)[None, :, None]      # (S, Kw, M)
        np.subtract(flat, hb * M, out=flat, where=flat >= hb * M)
        early = (b.t[:, None, None] + np.arange(Kw)[None, :, None]) < b.h_np[:, None, :]
        flat = np.where(early, rows[None, None, :], flat).reshape(S, -1)
        for off, ring in ((nd, b.ring_vpn), (nd + K * S * M, b.ring_cci)):
            pre = np.take_along_axis(ring.reshape(S, -1), flat, axis=1).reshape(S, Kw, M)
            np.multiply(pre.transpose(1, 0, 2), alive[None, :, None],
                        out=blk[off:off + Kw * S * M].reshape(Kw, S, M))
            blk[off + Kw * S * M:off + K * S * M] = 0.0   # read from the chunk's snapshots
        if dev_t is not host_t:
            dev_t.copy_(host_t, non_blocking=True)
        d_pair = np.minimum(dem.transpose(2, 0, 1), b.cap_np[None])       # (K, S, P)
        return dev_t, d_pair

    def _step_bucket(self, b: _Bucket, K: int, drain: bool, collect: bool, tick: bool,
                     outs, finished) -> None:
        key = b.key
        S, M, P, hb = b.n_slots, key.rows_cap, key.pairs_cap, key.hbuf_cap
        block, d_pair = self._pack(b, K)
        host = b.launch(block, K)
        # The ring's demand-side operands, formed while the chunk runs.
        ring_in = self._ring_operands(b, K, d_pair) if b.ring is not None else None
        res = host.cpu().numpy().reshape(-1)
        alive_rows = np.repeat(b.alive.astype(np.float64), M)
        n8 = 8 * K * S * M
        # Alive mask: free slots give exact zeros; x 1.0 is the identity for
        # live ones (src/repro/gateway/gateway.py:421, :544).
        planes = (res[:n8].reshape(8, K, S * M) * alive_rows).reshape(8, K, S, M)
        vpn_t, cci_t, r_vpn, r_cci, snap_v, snap_c, x, state = planes
        tail = res[n8:]
        alive_pairs = np.repeat(b.alive.astype(np.float64), P)
        # Commit: the ring slots take the prefix snapshots, the accumulators
        # the kernel's carries (the same adds in the same order).
        w = min(K, hb)   # K > hb: earlier slots would be rewritten
        slots = (b.t[:, None] + np.arange(K - w, K)) % hb
        sidx = np.arange(S)[:, None]
        b.ring_vpn[sidx, slots] = snap_v[K - w:].swapaxes(0, 1)
        b.ring_cci[sidx, slots] = snap_c[K - w:].swapaxes(0, 1)
        b.dcum[...] = (tail[:S * P] * alive_pairs).reshape(S, P)
        b.dcum_month[...] = (tail[S * P:2 * S * P] * alive_pairs).reshape(S, P)
        b.vpn_pref[...] = (tail[2 * S * P:2 * S * P + S * M] * alive_rows).reshape(S, M)
        b.cci_pref[...] = (tail[2 * S * P + S * M:] * alive_rows).reshape(S, M)
        # Billing, hour by hour as K ticks add it (never a block sum).
        cost = np.where(x == 1.0, cci_t, vpn_t)
        d_bill = d_pair * alive_pairs.reshape(S, P)
        for k in range(K):
            b.bill_real += cost[k]
            b.bill_vpn += vpn_t[k]
            b.bill_cci += cci_t[k]
            b.gb += d_bill[k]
        vecs = None
        if ring_in is not None:
            vecs = self._observe(b, K, x, state, vpn_t, cci_t, cost, d_pair, ring_in, drain)
        for s, name in enumerate(b.slots):
            if name is None:
                continue
            m = int(b.m[s])
            if collect:
                xs = x[:, s, :m].astype(np.int64)
                o = {"x": xs, "state": state[:, s, :m].astype(np.int64),
                     "r_vpn": r_vpn[:, s, :m], "r_cci": r_cci[:, s, :m],
                     "vpn_cost": vpn_t[:, s, :m], "cci_cost": cci_t[:, s, :m],
                     "cost": np.where(xs == 1, cci_t[:, s, :m], vpn_t[:, s, :m])}
                outs[name] = {f: (v[0] if tick else v.T) for f, v in o.items()}
            if vecs is not None:
                self._drain_slot(name, b, s, vecs[s].copy(), int(b.t[s]) + K)
            if b.t[s] + K >= b.horizon[s]:
                finished.append(name)
        b.t += K

    # --- metrics / SLO -----------------------------------------------------

    def _ring_operands(self, b: _Bucket, K: int, d_pair: np.ndarray) -> tuple:
        """The ring's operands the demand gives, (K, S, ·) planes, from the
        pre-chunk host state (``FleetRuntime._ring_operands`` for every slot
        at its own clock): the start-of-hour month volume, stepped with the
        kernels' adds in their order; the row demand (topology mode: the
        clipped pair demand folded onto the ports in leg order over the
        pooled leg list, then clipped at the port capacity); the replay
        predictions each slot's hours read."""
        key = b.key
        S, M, P = b.n_slots, key.rows_cap, key.pairs_cap
        month_cum = np.empty((K, S, P))
        dcum, base = b.dcum.copy(), b.dcum_month
        for k in range(K):
            base = np.where(((b.t + k) % b.hpm == 0)[:, None], dcum, base)
            np.subtract(dcum, base, out=month_cum[k])
            dcum += d_pair[k]
        d_row = d_pair
        if key.topology:
            lp, lm, aw = b.legs_np
            idx = b._fold.get(K)
            if idx is None:   # hour k's legs at k·S·M + port, in leg order
                idx = b._fold[K] = (np.arange(K)[:, None] * (S * M) + lm[None, :]).ravel()
            fold = np.bincount(idx, weights=(d_pair.reshape(K, S * P)[:, lp] * aw).ravel(),
                               minlength=K * S * M).reshape(K, S, M)
            d_row = np.minimum(fold, b.port_cap_np[None])
        pred = None
        if b.pred_np is not None:
            cols = np.minimum(b.t[:, None] + np.arange(K), key.pred_cap - 1)   # (S, K)
            pred = np.take_along_axis(b.pred_np, cols[:, None, :], axis=2).transpose(0, 2, 1)
        return month_cum, d_row, pred

    def _observe(self, b: _Bucket, K: int, x, state, vpn_t, cci_t, cost, d_pair, ring_in,
                 drain: bool):
        """The bucket's ring over its (S, K, ·) views of the chunk's planes,
        one call (:func:`update_ring_slots`); at a drain hour, every slot's
        drain vector (then a fresh window for every slot)."""
        month_cum, d_row, pred = ring_in
        sw = lambda a: a.swapaxes(0, 1)
        b.ring = update_ring_slots(
            b.ring, self._edges, x_t=sw(x), state_t=sw(state), vpn_t=sw(vpn_t),
            cci_t=sw(cci_t), d_pair=sw(d_pair), d_row=sw(d_row), month_cum=sw(month_cum),
            tier_bounds=b.bounds_np, routing_idx=b.primary if b.key.topology else None,
            pred_t=pred, cost_t=sw(cost))
        if not drain:
            return None
        small, gauges = b.ring.small.numpy(), b.ring.gauges.numpy()
        n = len(SCALARS)
        vecs = np.concatenate([small[:, :n], gauges.reshape(b.n_slots, -1), small[:, n:]],
                              axis=1)
        b.ring = MetricsRing(small=torch.zeros_like(b.ring.small),
                             prev_state=b.ring.prev_state,
                             gauges=torch.zeros_like(b.ring.gauges))
        return vecs

    def _drain_slot(self, name: str, b: _Bucket, s: int, vec: np.ndarray, hour: int) -> None:
        ticks = vec[0]
        if ticks <= 0:
            return
        # Pad correction: the ring reduces over each slot's rows_cap rows, so
        # the realized-cost histogram's zero bin counted every padded row
        # (cost exactly 0.0) on every tick (src/repro/gateway/gateway.py:733).
        vec[len(SCALARS) + 8 * self.cadence] -= ticks * (b.key.rows_cap - int(b.m[s]))
        dm = DrainedMetrics.from_flat(hour, vec, cap=self.cadence, n_bins=self.hist_bins,
                                      n_tiers=b.key.n_tiers)
        self._drained[name].append(dm)
        self.violations.extend(self._monitors[name].on_drain(
            hour, dm, host_totals=self._slot_totals(b, s)))

    @staticmethod
    def _slot_totals(b: _Bucket, s: int) -> Dict[str, float]:
        return {"realized": b.bill_real[s].sum(), "vpn": b.bill_vpn[s].sum(),
                "cci": b.bill_cci[s].sum(), "gb": b.gb[s].sum()}

    def _flush_slot(self, name: str, b: _Bucket, s: int) -> None:
        """Drain a slot's partial window (leave/check time, never on the
        per-tick path)."""
        if b.ring is None:
            return
        small, gauges = b.ring.small[s].numpy(), b.ring.gauges[s].numpy()
        n = len(SCALARS)
        vec = np.concatenate([small[:n], gauges.reshape(-1), small[n:]])
        self._drain_slot(name, b, s, vec, int(b.t[s]))
        b.ring = reset_ring_slot(b.ring, s)

    # --- lifecycle ---------------------------------------------------------

    def _bucket_of(self, handle) -> _Bucket:
        return self._buckets[handle.key][handle.bucket]

    def _active(self, name: str) -> TenantHandle:
        handle = self._tenants.get(name)
        if handle is None or handle.status != "active":
            raise ValueError(f"tenant {name!r} is not active "
                             f"({'unknown' if handle is None else handle.status})")
        return handle

    def _finish(self, name: str, status: str) -> None:
        handle = self._active(name)
        b = self._bucket_of(handle)
        s = handle.slot
        self._flush_slot(name, b, s)
        carry = self._billing_carry[name]
        for k, v in self._slot_totals(b, s).items():
            carry[k] += v
        b.clear_slot(s)
        handle.status, handle.bucket, handle.slot = status, None, None
        self._drain_admission_queue()

    def leave(self, name: str) -> None:
        """Remove an active tenant mid-stream: drain its metrics window, bank
        its billing, free the slot and admit from the queue; operand traffic
        only, nothing new prepared."""
        self._finish(name, "left")

    def resize(self, name: str, tenant: TenantSpec) -> TenantHandle:
        """Grow or shrink a tenant across capacity buckets: admit the NEW
        shape first (so a rejection leaves the tenant untouched), then retire
        the old slot. Billing totals carry across; the stream restarts at the
        new spec's hour 0 with fresh windows."""
        handle = self._active(name)
        old_bucket, old_slot = handle.bucket, handle.slot
        resolved, key = self._admit(name, tenant, " resize")
        packed = pack_tenant(resolved, key)
        # Flush the old incarnation's partial window now, while its monitor is
        # registered (placement installs the new one); the later _finish
        # re-flush then sees an empty ring.
        self._flush_slot(name, self._bucket_of(handle), old_slot)
        probe = TenantHandle(name=name, status="queued", key=key)
        if not self._try_place(probe, packed, tenant):
            raise AdmissionError("queue_full",
                                 f"no bucket has headroom to resize tenant {name!r}")
        handle.bucket, handle.slot = old_bucket, old_slot
        self._finish(name, "left")
        self._tenants[name] = probe
        self._specs[name] = tenant
        self._resolved[name] = resolved
        return probe

    def reroute(self, name: str, routing) -> None:
        """Swap one tenant's pair→port routing mid-stream: the standalone
        :meth:`FleetRuntime.reroute` contract, as one slot's rewrite of the
        pooled leg list (its index rebuilt on the host once). ``routing`` is
        a :class:`~repro_torch.fleet.routing.RoutingPlan` whose legs fit the
        tenant's bucketed leg capacity."""
        handle = self._active(name)
        if not handle.key.topology:
            raise ValueError("reroute() applies to topology (shared-port) tenants")
        b = self._bucket_of(handle)
        s = handle.slot
        resolved = self._resolved[name]
        m, p = int(b.m[s]), int(b.p[s])
        plan = as_routing_plan(routing, n_ports=m, context="FleetGateway.reroute")
        if plan.n_rows != p:
            raise ValueError(f"plan routes {plan.n_rows} rows, tenant carries {p}")
        if resolved.spec is not None:
            resolved.spec.validate_plan(plan)
        if plan.total_hops > b.key.legs_cap:
            raise ValueError(
                f"plan needs {plan.total_hops} legs but tenant {name!r} is bucketed at "
                f"legs_cap={b.key.legs_cap} — a deeper swap budget needs a resize() into a "
                "larger bucket")
        b.legs[s] = padded_operand_np(plan, n_legs=b.key.legs_cap, n_rows=b.key.pairs_cap,
                                      pad_pair=b.key.pairs_cap - 1, pad_port=b.key.rows_cap - 1)
        b._set_routing()

    # --- queries -----------------------------------------------------------

    def handle(self, name: str) -> TenantHandle:
        return self._tenants[name]

    @property
    def n_active(self) -> int:
        return sum(1 for h in self._tenants.values() if h.status == "active")

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def n_buckets(self) -> int:
        return sum(len(v) for v in self._buckets.values())

    def billing(self, name: str) -> Dict[str, float]:
        """Lifetime host float64 totals (across resizes and departure):
        realized $, VPN/CCI counterfactual $, billed GB."""
        totals = dict(self._billing_carry[name])
        handle = self._tenants[name]
        if handle.status == "active":
            for k, v in self._slot_totals(self._bucket_of(handle), handle.slot).items():
                totals[k] += v
        return {k: float(v) for k, v in totals.items()}

    def metrics(self, name: str) -> List[DrainedMetrics]:
        """The tenant's drained metrics windows."""
        return list(self._drained.get(name, []))

    def check(self, *, final: bool = True) -> List[ContractViolation]:
        """Flush every active tenant's partial metrics window through its
        :class:`~repro_torch.obs.monitors.TenantSLOMonitor` and return ALL
        violations recorded so far (typed, tenant-attributed). The gateway
        records rather than raises: one tenant's breach must not stall the
        others' streams."""
        if final and self._obs:
            for handle in self._tenants.values():
                if handle.status == "active":
                    self._flush_slot(handle.name, self._bucket_of(handle), handle.slot)
        return list(self.violations)

    def sync_groups(self, name: str) -> List[int]:
        """Per-job sync-domain ids for
        :func:`repro_torch.dist.collectives.fleet_sync_grads` (pass
        ``tenant=name`` there so the profiler's labels attribute each sync to
        its tenant): routed primary ports in topology mode, row ids in fleet
        mode."""
        handle = self._active(name)
        b, s = self._bucket_of(handle), handle.slot
        if not handle.key.topology:
            return list(range(int(b.m[s])))
        return [int(g) for g in b.primary[s, :int(b.p[s])]]

    def modes(self, name: str, out, *, mode_fn=None) -> List[str]:
        """Map one tenant's step output to per-actuator collective modes (the
        standalone :meth:`FleetRuntime.modes` contract)."""
        mode_fn = collective_mode if mode_fn is None else mode_fn
        handle = self._tenants[name]
        states = np.asarray(out["state"])
        if handle.key.topology:
            b, s = self._bucket_of(handle), handle.slot
            states = states[b.primary[s, :int(b.p[s])]]
        return [mode_fn(int(v)) for v in states]


__all__ = [
    "AdmissionError",
    "FleetGateway",
    "GatewayConfig",
    "TenantHandle",
    "TenantSLO",
    "TenantSpec",
]

"""Streaming fleet runtime in PyTorch: the online half of the planner.

Port of :mod:`repro.fleet.runtime`. ``plan_fleet`` and ``plan_topology``
take the whole (rows × hours) demand matrix at once; ToggleCCI is an online
algorithm, and a serving system only ever sees one hour at a time.
:class:`FleetRuntime` advances every row one hour per :meth:`~FleetRuntime.step`,
or K hours per :meth:`~FleetRuntime.step_many`, and its decisions equal the
offline planner's bit for bit.

Two demand routings, as in the offline engine: *fleet* (each row one link)
and *topology* (region pairs folded onto shared CCI ports over the
routing's leg list: pair-level billing state, port-level FSMs). In topology
mode the routing is a :class:`~repro_torch.fleet.routing.RoutingPlan`
stacked to its padded leg operand with a port-major leg index, built on the
host; :meth:`FleetRuntime.reroute` swaps any plan that fits the padded leg
bound mid-stream, carrying every FSM, prefix ring and billing state across,
and from the swap on the decisions equal
:func:`repro_torch.fleet.engine.replay_plan_topology` applying the same
routing at the same hour.

The state is split as in the JAX package:

* on the host, numpy float64: the billing prefixes ``dcum``/``dcum_month``,
  the exclusive cost prefixes ``vpn_pref``/``cci_pref`` and the hour-major
  ``(hbuf, M)`` rings of past prefix values the window sums read
  (``r[t] = pref[t] − pref[max(0, t − h)]``, the offline formula, so no
  add/subtract drift);
* on the device: the FSM carry and the twins of the four prefixes that
  the chunk kernel carries from chunk to chunk.

One chunk of K hours is one host-to-device copy of a packed block (the
demand, hour-major, and the host's pre-chunk ring reads), one kernel call,
and one copy of the packed planes back: ``stream_chunk`` in fleet mode (the
clip, the billing calendar and tier fold, the cost planes, snapshots,
window sums and the FSM, as the JAX runtime's one jitted dispatch), and
``stream_chunk_routed`` in topology mode (the same with the leg fold onto
the ports between the pair pricing and the port FSMs).
:meth:`~FleetRuntime.step` is :meth:`~FleetRuntime.step_many` with K = 1. On
the CPU (``device="cpu"``) the kernels' plain versions run instead.

Ported: both routings, the reactive and hysteresis policies, the
forecast-gated policy in replay mode (a :class:`ForecastGatedPolicy` with
its ``cost_coef`` given: its predicted mode costs are formed once, at
construction, as the offline planners form them, and the chunk kernels'
gated instances read them hour by hour) and in live mode (the same policy
with ``forecaster=`` a :class:`StreamingForecaster`: the SSM forecaster's
state rides on the device beside the FSM carry, and the chunk kernels' live
instances step it after each hour's decision, so each hour's gates read the
forecast made from the demand realised so far), endogenous CCI demand,
``reroute``, and the actuation layer on top (:class:`ElasticFleetPlanner`,
per link or per port, whose per-actuator modes drive
:func:`repro_torch.dist.collectives.fleet_sync_grads`), with the live
forecaster trained on a history (:meth:`StreamingForecaster.fit`,
:func:`streaming_forecast_policy`), and observability (``obs=``: the
metrics ring of :mod:`repro_torch.obs.metrics`, updated on the host from the
planes each chunk brings home, the trace, the contract monitors and the
profiler of :class:`repro_torch.obs.FleetObserver`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.planner import COMPRESS_RATIO, collective_mode
from repro_torch.device import DeviceLike, resolve_device, to_host
from repro_torch.kernels import ops
from repro_torch.models.ssm import _operands as _ssm_operands
from repro_torch.models.ssm import demand_forecaster_warmup, train_demand_forecaster
from repro_torch.obs.metrics import flatten_ring, init_ring, reset_ring, update_ring_chunk

from .policy import (ForecastGatedPolicy, HysteresisPolicy, ReactivePolicy, fsm_carry,
                     make_policy, policy_to)
from .routing import RoutingPlan, as_routing_plan, index_legs
from .spec import FleetArrays, FleetSpec
from .topology import TopologyArrays, TopologySpec

_COST_COEF = ("streaming a ForecastGatedPolicy needs explicit demand->cost coefficients: "
              "build it with forecast_fleet_policy/forecast_topology_policy (or pass "
              "cost_coef= to forecast_gated_policy)")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"not ported to repro_torch yet: {what}")


class RuntimeState(NamedTuple):
    """The explicit carry of the stream.

    Host numpy float64 for everything sequential (so every add is the
    offline ``np.cumsum``'s), device tensors for what the kernels carry.
    Billing rows are per PAIR (P), cost and FSM rows per decision row (M,
    a port in topology mode); in fleet mode rows are links and P == M.
    """

    t: int                  # the hour about to be served
    fsm: torch.Tensor       # device (4, M) int32: state, t_state, up, down
    dev_cal: torch.Tensor   # device (2, P) float64: dcum, dcum_month twins
    dev_pref: torch.Tensor  # device (2, M) float64: vpn_pref, cci_pref twins
    dcum: np.ndarray        # (P,) cumulative clipped billed demand
    dcum_month: np.ndarray  # (P,) dcum at the current month's start
    vpn_pref: np.ndarray    # (M,) exclusive prefix of hourly VPN cost
    cci_pref: np.ndarray    # (M,) exclusive prefix of hourly CCI cost
    ring_vpn: np.ndarray    # (hbuf, M) past vpn_pref values, slot = hour % hbuf
    ring_cci: np.ndarray    # (hbuf, M)
    ssm_h: Optional[torch.Tensor] = None      # device (M, S) float32: the live
                                              # forecaster's state (live mode only)
    pred_live: Optional[torch.Tensor] = None  # device (M,) float64: the forecast
                                              # the next hour's gates read
    metrics: Optional[object] = None          # host MetricsRing (None without
                                              # observability), drained at the
                                              # obs cadence


@dataclasses.dataclass(frozen=True)
class StreamingForecaster:
    """A demand forecaster packaged for O(1)-per-hour stepping
    (:class:`repro.fleet.runtime.StreamingForecaster`).

    ``params`` is the port's forecaster dict (``{"raw_a", "w", "bias"}``
    float32 tensors; a JAX one comes across with
    :func:`repro_torch.models.convert.tree_from_reference`), ``scale`` the
    (rows,) float64 normalisers, ``h0`` the (rows, S) float32 state after the
    history and ``pred0`` the (rows,) float64 forecast for live hour 0 (the
    readout after the last history hour). Fields may be numpy arrays or
    tensors; :class:`FleetRuntime` moves them to its device once.
    """

    params: dict
    scale: object
    h0: object
    pred0: object

    @classmethod
    def fit(cls, history, window: int, *, device: DeviceLike = None,
            **train_kw) -> "StreamingForecaster":
        """Train the forecaster on a strictly earlier (rows, H >= 2) history
        block and warm it through that block, on ``device`` (CUDA unless the
        caller says otherwise): :func:`~repro_torch.models.ssm.train_demand_forecaster`
        (``train_kw``: ``steps``, ``lr``, ``state_dim``, ``seed``), then
        :meth:`from_history` with the trained parameters, so live forecasts
        are causal from hour 0."""
        hist = to_host(history, np.float64)
        if hist.ndim != 2 or hist.shape[1] < 2:
            raise ValueError("StreamingForecaster.fit needs a (rows, H>=2) history block — "
                             "live streaming has no future to fit on")
        params, _ = train_demand_forecaster(hist, window, device=device, **train_kw)
        return cls.from_history(params, hist, device=device)

    @classmethod
    def from_history(cls, params, history, *,
                     device: DeviceLike = None) -> "StreamingForecaster":
        """Warm given ``params`` through a (rows, H) ``history`` block, as
        ``fit`` does after training: ``scale`` is ``max(mean(history), 1e-9)``
        per row (numpy, the training's normaliser), ``h0`` and ``pred0`` come
        from one scan over the history on ``device``
        (:func:`~repro_torch.models.ssm.demand_forecaster_warmup`)."""
        hist = to_host(history, np.float64)
        if hist.ndim != 2 or hist.shape[1] < 1:
            raise ValueError(f"StreamingForecaster.from_history needs a (rows, H >= 1) "
                             f"history block, got {hist.shape}")
        scale = np.maximum(hist.mean(axis=1), 1e-9)
        h0, pred0 = demand_forecaster_warmup(params, hist, scale, device=device)
        return cls(params=params, scale=scale, h0=h0, pred0=pred0)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Frozen construction options of a :class:`FleetRuntime` (the fields of
    :class:`repro.fleet.runtime.RuntimeConfig`, validated as it validates
    them; ``obs`` is ``None``, a bool or an object with a drain
    ``cadence``, such as :class:`repro_torch.obs.ObsConfig`)."""

    routing: object = None
    policy: object = None
    hours_per_month: int = 730
    renew_in_chunks: bool = False
    forecaster: object = None
    obs: object = None

    def validate(self) -> "RuntimeConfig":
        if not (int(self.hours_per_month) >= 1):
            raise ValueError(f"hours_per_month must be >= 1, got {self.hours_per_month}")
        if self.forecaster is not None:
            if not isinstance(self.forecaster, StreamingForecaster):
                raise TypeError("forecaster must be a StreamingForecaster, got "
                                f"{type(self.forecaster).__name__}")
            if self.policy is not None and not isinstance(self.policy, ForecastGatedPolicy):
                raise ValueError("forecaster= only applies to a ForecastGatedPolicy")
        if self.obs not in (None, True, False) and not hasattr(self.obs, "cadence"):
            raise TypeError("obs must be None, a bool, or an ObsConfig-like object "
                            f"with a drain cadence — got {type(self.obs).__name__}")
        return self


@dataclasses.dataclass(frozen=True)
class ResolvedRuntime:
    """The operands one stream steps with, resolved on one device."""

    spec: Optional[TopologySpec]  # the TopologySpec when one was given (for
                                  # reroute validation), else None
    topology: bool
    arrays: object                # FleetArrays or TopologyArrays
    policy: object
    hours_per_month: int
    routing_plan: Optional[RoutingPlan] = None  # the typed plan behind
                                  # arrays.routing when a spec was stacked
    pred_source: Optional[str] = None  # "replay" or "live" for a ForecastGatedPolicy
    live: Optional[tuple] = None  # live mode: (a, 1 - a, w, bias, scale, cost_coef,
                                  # margin) on the device
    live0: Optional[tuple] = None  # live mode: (h0 (M, S) f32, pred0 (M,) f64)


def resolve_runtime_operands(spec, config: RuntimeConfig,
                             device: DeviceLike = None) -> ResolvedRuntime:
    """Resolve ``(spec, config)`` into stepping operands on ``device``
    (``src/repro/fleet/runtime.py:632-705``): a :class:`FleetSpec` is
    stacked (its calendar and policy kind win over the config's; a routing
    beside it is not read, as in the JAX resolver); a :class:`TopologySpec`
    needs ``config.routing`` and is stacked with it (the leg operand and its
    port-major index built on the host); :class:`FleetArrays` and
    :class:`TopologyArrays` are moved, and the latter carry their own
    routing, so a routing beside them is an error. A
    :class:`ForecastGatedPolicy` needs its ``cost_coef`` (the reference's
    text, as a ``ValueError``). With ``config.forecaster`` it streams in live
    mode (``pred_source = "live"``, ``src/repro/fleet/runtime.py:670-697``):
    ``pred_demand`` is not read, the forecaster must carry one row per
    decision row and as many states as its parameters, and the live operands are formed
    once on the device (:func:`_live_operands`). Without it, replay mode
    (``"replay"``) needs a (rows, T_pred) ``pred_demand``, rows being the
    decision rows (ports in topology mode)."""
    config = config.validate()
    dev = resolve_device(device)
    kind = "reactive"
    hours_per_month = int(config.hours_per_month)
    routing = config.routing
    topo_spec, plan = None, None
    if isinstance(spec, FleetSpec):
        hours_per_month = spec.hours_per_month
        kind = spec.policy
        arrays = spec.stack(torch.float64, dev)
    elif isinstance(spec, TopologySpec):
        if routing is None:
            raise ValueError("a TopologySpec needs an explicit routing (the runtime "
                             "cannot co-optimize it online; run optimize_routing first)")
        hours_per_month = spec.hours_per_month
        kind = spec.policy
        topo_spec = spec
        plan = as_routing_plan(routing, n_ports=spec.n_ports, context="FleetRuntime(routing=)")
        arrays = spec.stack(plan, torch.float64, dev)
    elif isinstance(spec, (FleetArrays, TopologyArrays)):
        if routing is not None:
            raise ValueError("pre-stacked arrays already carry a routing")
        arrays = spec.to(dev)
        if isinstance(arrays, TopologyArrays):
            arrays = arrays._replace(routing=index_legs(arrays.routing, arrays.n_ports))
    else:
        raise TypeError("FleetRuntime streams a FleetSpec, FleetArrays, TopologySpec or "
                        f"TopologyArrays, got {type(spec).__name__}")
    policy = config.policy
    pred_source = live = live0 = None
    if policy is None:
        policy = make_policy(kind, arrays.toggle, renew_in_chunks=config.renew_in_chunks)
    elif isinstance(policy, (ReactivePolicy, HysteresisPolicy)):
        policy = policy_to(policy, dev)
    elif isinstance(policy, ForecastGatedPolicy):
        if policy.cost_coef is None:
            raise ValueError(_COST_COEF)
        M = arrays.toggle.theta1.shape[0]
        if config.forecaster is not None:
            live, live0 = _live_operands(config.forecaster, policy, M, dev)
            pred_source = "live"
        else:
            shape = tuple(policy.pred_demand.shape)
            if len(shape) != 2 or shape[0] != M or shape[1] < 1:
                raise ValueError(f"replay mode indexes pred_demand columns per tick: "
                                 f"expected a ({M}, T_pred >= 1) prediction matrix, "
                                 f"got {shape}")
            pred_source = "replay"
        policy = policy_to(policy, dev)
    else:
        raise TypeError(f"FleetRuntime streams a reactive, hysteresis or forecast-gated "
                        f"policy, got {type(policy).__name__}")
    if config.forecaster is not None and pred_source != "live":
        raise ValueError("forecaster= only applies to a ForecastGatedPolicy")
    return ResolvedRuntime(spec=topo_spec, topology=isinstance(arrays, TopologyArrays),
                           arrays=arrays, policy=policy, hours_per_month=hours_per_month,
                           routing_plan=plan, pred_source=pred_source, live=live,
                           live0=live0)


def _live_operands(fc: StreamingForecaster, policy: ForecastGatedPolicy, M: int,
                   dev: torch.device):
    """Live mode's device operands, formed once: ``(a, 1 − a, w, bias)`` by
    :func:`repro_torch.models.ssm._operands` (the sigmoid on the host, so every
    device steps the same bits), the forecaster's ``scale`` and the policy's
    ``cost_coef`` and ``margin`` in float64; and the start ``(h0, pred0)``.
    Raises unless the forecaster carries M rows and its parameters h0's S states."""
    f32, f64 = torch.float32, torch.float64

    def move(x, dt):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
        return t.detach().to(device=dev, dtype=dt).contiguous()

    scale, h0, pred0 = move(fc.scale, f64), move(fc.h0, f32), move(fc.pred0, f64)
    S = h0.shape[1] if h0.dim() == 2 else -1
    if scale.shape != (M,) or pred0.shape != (M,) or h0.dim() != 2 or h0.shape[0] != M:
        raise ValueError(f"the forecaster must carry one row per decision row ({M}): got "
                         f"scale {tuple(scale.shape)}, h0 {tuple(h0.shape)}, pred0 "
                         f"{tuple(pred0.shape)}")
    a, oma, w, bias = (t.detach() for t in _ssm_operands(fc.params, dev))
    if a.shape != (S,) or w.shape != (S,):
        raise ValueError(f"forecaster params of {tuple(a.shape)} states against h0's {S}")
    coef = policy.cost_coef.detach().to(dev, f64).contiguous()
    if coef.shape != (M, 4):
        raise ValueError(f"cost_coef: want ({M}, 4), got {tuple(coef.shape)}")
    live = (a, oma, w, bias, scale, coef, policy.margin.detach().to(dev, f64).contiguous())
    return live, (h0, pred0)


class FleetRuntime:
    """Incremental fleet planner: ``step(demand_t)`` serves one hour of every
    row, ``step_many(block)`` K hours.

    The streaming twin of :func:`repro_torch.fleet.engine.plan_fleet` and
    :func:`~repro_torch.fleet.engine.plan_topology`: the same pricing, the
    same policies, one hour (or one chunk) per call. Any mix of :meth:`step`
    and :meth:`step_many` calls over a demand stream gives the decisions and
    costs of one offline plan on the CPU, bit for bit (float64 throughout,
    sequential prefixes and leg sums, no fused multiply-add).

    Args:
      spec: a :class:`FleetSpec`/:class:`FleetArrays` (fleet routing) or a
        :class:`TopologySpec`/:class:`TopologyArrays` (shared-port routing:
        give ``routing`` with a spec; arrays carry their own).
      routing: the :class:`~repro_torch.fleet.routing.RoutingPlan` of a
        :class:`TopologySpec` (legacy (P,) indices / (M, P) one-hot matrices
        go through the ``DeprecationWarning`` shim). Its padded leg bound is
        the largest plan :meth:`reroute` can swap in.
      policy: a reactive, hysteresis or forecast-gated policy with per-row
        tensors (per port in topology mode); ``None`` builds the spec's kind.
        A :class:`ForecastGatedPolicy` needs its ``cost_coef``; without a
        forecaster it streams in replay mode, hour ``t`` reading column
        ``min(t, T_pred − 1)`` of its predicted mode costs.
      hours_per_month: billing calendar; taken from the spec when a spec is
        given (pass arrays to choose it).
      renew_in_chunks: release only at multiples of ``T_cci``.
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` runs
        the kernels' plain versions.
      forecaster: a :class:`StreamingForecaster` beside a
        :class:`ForecastGatedPolicy` streams it in live mode
        (``pred_source == "live"``): hour ``t``'s gates read the forecast
        made after hour ``t − 1`` (``pred0`` at hour 0) from the demand
        realised so far, clipped (fleet mode) or folded onto the port and
        clipped (topology mode), and the policy's ``pred_demand`` is not
        read. The outputs then also hold ``pred_next``, the forecast made
        after each hour. ``reset()`` restores ``h0`` and ``pred0``;
        ``reroute()`` carries the forecaster's state across untouched.
      obs: observability. ``None`` (default) or ``False`` disables it.
        ``True`` or a :class:`repro_torch.obs.ObsConfig` attaches a
        :class:`repro_torch.obs.FleetObserver` (``self.obs``): the metrics
        ring (updated on the host after each chunk, from the planes the
        chunk brings home, and drained every ``cadence`` hours; a chunk may
        end on a drain hour but not cross one), lease lifecycle tracing, the
        contract monitors and the step profiler. Decisions and costs are
        bit-identical either way. See :meth:`obs_report` / :meth:`obs_check`.
    """

    def __init__(
        self,
        spec,
        *,
        routing=None,
        policy=None,
        hours_per_month: int = 730,
        renew_in_chunks: bool = False,
        forecaster=None,
        obs=None,
        device: DeviceLike = None,
    ):
        self.config = RuntimeConfig(
            routing=routing, policy=policy, hours_per_month=hours_per_month,
            renew_in_chunks=renew_in_chunks, forecaster=forecaster, obs=obs,
        ).validate()
        self.device = resolve_device(device)
        r = resolve_runtime_operands(spec, self.config, self.device)
        self._spec = r.spec
        self.topology = r.topology
        self.arrays = r.arrays
        self.policy = r.policy
        self.pred_source = r.pred_source
        self._live, self._live0 = r.live, r.live0
        self._n_planes = 9 if self._live is not None else 8
        self.hours_per_month = r.hours_per_month
        tog = self.arrays.toggle
        self._h_np = tog.h.cpu().numpy().astype(np.int64)
        self.hbuf = int(self._h_np.max()) + 1
        self.n_rows = int(tog.h.shape[0])
        self.n_demand_rows = self.arrays.n_pairs if self.topology else self.n_rows
        self._rows_idx = np.arange(self.n_rows)
        self.obs = None
        # Per-row operands of the chunk, on the device. Fleet mode: the CCI
        # lease is (L + V·1) before the volume term is added, as the JAX tick
        # sums it. Topology mode: per-pair pricing rows, then per-port rows
        # after the lease, which depends on the routing (_set_routing_caches).
        a = self.arrays
        fsm_rows = (tog.theta1, tog.theta2, tog.h, tog.D, tog.T_cci, *self.policy.holds())
        if self.topology:
            self._pair_rows = (a.pair_capacity, a.L_vpn, a.tier_bounds, a.tier_rates)
            self._port_rows = (a.c_cci, a.port_capacity, *fsm_rows)
        else:
            self._chunk_rows = (a.capacity, a.L_vpn, a.L_cci + a.V_cci, a.c_cci,
                                a.tier_bounds, a.tier_rates, *fsm_rows)
        self._gate = self._gate_planes() if self.pred_source == "replay" else None
        self._set_routing_caches(r.routing_plan)
        if obs is not None and obs is not False:
            from repro_torch.obs.observer import FleetObserver, ObsConfig

            self.obs = FleetObserver(ObsConfig() if obs is True else obs, self)
            self._set_obs_caches()
        self.reset()

    def _gate_planes(self) -> tuple:
        """The forecast gate's operands, formed once: ``(p_vpn, p_cci, margin,
        T_pred)``. The predicted mode costs come from the offline planners'
        own call (``ForecastGatedPolicy.features`` with the coefficients
        given: :func:`~repro_torch.fleet.policy.predicted_mode_costs` over the
        whole (M, T_pred) plane), so the stream's gates compare the bits
        ``plan_fleet`` and ``replay_plan_topology`` compare; they are kept
        hour-major, two contiguous (T_pred, M) float64 tensors on the device
        (a transpose copy keeps every bit), beside the (M,) margins.
        ``reset()`` and ``reroute()`` leave them as they are: the predictions
        are per decision row and do not depend on the routing."""
        pol = self.policy
        f64 = torch.float64
        like = torch.empty(0, dtype=f64, device=self.device)
        p_vpn, p_cci = pol.features(None, like, like)
        return (p_vpn.T.contiguous(), p_cci.T.contiguous(), pol.margin.to(f64).contiguous(),
                int(pol.pred_demand.shape[1]))

    @classmethod
    def from_config(cls, spec, config: RuntimeConfig, *,
                    device: DeviceLike = None) -> "FleetRuntime":
        """The explicit twin of the keyword constructor."""
        config = config.validate()
        fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
        return cls(spec, device=device, **fields)

    def _set_routing_caches(self, plan: Optional[RoutingPlan] = None) -> None:
        """Host views of ``arrays.routing``, derived once per (re)routing,
        never per chunk (``src/repro/fleet/runtime.py:817-842``): the typed
        :class:`RoutingPlan` (decoded from the leg operand when the caller
        has none), the (P,) primary-port vector ``modes()`` and the sync
        groups read, and the per-port lease ``L_cci + V_cci·n_attach`` on the
        device, in the JAX tick's order of operations."""
        if not self.topology:
            self.routing_plan = self._routing_idx_np = self._lease = None
            return
        a = self.arrays
        if plan is None:
            plan = RoutingPlan.from_operand(a.routing, self.n_rows,
                                            provenance="from_operand:FleetRuntime")
        self.routing_plan = plan
        self._routing_idx_np = plan.primary
        self._lease = a.L_cci + a.V_cci * a.routing.index.n_attach

    def _set_obs_caches(self) -> None:
        """Host copies of what the metrics ring reads besides the chunk's
        planes, taken once: the demand rows' capacities, the tier bounds, the
        histogram edges, the replay predictions hour-major; then the
        routing's (:meth:`_set_obs_routing`)."""
        a = self.arrays
        cap = a.pair_capacity if self.topology else a.capacity
        self._obs_cap = to_host(cap, np.float64)
        self._obs_bounds = a.tier_bounds.detach().to("cpu", torch.float64)
        self._obs_edges = torch.from_numpy(np.asarray(self.obs.hist_edges, np.float64))
        self._obs_pred = (to_host(self.policy.pred_demand, np.float64).T.copy()
                          if self.pred_source == "replay" else None)
        self._set_obs_routing()

    def _set_obs_routing(self) -> None:
        """The ring's host copies of the routing, once per (re)routing: in
        topology mode each pair's primary port and the legs (the port fold of
        the clipped demand, ``src/repro/fleet/runtime.py:485-488``)."""
        self._obs_route = self._obs_legs = None
        self._obs_fold = {}                 # K -> flat (K·E,) bincount index, hour-major
        if self.topology:
            a = self.arrays
            r = a.routing
            self._obs_route = torch.from_numpy(np.asarray(self._routing_idx_np, np.int64))
            self._obs_legs = (to_host(r.leg_pair, np.int64), to_host(r.leg_port, np.int64),
                              to_host(r.attach_w, np.float64),
                              to_host(a.port_capacity, np.float64))

    def reset(self) -> None:
        """Rewind to hour 0 (fresh carries, the live forecaster back at its
        ``h0`` and ``pred0``; operands, routing and policy unchanged)."""
        M, P = self.n_rows, self.n_demand_rows
        z = lambda *s: np.zeros(s, np.float64)
        dz = lambda n: torch.zeros((2, n), dtype=torch.float64, device=self.device)
        h0, pred0 = (None, None) if self._live0 is None else self._live0
        metrics = None
        if self.obs is not None:
            cfg = self.obs.config
            metrics = init_ring(M, self.obs.cadence, cfg.hist_bins, self.obs.n_tiers)
            # Live mode: the forecast that gates the next hour, on the host.
            self._obs_pred_live = None if pred0 is None else to_host(pred0, np.float64)
            self.obs.on_reset()
        self._state = RuntimeState(
            t=0, fsm=fsm_carry(self.policy), dev_cal=dz(P), dev_pref=dz(M),
            dcum=z(P), dcum_month=z(P), vpn_pref=z(M), cci_pref=z(M),
            ring_vpn=z(self.hbuf, M), ring_cci=z(self.hbuf, M), ssm_h=h0, pred_live=pred0,
            metrics=metrics,
        )

    @property
    def t(self) -> int:
        return int(self._state.t)

    def step(self, demand_t, *, cci_demand_t=None) -> Dict[str, np.ndarray]:
        """Advance one hour. ``demand_t``: (rows,) GB billed on the VPN path
        this hour (per pair in topology mode); ``cci_demand_t`` optionally
        prices the CCI counterfactual on its own volume (endogenous demand).
        Returns this hour's per-decision-row ``x``, ``state``, ``r_vpn``,
        ``r_cci``, ``vpn_cost``, ``cci_cost``, ``cost`` (and ``pred_next`` in
        live mode); ``state`` is the FSM state that serves the hour (map it
        with :meth:`modes`)."""
        d = np.asarray(demand_t, np.float64)
        if d.shape != (self.n_demand_rows,):
            raise ValueError(f"demand_t must be ({self.n_demand_rows},), got {d.shape}")
        c = None if cci_demand_t is None else np.asarray(cci_demand_t, np.float64)[:, None]
        out = self._advance(d[:, None], c, tick=True)
        return {k: v[:, 0] for k, v in out.items()}

    def step_many(self, demand_block, *, cci_demand_block=None) -> Dict[str, np.ndarray]:
        """Advance K hours in one chunk. ``demand_block`` is ``(rows, K)``,
        the next K columns of the matrix :meth:`run` takes. Returns
        :meth:`step`'s dict with ``(rows, K)`` arrays.

        Contract: any chunking of a stream, interleaved freely with
        :meth:`step` and :meth:`reroute`, gives the per-tick results bit for
        bit, in the outputs and in the carried host prefixes. With
        observability on, a chunk must not cross a drain hour (its end may
        fall on one; ``ValueError`` otherwise, before anything runs): drains
        then fire at the per-tick hours with the per-tick windows, bit for
        bit.
        """
        return self._advance(demand_block, cci_demand_block, tick=False)

    def _advance(self, demand_block, cci_demand_block, *, tick: bool) -> Dict[str, np.ndarray]:
        """One chunk: pack, launch, commit, and with observability on the
        ring update and the observer's records (``tick``: a :meth:`step`,
        recorded as one tick, as the reference's ``step`` records it)."""
        obs = self.obs
        t0 = time.perf_counter() if obs is not None else 0.0
        block, K, endo = self._pack(demand_block, cci_demand_block)
        t = self._state.t
        drain = obs is not None and self._drain_due(t, K)
        host = self._launch(torch.from_numpy(block).to(self.device), K, endo)
        # The ring's demand-side operands, formed while the chunk runs on the card.
        ring_in = self._ring_operands(block, K) if obs is not None else None
        res = host.cpu().numpy()
        out = self._commit(res, K)
        if obs is not None:
            self._observe(t, K, res, out, ring_in, demand_block, endo, drain, tick,
                          h2d=block.nbytes, t0=t0)
        return out

    def _drain_due(self, t: int, K: int) -> bool:
        """Whether the chunk of hours ``t .. t + K − 1`` closes a drain
        window; raises when a drain hour falls strictly inside it
        (``src/repro/fleet/runtime.py:1101-1111``)."""
        cadence = self.obs.cadence
        boundary = ((t // cadence) + 1) * cadence   # first drain > t
        if boundary < t + K:
            raise ValueError(
                f"obs drain cadence {cadence} falls mid-chunk (hour {boundary} inside "
                f"({t}, {t + K})): chunk ends must align with the drain cadence — pick K "
                "dividing the cadence, or step() across the boundary")
        return boundary == t + K

    def _ring_operands(self, block: np.ndarray, K: int) -> tuple:
        """The ring's operands that the demand alone gives, as (K, rows)
        C-ordered host planes: ``d_pair`` (the demand clipped at each demand
        row's capacity, as the chunk kernels clip it), ``month_cum`` (the
        start-of-hour month volume, stepped from the pre-chunk calendar with
        the kernels' adds in their order: at a month start the month base
        takes ``dcum``, then ``dcum − base``, then ``dcum += d_pair``),
        ``d_row`` (topology mode: the clipped pair demand folded onto the
        ports in leg order and clipped at the port capacity; fleet mode:
        ``d_pair``) and, in replay mode, the predictions hour ``t`` reads
        (column ``min(t, T_pred − 1)``)."""
        st = self._state                  # its host calendar is still the pre-chunk one
        t, M, P = st.t, self.n_rows, self.n_demand_rows
        d = block[:K * P].reshape((P, K) if self.topology else (K, P))
        d_pair = np.empty((K, P))
        np.minimum(d.T if self.topology else d, self._obs_cap, out=d_pair)
        month_cum = np.empty((K, P))
        dcum, base = st.dcum.copy(), st.dcum_month
        for k in range(K):
            if (t + k) % self.hours_per_month == 0:
                base = dcum.copy()
            np.subtract(dcum, base, out=month_cum[k])
            dcum += d_pair[k]
        d_row = d_pair
        if self.topology:
            leg_pair, leg_port, attach_w, port_cap = self._obs_legs
            idx = self._obs_fold.get(K)
            if idx is None:   # hour k's legs at k·M + port, in leg order
                idx = self._obs_fold[K] = (np.arange(K)[:, None] * M + leg_port[None, :]).ravel()
            # bincount adds its weights in input order: each port's legs in leg order, from +0.0.
            fold = np.bincount(idx, weights=(d_pair[:, leg_pair] * attach_w).ravel(),
                               minlength=K * M).reshape(K, M)
            d_row = np.minimum(fold, port_cap)
        pred = None
        if self._obs_pred is not None:
            T_pred = self._obs_pred.shape[0]
            pred = self._obs_pred[np.minimum(t + np.arange(K), T_pred - 1)]
        return d_pair, month_cum, d_row, pred

    def _observe(self, t: int, K: int, res: np.ndarray, out: dict, ring_in: tuple,
                 demand_block, endo: bool, drain: bool, tick: bool, *, h2d: int,
                 t0: float) -> None:
        """The ring update and the observer's records for the chunk just
        committed (``src/repro/fleet/runtime.py:1166-1175``): the ring reads
        torch views of the result's numpy planes; in live mode hour k's
        forecast is the pre-chunk one for k = 0 and ``pred_next`` of hour
        k − 1 after."""
        M = self.n_rows
        planes = res.reshape(-1)[:self._n_planes * K * M].reshape(self._n_planes, K, M)
        d_pair, month_cum, d_row, pred = ring_in
        if self.pred_source == "live":
            pred = np.concatenate([self._obs_pred_live[None], planes[8, :K - 1]])
            self._obs_pred_live = planes[8, K - 1].copy()
        view = torch.from_numpy
        st = self._state
        ring = update_ring_chunk(
            st.metrics, self._obs_edges, x_t=view(planes[6]), state_t=view(planes[7]),
            vpn_t=view(planes[0]), cci_t=view(planes[1]), d_pair=view(d_pair),
            d_row=view(d_row), month_cum=view(month_cum), tier_bounds=self._obs_bounds,
            routing_idx=self._obs_route, pred_t=None if pred is None else view(pred),
            cost_t=view(out["cost"].T))
        vec = None
        if drain:
            vec = flatten_ring(ring).numpy()
            ring = reset_ring(ring)
        self._state = st._replace(metrics=ring)
        demand = np.asarray(demand_block, np.float64)
        rec = dict(endo=endo, h2d_bytes=h2d, d2h_bytes=res.nbytes,
                   dt_s=time.perf_counter() - t0)
        if tick:
            self.obs.record_step(t, {k: v[:, 0] for k, v in out.items()}, d_pair=d_pair[0],
                                 demand_t=demand[:, 0], **rec)
        else:
            # Hour k's fields as rows of the (K, rows) planes behind the outputs
            # (contiguous; the outputs are their transposes).
            self.obs.record_chunk(t, [{f: v.T[k] for f, v in out.items()} for k in range(K)],
                                  d_pair=d_pair, demand=demand, **rec)
        if drain:
            self.obs.record_drain(t + K, vec)

    def _pack(self, demand_block, cci_demand_block):
        """The chunk's host-to-device block, flat float64: the demand (and the
        CCI demand) hour-major (K, P) in fleet mode, pair-major (P, K) in
        topology mode (each pair's hours one run, as the routed chunk kernel
        gathers them), then the host's pre-chunk window reads
        pre_v, pre_c (K, M), gathered from the rings (``src/repro/fleet/runtime.py:1061-1100``)."""
        st = self._state
        t, M, P = st.t, self.n_rows, self.n_demand_rows
        d = np.asarray(demand_block, np.float64)
        if d.ndim != 2 or d.shape[0] != P or d.shape[1] < 1:
            raise ValueError(f"demand_block must be (rows, K) = ({P}, K >= 1), got {d.shape}")
        K = d.shape[1]
        endo = cci_demand_block is not None
        nd = (2 if endo else 1) * K * P
        block = np.empty(nd + 2 * K * M)
        shape = (P, K) if self.topology else (K, P)
        order = (lambda x: x) if self.topology else (lambda x: x.T)
        block[:K * P].reshape(shape)[...] = order(d)
        if endo:
            c = np.asarray(cci_demand_block, np.float64)
            if c.shape != d.shape:
                raise ValueError(f"cci_demand_block {c.shape} != demand_block {d.shape}")
            block[K * P:nd].reshape(shape)[...] = order(c)
        # Flat indices into the hour-major (hbuf, M) rings: slot*M + row. One
        # per-row base ((t - h) % hbuf)*M + row, then each later hour a
        # broadcast +M with a single wrap fixup. Hours k >= hbuf always read
        # inside the chunk (h <= hbuf - 1), so only min(K, hbuf) are gathered.
        Kw = min(K, self.hbuf)
        flat = ((t - self._h_np) % self.hbuf) * M + self._rows_idx       # (M,)
        flat = flat[None, :] + (np.arange(Kw) * M)[:, None]              # (Kw, M)
        np.subtract(flat, self.hbuf * M, out=flat, where=flat >= self.hbuf * M)
        if t < self.hbuf:   # early stream: hours before 0 clip to slot 0
            flat = np.where((t + np.arange(Kw))[:, None] < self._h_np[None, :],
                            self._rows_idx[None, :], flat)
        np.take(st.ring_vpn.reshape(-1), flat, out=block[nd:nd + Kw * M].reshape(Kw, M))
        np.take(st.ring_cci.reshape(-1), flat,
                out=block[nd + K * M:nd + (K + Kw) * M].reshape(Kw, M))
        if K > Kw:  # read from the chunk's own snapshots; any value does
            block[nd + Kw * M:nd + K * M] = 0.0
            block[nd + (K + Kw) * M:] = 0.0
        return block, K, endo

    def _launch(self, block: torch.Tensor, K: int, endo: bool) -> torch.Tensor:
        """The chunk on the device, one ``stream_chunk`` (fleet mode) or
        ``stream_chunk_routed`` (topology mode) call. Returns its packed
        float64 result: (8K + 4, M) or flat, the same elements in the same
        order either way: the (K, M) planes vpn, cci, r_vpn, r_cci, snap_v,
        snap_c, x, state (and, in live mode, pred: the forecast made after
        each hour), then dcum, dcum_month (P each), vpn_pref, cci_pref (M
        each). The next device carries are the FSM carry out and views of
        the result's tail; in live mode the forecaster's state out and a view
        of the pred plane's last row."""
        chunk = ops.stream_chunk_routed if self.topology else ops.stream_chunk
        st = self._state
        live = None if self._live is None else (st.ssm_h, st.pred_live, *self._live)
        res = chunk(*self._chunk_args(block, K, endo),
                    renew_in_chunks=self.policy.renew_in_chunks, gate=self._gate, live=live)
        host, fsm = res[0], res[1]
        M, P = self.n_rows, self.n_demand_rows
        flat = host.view(-1)
        tail = flat[self._n_planes * K * M:]
        carries = dict(fsm=fsm, dev_cal=tail[:2 * P].view(2, P), dev_pref=tail[2 * P:].view(2, M))
        if live is not None:
            carries.update(ssm_h=res[2], pred_live=flat[(9 * K - 1) * M:9 * K * M])
        self._state = st._replace(**carries)
        return host

    def _chunk_args(self, block: torch.Tensor, K: int, endo: bool) -> tuple:
        """The chunk wrapper's positional arguments for ``block`` at the
        current state and routing (``renew_in_chunks`` is the policy's, and
        ``gate=self._gate`` the forecast gate's operands in replay mode, None
        otherwise; :meth:`_launch` adds the live operands)."""
        st = self._state
        if self.topology:
            rows = (*self._pair_rows, self._lease, *self._port_rows, self.arrays.routing)
        else:
            rows = self._chunk_rows
        return (block, K, endo, *rows, st.dev_cal, st.fsm, st.dev_pref, st.t,
                self.hours_per_month)

    def _commit(self, host: np.ndarray, K: int) -> Dict[str, np.ndarray]:
        """Adopt the chunk's results on the host: ring slots take the prefix
        snapshots, the accumulators the device's carries (the same adds in
        the same order, so adopting them is the replay)."""
        st = self._state
        t, M, P = st.t, self.n_rows, self.n_demand_rows
        flat = host.reshape(-1)
        n = self._n_planes
        planes = flat[:n * K * M].reshape(n, K, M)
        vpn_t, cci_t, r_vpn, r_cci, snap_v, snap_c = planes[:6]
        x = planes[6].astype(np.int64)
        state = planes[7].astype(np.int64)
        w = min(K, self.hbuf)  # K > hbuf: earlier slots would be rewritten
        slots = (t + np.arange(K - w, K)) % self.hbuf
        st.ring_vpn[slots] = snap_v[K - w:]
        st.ring_cci[slots] = snap_c[K - w:]
        tail = flat[n * K * M:]
        st.dcum[:], st.dcum_month[:] = tail[:2 * P].reshape(2, P)
        st.vpn_pref[:], st.cci_pref[:] = tail[2 * P:].reshape(2, M)
        self._state = st._replace(t=t + K)
        out = {
            "x": x.T,                      # (rows, K) — run()'s stacked layout
            "state": state.T,
            "r_vpn": r_vpn.T,
            "r_cci": r_cci.T,
            "vpn_cost": vpn_t.T,
            "cci_cost": cci_t.T,
            "cost": np.where(x == 1, cci_t, vpn_t).T,
        }
        if n == 9:                         # live mode: the forecast made after each hour
            out["pred_next"] = planes[8].T
        return out

    def run(self, demand, *, cci_demand=None) -> Dict[str, np.ndarray]:
        """Stream a whole (rows, T) matrix hour by hour and stack the outputs
        into the offline planner's (rows, T) layout."""
        demand = np.asarray(demand)
        outs = [
            self.step(demand[:, t],
                      cci_demand_t=None if cci_demand is None else cci_demand[:, t])
            for t in range(demand.shape[1])
        ]
        return {k: np.stack([o[k] for o in outs], axis=1) for k in outs[0]}

    def reroute(self, routing) -> None:
        """Swap the pair→port routing MID-STREAM (topology mode only;
        ``src/repro/fleet/runtime.py:1192-1250``).

        ``routing`` is a :class:`~repro_torch.fleet.routing.RoutingPlan` of
        any hop depth or tree shape whose legs fit the padded bound the
        stream was built with (``plan.total_hops <= n_legs``; a larger plan
        raises ``ValueError``); legacy bare indices and one-hot matrices go
        through the ``DeprecationWarning`` shim, and a spec validates the
        plan. The new leg operand and its port-major index are built on the
        host, once. Every carry — FSM, prefix rings (so window sums near the
        swap mix old- and new-routing hours, as a live system sees them),
        pair billing state, the live forecaster's state — rides across untouched: from this hour on the
        decisions equal :func:`repro_torch.fleet.engine.replay_plan_topology`
        applying the same routing at the same hour.
        """
        if not self.topology:
            raise ValueError("reroute() applies to topology (shared-port) mode; a fleet "
                             "has no routing to swap")
        M, P = self.n_rows, self.n_demand_rows
        plan = as_routing_plan(routing, n_ports=M, context="FleetRuntime.reroute")
        if plan.n_rows != P or plan.n_ports != M:
            raise ValueError(f"plan routes {plan.n_rows} rows onto {plan.n_ports} ports, "
                             f"the stream carries {P} rows on {M} ports")
        if self._spec is not None:
            self._spec.validate_plan(plan)
        E = self.arrays.routing.n_legs
        if plan.total_hops > E:
            raise ValueError(
                f"plan needs {plan.total_hops} legs but the stream was built with a padded "
                f"bound of {E}. Construct the runtime with a routing pad_to()'d to the "
                "maximum hop budget you plan to swap in.")
        plan = plan.pad_to(E)
        old_idx = np.array(self._routing_idx_np)
        self.arrays = self.arrays._replace(routing=plan.operand(torch.float64, self.device))
        self._set_routing_caches(plan)
        if self.obs is not None:
            self._set_obs_routing()
            self.obs.record_reroute(self.t, old_idx, self._routing_idx_np, plan=self.routing_plan)

    # --- observability (only when built with obs=) --------------------------

    def _flush_obs(self) -> None:
        """Drain a partial metrics window (at report and check time only)."""
        if self.obs is None:
            return
        ring = self._state.metrics
        if int(ring.small[0].item()) == 0:
            return
        vec = flatten_ring(ring).numpy()
        self._state = self._state._replace(metrics=reset_ring(ring))
        self.obs.record_drain(self.t, vec)

    def obs_report(self):
        """Flush pending metrics and build the :class:`repro_torch.obs.ObsReport`
        (aggregate counters, cost quantiles, step-latency profile, monitor
        summaries). Raises ``ValueError`` on a runtime built without ``obs=``."""
        if self.obs is None:
            raise ValueError("runtime built without obs=")
        self._flush_obs()
        return self.obs.report()

    def obs_check(self, *, final: bool = True) -> None:
        """Flush pending metrics and run every enabled contract monitor now,
        raising :class:`repro_torch.obs.ContractViolation` on the first breach.
        ``final=True`` also arms the end-of-run checks (the regret monitor's
        oracle ratio: one ``oracle_dp`` launch over the recorded series)."""
        if self.obs is None:
            raise ValueError("runtime built without obs=")
        self._flush_obs()
        self.obs.check(final=final)

    def port_occupancy(self) -> np.ndarray:
        """(M,) pairs attached per port under the current routing (all ones
        in fleet mode: one link per row)."""
        if not self.topology:
            return np.ones(self.n_rows)
        return np.bincount(self._routing_idx_np, minlength=self.n_rows).astype(np.float64)

    def modes(self, out, *, mode_fn: Optional[Callable[[int], str]] = None) -> list:
        """Map one step's FSM states to per-actuator collective modes. Fleet
        mode: one mode per link. Topology mode: one mode per PAIR, each
        inheriting its primary (first-hop) port's state under the current
        routing; pairs sharing an ON port share one leased sync domain.
        ``mode_fn`` maps a state code to a mode; ``None`` uses
        :func:`repro_torch.core.planner.collective_mode`."""
        mode_fn = collective_mode if mode_fn is None else mode_fn
        states = np.asarray(out["state"])
        if self.topology:
            states = states[self._routing_idx_np]
        return [mode_fn(int(s)) for s in states]


# ---------------------------------------------------------------------------
# Actuation: the endogenous-demand planner over the runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetPlannerReport:
    """Realized economics of an actuated streaming run.

    Rows are DECISION rows (links in fleet mode, ports in topology mode);
    the actuator columns ``pair_gb``/``pair_gb_saved`` are per pair (per
    link in fleet mode). ``port_occupancy`` counts the pairs attached to
    each port under the final routing (all ones in fleet mode).
    """

    hours: int
    total_cost: float
    cost_always_vpn: float
    cost_always_cci: float
    on_fraction: np.ndarray        # (M,) fraction of hours the row leased
    total_gb: float
    link_cost: np.ndarray          # (M,) realized cost per decision row
    port_occupancy: np.ndarray     # (M,) pairs attached per port/link
    pair_gb: np.ndarray            # (P,) billed GB per pair/link
    pair_gb_saved: np.ndarray      # (P,) wire GB saved vs always-full-precision

    @property
    def wire_savings_fraction(self) -> float:
        """Fleet-wide fraction of raw wire GB the compressed path saved."""
        raw = self.pair_gb.sum() + self.pair_gb_saved.sum()
        return float(self.pair_gb_saved.sum() / raw) if raw > 0 else 0.0


class ElasticFleetPlanner:
    """N-row :class:`repro_torch.core.planner.InterconnectPlanner`.

    Port of :class:`repro.fleet.runtime.ElasticFleetPlanner`.
    ``feed_hour(bytes)`` per tick: each FSM mode actuates the collective
    layer (``'hierarchical'`` over the leased link at full precision,
    ``'compressed'`` int8 + error feedback on the pay-per-GB path), and each
    mode's counterfactual is priced on its own demand shape: the VPN path
    carries ``compress_ratio`` times fewer billed GB
    (``runtime.step(gb / ratio, cci_demand_t=gb)``). Feed the modes to
    :func:`repro_torch.dist.collectives.fleet_sync_grads` with
    ``groups=sync_groups()``.

    Two routings, like the runtime underneath: *fleet* mode feeds per-link
    bytes and returns per-link modes; *per-port topology* mode (a
    ``TopologySpec`` with ``routing=``, or routed ``TopologyArrays``) feeds
    per-PAIR bytes, prices the shared port leases and returns per-pair
    modes: pairs on one ON port form one leased sync domain
    (``sync_groups()`` is the primary-port vector). ``runtime.reroute``
    re-targets the actuation from the next hour.

    ``compress_ratio`` and ``collective_mode`` are per-instance knobs, as
    in the JAX class (``None``: :data:`COMPRESS_RATIO` and
    :func:`~repro_torch.core.planner.collective_mode`). The runtime's
    keywords pass through (``device=``, ``routing=``, ``policy=``, ``obs=``,
    ...); with observability on, each hour whose sync-domain partition
    changes is traced (``src/repro/fleet/runtime.py:1428-1438``).
    """

    COMPRESS_RATIO = COMPRESS_RATIO

    def __init__(self, fleet, *, compress_ratio: Optional[float] = None,
                 collective_mode: Optional[Callable[[int], str]] = None, **runtime_kw):
        self.runtime = FleetRuntime(fleet, **runtime_kw)
        self.topology = self.runtime.topology
        self.compress_ratio = float(compress_ratio or self.COMPRESS_RATIO)
        self.collective_mode = (collective_mode if collective_mode is not None
                                else globals()["collective_mode"])
        n, p = self.runtime.n_rows, self.runtime.n_demand_rows
        self.cost = np.zeros(n)
        self.cost_vpn_only = np.zeros(n)
        self.cost_cci_only = np.zeros(n)
        self.gb = np.zeros(p)
        self.gb_saved = np.zeros(p)
        self.on_hours = np.zeros(n, np.int64)
        self._dom_sig = None  # the last (groups, modes) signature traced

    def sync_groups(self) -> np.ndarray:
        """(P,) leased-sync-domain id per actuator: the routed primary port
        in topology mode (pairs sharing a port share one domain), its own
        row in fleet mode. Feed as ``groups=`` to ``fleet_sync_grads``."""
        if not self.topology:
            return np.arange(self.runtime.n_rows)
        return self.runtime._routing_idx_np.copy()

    def feed_hour(self, cross_pod_bytes) -> list:
        """Account one hour of per-actuator cross-pod traffic (bytes; per
        link in fleet mode, per pair in topology mode). Returns each
        actuator's collective mode for the hour just served."""
        raw_gb = np.asarray(cross_pod_bytes, np.float64) / 1e9
        out = self.runtime.step(raw_gb / self.compress_ratio, cci_demand_t=raw_gb)
        on = out["x"] == 1
        vpn_c, cci_c = out["vpn_cost"], out["cci_cost"]
        self.cost += np.where(on, cci_c, vpn_c)
        self.cost_vpn_only += vpn_c
        self.cost_cci_only += cci_c
        modes = self.runtime.modes(out, mode_fn=self.collective_mode)
        if self.runtime.obs is not None:
            # A sync domain is a (port, mode) bucket of actuators; trace only
            # the hours where the partition changes.
            groups = self.sync_groups()
            sig = (groups.tobytes(), "".join(m[0] for m in modes))
            if sig != self._dom_sig:
                n_dom = len(set(zip(groups.tolist(), modes)))
                self.runtime.obs.record_sync_domains(self.runtime.t - 1, n_dom, len(modes))
                self._dom_sig = sig
        on_act = np.asarray([m == "hierarchical" for m in modes])
        self.gb += np.where(on_act, raw_gb, raw_gb / self.compress_ratio)
        self.gb_saved += np.where(on_act, 0.0, raw_gb - raw_gb / self.compress_ratio)
        self.on_hours += on
        return modes

    def report(self) -> FleetPlannerReport:
        h = self.runtime.t
        return FleetPlannerReport(
            hours=h,
            total_cost=float(self.cost.sum()),
            cost_always_vpn=float(self.cost_vpn_only.sum()),
            cost_always_cci=float(self.cost_cci_only.sum()),
            on_fraction=self.on_hours / max(1, h),
            total_gb=float(self.gb.sum()),
            link_cost=self.cost.copy(),
            port_occupancy=self.runtime.port_occupancy(),
            pair_gb=self.gb.copy(),
            pair_gb_saved=self.gb_saved.copy(),
        )


def streaming_forecast_policy(
    arrays,
    history,
    *,
    margin=0.05,
    hours_per_month: int = 730,
    renew_in_chunks: bool = False,
    device: DeviceLike = None,
    **train_kw,
):
    """A live-mode forecast policy and its streaming forecaster, on
    ``device`` (CUDA unless the caller says otherwise):
    :func:`repro.fleet.runtime.streaming_forecast_policy`.

    Causal: the forecaster trains on the (rows, H) ``history`` block and the
    demand→cost coefficients are fitted on the history's cost series
    (:func:`repro_torch.fleet.engine.routed_cost_series`), so nothing of the
    live horizon is needed. ``arrays`` may be fleet or routed topology
    arrays; a topology history is per PAIR and aggregated onto the ports as
    the engine aggregates demand. Returns ``(policy, forecaster)`` for
    ``FleetRuntime(..., policy=policy, forecaster=forecaster)``; the policy's
    ``pred_demand`` is zeros (live mode does not read it).
    """
    from .engine import routed_cost_series
    from .policy import fit_cost_coef, forecast_gated_policy, forecast_horizon_hours

    dev = resolve_device(device)
    arrays = arrays.to(dev)
    s = routed_cost_series(arrays, to_host(history, np.float64),
                           hours_per_month=hours_per_month, device=dev)
    coef = fit_cost_coef(s.row_demand, s.vpn, s.cci)
    fc = StreamingForecaster.fit(s.row_demand.cpu().numpy(), forecast_horizon_hours(arrays.toggle),
                                 device=dev, **train_kw)
    policy = forecast_gated_policy(arrays.toggle, np.zeros(s.row_demand.shape[0]), margin=margin,
                                   cost_coef=coef, renew_in_chunks=renew_in_chunks)
    return policy, fc

"""The typed routing currency: :class:`RoutingPlan` + :class:`RoutingOperand`.

Port of :mod:`repro.fleet.routing`. A :class:`RoutingPlan` is the
host-side routing decision: one ordered port tuple per demand row (a 1-hop
unicast row is ``(m,)``, a relay path ``(m1, m2, ...)``, a multicast tree
the ordered tuple of its distinct forwarding edges), the padded leg bound,
which rows are trees, and provenance. A :class:`RoutingOperand` is its
device-side *leg list*: each leg attaches one demand row to one port with a
VPN counterfactual share (``1 / len(path)``, float64, computed here on the
host) and an attachment weight, padded to ``n_legs`` with zero-weight legs
on row 0 / port 0.

The engine folds pairs onto ports with the ``leg_segment_sum`` kernel,
which walks each port's legs in ascending leg index. It needs the legs in
port-major order, so :meth:`RoutingPlan.operand` also builds a
:class:`LegIndex` once, on the host: a stable sort of ``leg_port`` (within a
port the legs stay in ascending order), the offsets of each port's run, the
per-port attachment count ``seg(attach_w)`` (0/1 sums, exact in any order),
and the legs' pair, VPN share and attachment weight in that order, for the
streaming runtime's routed chunk kernel, with the legs of its busiest port,
counted there on the host so that no launch reads the device to choose its
form.

Legacy bare-array routings (``(P,)`` port indices or ``(M, P)`` one-hot
matrices) are accepted through :func:`as_routing_plan`, which raises a
:class:`DeprecationWarning` naming the call site, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.leg_segment_sum import port_major

__all__ = [
    "LegIndex",
    "RoutingOperand",
    "RoutingPlan",
    "as_routing_plan",
    "index_legs",
    "leg_index_np",
    "padded_operand_np",
]


class LegIndex(NamedTuple):
    """Port-major view of a leg list, built once per routing on the host.

    ``leg_pair_pm``, ``vpn_w_pm`` and ``attach_w_pm`` are the leg list's own
    columns gathered through ``order`` (``leg_pair[order]``, ...): each
    port's legs in ascending leg index, one contiguous run from
    ``start[m]``, so that the routed chunk kernel stages a port's legs with
    no ``order`` indirection. :meth:`RoutingPlan.operand` and
    :func:`index_legs` build them; an index without them (None) serves the
    planners' ``leg_segment_sum``, and the routed chunk refuses it.

    ``max_legs`` (the legs of the busiest port, the longest run) is a host
    int, counted from the runs where they are built on the host; the routed
    chunk chooses its launch form from it and the port count
    (:func:`~repro_torch.kernels.stream_chunk.routed_launch_form`). ``-1``
    on an index built without it, which the routed chunk launches in its
    port-block form. :meth:`to` keeps it.
    """

    order: torch.Tensor     # (E,) int32 leg indices sorted by port, stable
    start: torch.Tensor     # (M + 1,) int32 offsets of each port's run in order
    n_attach: torch.Tensor  # (M,) float64 attachments per port (seg(attach_w))
    leg_pair_pm: Optional[torch.Tensor] = None   # (E,) int32 leg_pair[order]
    vpn_w_pm: Optional[torch.Tensor] = None      # (E,) vpn_w[order]
    attach_w_pm: Optional[torch.Tensor] = None   # (E,) attach_w[order]
    max_legs: int = -1                           # legs of the busiest port (host)

    @property
    def n_ports(self) -> int:
        return self.start.shape[-1] - 1

    @property
    def port_major(self) -> bool:
        """Whether the port-major leg descriptors are there."""
        return self.leg_pair_pm is not None

    def to(self, device) -> "LegIndex":
        return LegIndex(*(t.to(device) if torch.is_tensor(t) else t for t in self))


def _max_legs(start: np.ndarray) -> int:
    """The legs of a port-major index's busiest port from its (M + 1,)
    offsets on the host."""
    return int(np.diff(start).max()) if len(start) > 1 else 0


def leg_index_np(leg_port: np.ndarray, attach_w: np.ndarray, n_ports: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(order, start, n_attach)`` of a leg list as numpy arrays: the legs
    stably sorted by port, each port's offsets, and its attachment sum
    accumulated in leg order."""
    order, start = port_major(leg_port, n_ports)
    n_attach = np.zeros(n_ports, np.float64)
    np.add.at(n_attach, np.asarray(leg_port, np.int64),
              np.asarray(attach_w, np.float64))      # unbuffered, in leg order
    return order, start, n_attach


class RoutingOperand(NamedTuple):
    """Device-side leg list — the tensors the engine aggregates with.

    ``E = n_legs`` is the padded leg bound. Padding legs have ``attach_w ==
    vpn_w == 0`` and point at row/port 0, so they add exact zeros to finite
    sums (and NaN where row 0 holds a NaN, as the JAX scatter does).
    ``index`` is the port-major :class:`LegIndex` the CUDA kernel walks;
    :meth:`RoutingPlan.operand` builds it, :func:`index_legs` adds it to an
    operand built elsewhere.
    """

    leg_pair: torch.Tensor   # (E,) int32 demand-row index of each leg
    leg_port: torch.Tensor   # (E,) int32 port index of each leg
    vpn_w: torch.Tensor      # (E,) float VPN-counterfactual share (1/n_hops)
    attach_w: torch.Tensor   # (E,) float 1.0 active leg / 0.0 padding
    primary: torch.Tensor    # (P,) int32 first-hop port per demand row
    index: Optional[LegIndex] = None

    @property
    def n_legs(self) -> int:
        return self.leg_pair.shape[-1]

    @property
    def n_rows(self) -> int:
        return self.primary.shape[-1]

    def to(self, device) -> "RoutingOperand":
        """The same operand on ``device`` (no copy where it already lies there)."""
        return RoutingOperand(*(None if f is None else f.to(device) for f in self))


def index_legs(op: RoutingOperand, n_ports: int) -> RoutingOperand:
    """``op`` with its :class:`LegIndex` built on the host, port-major leg
    descriptors included (a no-op when it has a whole one for ``n_ports``
    ports), on the operand's device."""
    if op.index is not None and op.index.n_ports == n_ports and op.index.port_major:
        return op
    dev = op.leg_port.device
    order, start, n_attach = leg_index_np(
        np.asarray(op.leg_port.cpu()), np.asarray(op.attach_w.cpu(), np.float64), n_ports
    )
    order_t = torch.tensor(order, device=dev)
    gather = lambda col: col.to(dev)[order_t.long()].contiguous()
    idx = LegIndex(
        order=order_t,
        start=torch.tensor(start, device=dev),
        n_attach=torch.tensor(n_attach, dtype=torch.float64, device=dev),
        leg_pair_pm=gather(op.leg_pair),
        vpn_w_pm=gather(op.vpn_w),
        attach_w_pm=gather(op.attach_w),
        max_legs=_max_legs(start),
    )
    return op._replace(index=idx)


def _legs_np(paths, n_legs: int, pad_pair: int = 0, pad_port: int = 0):
    """Row-major legs of ``paths`` padded to ``n_legs``: ``vw = 1.0 /
    len(path)`` in float64, as :meth:`repro.fleet.routing.RoutingPlan.operand`."""
    lp = np.full(n_legs, pad_pair, np.int32)
    lm = np.full(n_legs, pad_port, np.int32)
    vw = np.zeros(n_legs, np.float64)
    aw = np.zeros(n_legs, np.float64)
    k = 0
    for i, path in enumerate(paths):
        w = 1.0 / len(path)
        for m in path:
            lp[k], lm[k], vw[k], aw[k] = i, m, w, 1.0
            k += 1
    return lp, lm, vw, aw


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """One routing decision for a topology: a port path per demand row.

    ``paths[i]`` is the ordered tuple of DISTINCT ports demand row ``i``
    occupies — ``(m,)`` for classic unicast, ``(m1, m2)`` for a relay path,
    or a multicast forwarding tree's edge set (shared edges appear once and
    are charged once). ``n_legs`` is the padded leg bound of the device
    operand.
    """

    paths: Tuple[Tuple[int, ...], ...]
    n_ports: int
    n_legs: int = -1                    # -1 -> tight bound (total_hops)
    tree_rows: Tuple[int, ...] = ()     # row indices that are multicast trees
    provenance: str = "manual"

    def __post_init__(self) -> None:
        paths = tuple(tuple(int(m) for m in p) for p in self.paths)
        object.__setattr__(self, "paths", paths)
        assert len(paths) >= 1, "a RoutingPlan needs at least one row"
        for i, path in enumerate(paths):
            assert len(path) >= 1, f"row {i}: empty port path"
            assert len(set(path)) == len(path), (
                f"row {i}: path {path} visits a port twice"
            )
            assert all(0 <= m < self.n_ports for m in path), (
                f"row {i}: port out of range [0, {self.n_ports}) in {path}"
            )
        tr = tuple(sorted(int(i) for i in self.tree_rows))
        assert all(0 <= i < len(paths) for i in tr), "tree_rows out of range"
        object.__setattr__(self, "tree_rows", tr)
        tight = sum(len(p) for p in paths)
        n_legs = tight if self.n_legs < 0 else int(self.n_legs)
        assert n_legs >= tight, (
            f"n_legs={n_legs} cannot hold {tight} routed legs — pad_to() a "
            "larger bound"
        )
        object.__setattr__(self, "n_legs", n_legs)

    # -- shape ------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return len(self.paths)

    @property
    def hop_depth(self) -> int:
        """Longest path (1 for a pure unicast plan)."""
        return max(len(p) for p in self.paths)

    @property
    def total_hops(self) -> int:
        return sum(len(p) for p in self.paths)

    @property
    def is_unicast(self) -> bool:
        """True when every row is a classic 1-hop unicast assignment."""
        return self.hop_depth == 1 and not self.tree_rows

    # -- views ------------------------------------------------------------
    @property
    def primary(self) -> np.ndarray:
        """(P,) first-hop port per row — the legacy ``routing_idx`` view."""
        return np.array([p[0] for p in self.paths], dtype=np.int64)

    def port_indices(self) -> np.ndarray:
        """(P,) port indices — only defined for pure 1-hop unicast plans."""
        if not self.is_unicast:
            raise TypeError(
                "port_indices() is only defined for 1-hop unicast plans; "
                f"this plan has hop_depth={self.hop_depth}, "
                f"{len(self.tree_rows)} tree rows — use .paths"
            )
        return self.primary

    def __array__(self, dtype=None, copy=None):
        a = self.port_indices()
        return a.astype(dtype) if dtype is not None else a

    def ports_used(self) -> Tuple[int, ...]:
        return tuple(sorted({m for p in self.paths for m in p}))

    @property
    def matrix(self) -> np.ndarray:
        """(M, P) float64 multi-hot membership matrix (one-hot when every
        row is 1-hop — exactly the legacy routing matrix)."""
        R = np.zeros((self.n_ports, self.n_rows))
        for i, path in enumerate(self.paths):
            R[list(path), i] = 1.0
        return R

    # -- derivation -------------------------------------------------------
    def pad_to(self, n_legs: int) -> "RoutingPlan":
        """Same plan under a larger padded leg bound (zero-weight legs)."""
        return dataclasses.replace(self, n_legs=int(n_legs))

    def replace_path(
        self, row: int, path: Union[int, Sequence[int]]
    ) -> "RoutingPlan":
        """A new plan with row ``row`` re-routed (int means 1-hop)."""
        p = (int(path),) if isinstance(path, (int, np.integer)) else tuple(path)
        paths = list(self.paths)
        paths[int(row)] = p
        tight = sum(len(q) for q in paths)
        return dataclasses.replace(
            self, paths=tuple(paths), n_legs=max(self.n_legs, tight)
        )

    def operand(self, dtype=torch.float64, device: DeviceLike = None) -> RoutingOperand:
        """Stack to the device leg list, padded to ``n_legs``, with its
        port-major :class:`LegIndex`, on ``device`` (CUDA by default)."""
        dev = resolve_device(device)
        lp, lm, vw, aw = _legs_np(self.paths, self.n_legs)
        order, start, n_attach = leg_index_np(lm, aw, self.n_ports)
        i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
        f = lambda a: torch.tensor(a, dtype=torch.float64, device=dev).to(dtype)
        return RoutingOperand(
            leg_pair=i32(lp),
            leg_port=i32(lm),
            vpn_w=f(vw),
            attach_w=f(aw),
            primary=i32(self.primary),
            index=LegIndex(order=i32(order), start=i32(start), n_attach=f(n_attach),
                           leg_pair_pm=i32(lp[order]), vpn_w_pm=f(vw[order]),
                           attach_w_pm=f(aw[order]), max_legs=_max_legs(start)),
        )

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_indices(
        cls,
        indices: Sequence[int],
        n_ports: int,
        *,
        n_legs: int = -1,
        provenance: str = "from_indices",
    ) -> "RoutingPlan":
        r = np.asarray(indices, dtype=np.int64)
        assert r.ndim == 1, f"expected (P,) port indices, got shape {r.shape}"
        return cls(
            paths=tuple((int(m),) for m in r),
            n_ports=int(n_ports),
            n_legs=n_legs,
            provenance=provenance,
        )

    @classmethod
    def from_matrix(
        cls, matrix, *, n_legs: int = -1, provenance: str = "from_matrix"
    ) -> "RoutingPlan":
        """From a padded one-hot ``(M, P)`` matrix (the legacy operand)."""
        R = np.asarray(matrix, dtype=np.float64)
        assert R.ndim == 2, f"expected (M, P) matrix, got shape {R.shape}"
        colsum = R.sum(axis=0)
        assert np.all(colsum == 1.0) and np.all((R == 0.0) | (R == 1.0)), (
            "routing matrix must be one-hot per pair column"
        )
        return cls.from_indices(
            np.argmax(R, axis=0), R.shape[0], n_legs=n_legs,
            provenance=provenance,
        )

    @classmethod
    def from_operand(
        cls,
        op: RoutingOperand,
        n_ports: int,
        *,
        tree_rows: Sequence[int] = (),
        provenance: str = "from_operand",
    ) -> "RoutingPlan":
        lp = np.asarray(op.leg_pair.cpu())
        lm = np.asarray(op.leg_port.cpu())
        aw = np.asarray(op.attach_w.cpu())
        P = int(op.primary.shape[0])
        paths: list = [[] for _ in range(P)]
        for i, m, w in zip(lp, lm, aw):
            if w != 0.0:
                paths[int(i)].append(int(m))
        return cls(
            paths=tuple(tuple(p) for p in paths),
            n_ports=int(n_ports),
            n_legs=int(lp.shape[0]),
            tree_rows=tuple(tree_rows),
            provenance=provenance,
        )


def as_routing_plan(
    routing,
    *,
    n_ports: int,
    context: str = "this API",
    n_legs: int = -1,
) -> RoutingPlan:
    """Normalize any accepted routing form to a :class:`RoutingPlan`.

    ``RoutingPlan`` passes through untouched. The legacy bare-array forms —
    a ``(P,)`` port-index sequence or a padded one-hot ``(M, P)`` matrix —
    still work but raise a :class:`DeprecationWarning` naming the call site.
    """
    if isinstance(routing, RoutingPlan):
        return routing
    r = np.asarray(routing.cpu() if isinstance(routing, torch.Tensor) else routing)
    if r.ndim == 1:
        warnings.warn(
            f"passing bare (P,) routing indices to {context} is deprecated; "
            "pass a RoutingPlan (e.g. RoutingPlan.from_indices(r, n_ports) "
            "or the plan returned by optimize_routing)",
            DeprecationWarning,
            stacklevel=3,
        )
        return RoutingPlan.from_indices(
            r, n_ports, n_legs=n_legs, provenance=f"legacy-indices:{context}"
        )
    if r.ndim == 2:
        warnings.warn(
            f"passing a bare (M, P) one-hot routing matrix to {context} is "
            "deprecated; pass a RoutingPlan (RoutingPlan.from_matrix(R))",
            DeprecationWarning,
            stacklevel=3,
        )
        return RoutingPlan.from_matrix(
            r, n_legs=n_legs, provenance=f"legacy-matrix:{context}"
        )
    raise TypeError(
        f"{context}: cannot interpret routing of type {type(routing).__name__} "
        f"with shape {getattr(r, 'shape', None)} as a RoutingPlan"
    )


def padded_operand_np(
    plan: RoutingPlan,
    *,
    n_legs: int,
    n_rows: int,
    pad_pair: int,
    pad_port: int,
) -> RoutingOperand:
    """Host-side padded operand for a pooled gateway: legs padded to
    ``n_legs`` pointing at the pool's inert (pad_pair, pad_port) slot with
    zero weights, primary padded to ``n_rows`` with ``pad_port``.

    Returns a :class:`RoutingOperand` of NUMPY fields and no index (the
    pool tiles them and builds its index itself)."""
    tight = plan.total_hops
    assert n_legs >= tight, f"legs_cap {n_legs} < {tight} routed legs"
    assert n_rows >= plan.n_rows
    lp, lm, vw, aw = _legs_np(plan.paths, n_legs, pad_pair, pad_port)
    primary = np.full(n_rows, pad_port, np.int32)
    primary[: plan.n_rows] = plan.primary
    return RoutingOperand(
        leg_pair=lp, leg_port=lm, vpn_w=vw, attach_w=aw, primary=primary
    )

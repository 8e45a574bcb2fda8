"""System-level structural description: a 2D mesh of chips.

:class:`SystemConfig` is to the *system* what
:class:`~repro_torch.core.arch.ChipConfig` is to one chip: pure structure —
how many chips, how they are arranged, which inter-chip link tier ties
them together, and how many of each chip's global-memory ports are
reserved for off-chip ("boundary") traffic.  Every timing/energy rule
for those links lives in :class:`~repro_torch.core.machine.InterChipLink` /
the :class:`~repro_torch.core.machine.MachineModel` accessors — this module
deliberately contains no constants of its own.

Pipeline-parallel plans place consecutive stages on consecutive chips
of a *snake* ordering of the mesh, so adjacent stages are one hop
apart; transfers between non-adjacent stages pay the Manhattan
distance between their chips' mesh coordinates.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Tuple, Union

from ..core.machine import InterChipLink, link_tier

__all__ = ["SystemConfig", "PARALLEL_MODES"]

PARALLEL_MODES = ("pipeline", "tensor")


@dataclass(frozen=True)
class SystemConfig:
    """A mesh of identical chips plus the link tier joining them.

    ``parallel`` selects the system-level partitioner: ``pipeline``
    (contiguous stage ranges per chip, SEND/RECV at the cuts) or
    ``tensor`` (every MVM group sharded across all chips, collectives
    at shard boundaries).  ``boundary_ports`` caps how many of a chip's
    gmem ports an inter-chip transfer may drain through — the
    contention model of :meth:`MachineModel.interchip_transfer_cycles`.

    ``failed_chips`` / ``failed_links`` mark dead mesh slots / directed
    link pairs (stored as sorted slot pairs): the partitioners place
    work on the surviving slots only and :meth:`hops` routes around the
    failures (BFS over the live grid).  Both default empty — a
    fault-free config is bit-identical to one predating the fields, in
    behaviour *and* in :meth:`to_dict` (so cached plans keep their
    keys).
    """

    chips_x: int = 1
    chips_y: int = 1
    link: Union[InterChipLink, str] = "pcb"
    boundary_ports: int = 2
    parallel: str = "pipeline"
    failed_chips: Tuple[int, ...] = ()
    failed_links: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self) -> None:
        if self.chips_x < 1 or self.chips_y < 1:
            raise ValueError(f"mesh dims must be >= 1, got "
                             f"{self.chips_x}x{self.chips_y}")
        if isinstance(self.link, str):
            object.__setattr__(self, "link", link_tier(self.link))
        if not isinstance(self.link, InterChipLink):
            raise TypeError(f"link must be an InterChipLink or tier "
                            f"name, got {type(self.link).__name__}")
        if self.boundary_ports < 1:
            raise ValueError("boundary_ports must be >= 1")
        if self.parallel not in PARALLEL_MODES:
            raise ValueError(f"parallel must be one of {PARALLEL_MODES},"
                             f" got {self.parallel!r}")
        n = self.chips_x * self.chips_y
        fc = tuple(sorted({int(c) for c in self.failed_chips}))
        fl = tuple(sorted({tuple(sorted((int(a), int(b))))
                           for a, b in self.failed_links}))
        for c in fc:
            if not 0 <= c < n:
                raise ValueError(f"failed chip slot {c} out of range "
                                 f"0..{n - 1}")
        for a, b in fl:
            if not (0 <= a < n and 0 <= b < n) or a == b:
                raise ValueError(f"failed link ({a}, {b}) is not a "
                                 f"pair of distinct slots in 0..{n - 1}")
        if len(fc) >= n:
            raise ValueError("all chips failed — nothing left to plan on")
        object.__setattr__(self, "failed_chips", fc)
        object.__setattr__(self, "failed_links", fl)

    # -- derived -----------------------------------------------------------

    @property
    def n_chips(self) -> int:
        return self.chips_x * self.chips_y

    def coord(self, slot: int) -> Tuple[int, int]:
        """Mesh (row, col) of logical chip ``slot`` in snake order —
        slot ``k`` and ``k+1`` are always mesh neighbours."""
        if not 0 <= slot < self.n_chips:
            raise IndexError(f"chip slot {slot} out of range "
                             f"0..{self.n_chips - 1}")
        row, r = divmod(slot, self.chips_x)
        col = r if row % 2 == 0 else self.chips_x - 1 - r
        return row, col

    def hops(self, a: int, b: int) -> int:
        """Hop distance between two logical chip slots.

        Fault-free meshes use the closed-form Manhattan distance.
        With failures present, the distance is a BFS over the
        surviving grid (failed chips cannot route through, failed
        links are cut); an unreachable pair raises — the mesh has
        partitioned and no plan can span it.
        """
        ra, ca = self.coord(a)
        rb, cb = self.coord(b)
        if not self.failed_chips and not self.failed_links:
            return abs(ra - rb) + abs(ca - cb)
        if a in self.failed_chips or b in self.failed_chips:
            raise ValueError(f"hops({a}, {b}): endpoint is a failed chip")
        if a == b:
            return 0
        dead_links = set(self.failed_links)
        dead = set(self.failed_chips)
        dist = {a: 0}
        q = deque([a])
        while q:
            s = q.popleft()
            for t in self._grid_neighbors(s):
                if t in dist or t in dead:
                    continue
                if tuple(sorted((s, t))) in dead_links:
                    continue
                dist[t] = dist[s] + 1
                if t == b:
                    return dist[t]
                q.append(t)
        raise ValueError(
            f"hops({a}, {b}): mesh partitioned by failures "
            f"(chips {self.failed_chips}, links {self.failed_links})")

    def _slot_at(self, row: int, col: int) -> int:
        """Inverse of :meth:`coord` (snake ordering)."""
        r = col if row % 2 == 0 else self.chips_x - 1 - col
        return row * self.chips_x + r

    def _grid_neighbors(self, slot: int) -> Iterable[int]:
        r, c = self.coord(slot)
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rr, cc = r + dr, c + dc
            if 0 <= rr < self.chips_y and 0 <= cc < self.chips_x:
                yield self._slot_at(rr, cc)

    @property
    def alive_slots(self) -> Tuple[int, ...]:
        """Surviving chip slots in snake order — the slots the
        partitioners place work on."""
        dead = set(self.failed_chips)
        return tuple(s for s in range(self.n_chips) if s not in dead)

    @property
    def n_alive(self) -> int:
        return self.n_chips - len(self.failed_chips)

    def degrade(self, failed_chips: Iterable[int] = (),
                failed_links: Iterable[Tuple[int, int]] = ()
                ) -> "SystemConfig":
        """This config with additional failures folded in (union with
        any already present) — the mesh-failover entry point used by
        :class:`repro_torch.faults.FaultModel`-driven sweeps."""
        return dataclasses.replace(
            self,
            failed_chips=self.failed_chips + tuple(failed_chips),
            failed_links=self.failed_links + tuple(
                tuple(l) for l in failed_links))

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "chips_x": self.chips_x, "chips_y": self.chips_y,
            "link": self.link.to_dict(),
            "boundary_ports": self.boundary_ports,
            "parallel": self.parallel}
        # only serialized when present: a fault-free config's dict (and
        # hence every derived cache key) is byte-identical to the
        # pre-failover format
        if self.failed_chips:
            out["failed_chips"] = list(self.failed_chips)
        if self.failed_links:
            out["failed_links"] = [list(l) for l in self.failed_links]
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SystemConfig":
        link = d.get("link", "pcb")
        if isinstance(link, Mapping):
            link = InterChipLink.from_dict(link)
        return cls(chips_x=int(d.get("chips_x", 1)),
                   chips_y=int(d.get("chips_y", 1)), link=link,
                   boundary_ports=int(d.get("boundary_ports", 2)),
                   parallel=str(d.get("parallel", "pipeline")),
                   failed_chips=tuple(d.get("failed_chips", ())),
                   failed_links=tuple(tuple(l) for l in
                                      d.get("failed_links", ())))

    @classmethod
    def mesh(cls, n_chips: int, **kw: Any) -> "SystemConfig":
        """The squarest mesh holding ``n_chips`` (4 -> 2x2, 8 -> 2x4)."""
        n = int(n_chips)
        if n < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        best = 1
        for c in range(1, int(n ** 0.5) + 1):
            if n % c == 0:
                best = c
        return cls(chips_x=n // best, chips_y=best, **kw)

    def describe(self) -> str:
        s = (f"system {self.chips_x}x{self.chips_y} chips, "
             f"{self.parallel}-parallel, link '{self.link.name}' "
             f"({self.link.bytes_per_cycle:g} B/cyc, "
             f"{self.link.hop_cycles} cyc/hop), "
             f"{self.boundary_ports} boundary ports")
        if self.failed_chips or self.failed_links:
            s += (f" [degraded: {len(self.failed_chips)} chip(s), "
                  f"{len(self.failed_links)} link(s) failed]")
        return s

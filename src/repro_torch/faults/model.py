"""Fault models and their deterministic resolution to fault sets.

Host code copied from :mod:`repro.faults.model` (the JAX package): the
masks are drawn exactly as there, so a :class:`FaultSet` of the port
holds the same bits as the JAX package's for the same seed.  Beside the
numpy hooks, :meth:`FaultSet.corrupt_weight_matrix` and
:meth:`FaultSet.corrupt_acc` take tensors and corrupt them on their own
device.

Determinism contract
--------------------

Every random draw in this module flows from a
:class:`numpy.random.SeedSequence` keyed by ``(model.seed, namespace,
coordinates...)`` — no global RNG state, no draw-order coupling between
groups, tiles or samples.  Two consequences the tests pin:

* the same :class:`FaultModel` resolves to bit-identical fault sets on
  every run, every process and every backend;
* resolving group 7's faults never changes group 3's (each tile owns
  an independent stream), so fault sets are stable under workload
  slicing — the property mesh failover relies on.

Logical vs physical faults
--------------------------

:class:`FaultSet` describes faults in *weight-matrix space*: stuck
bits at ``(k, n, bit)`` coordinates of each group's ``(K, N)`` int8
weight matrix, drawn per MG-sized tile (``macro.rows`` x
``group_n_out``).  Applying the same set to the oracle's weights and
to the weights a gmem image is built from makes the tensor oracle (plain
or on the CUDA kernel) and the functional ISS agree bit-exactly on the
*corrupted* outputs — which is what makes accuracy-degradation numbers
trustworthy across fidelities.

:class:`PhysicalCimFaults` describes faults in *array space*: stuck
bits pinned to a physical ``(core, macro group)`` array.  The
functional ISS applies them when ``CIM_LOAD`` latches rows into the
array, so whatever logical tile the compiler happened to place there
gets corrupted — the hardware-eye view, independent of mapping.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["FaultModel", "FaultSet", "PhysicalCimFaults",
           "resolve_faults", "corrupt_gmem", "residual_rate"]

# SeedSequence namespaces: keep the per-purpose streams disjoint even
# when coordinate tuples collide (e.g. gid 0 / core 0).
_NS_STUCK = 1
_NS_TRANSIENT = 2
_NS_GMEM = 3
_NS_PHYSICAL = 4


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(list(key)))


@dataclass(frozen=True)
class FaultModel:
    """One frozen, seeded description of every fault process.

    ``rate`` is the headline knob — the per-bit stuck-at fault
    probability in the CIM weight arrays — so ``FaultModel(rate=0)``
    (the default) is an exact no-op everywhere.  ``transient_rate``
    flips accumulator bits per MVM evaluation; ``gmem_rate`` flips one
    bit per affected 32-bit global-memory word.  ``failed_chips`` /
    ``failed_links`` name dead mesh slots / inter-chip links for
    system-level failover (see :mod:`repro_torch.system`:
    :meth:`SystemConfig.degrade` re-plans around them).
    """

    rate: float = 0.0            # stuck-at, per CIM weight bit
    transient_rate: float = 0.0  # per accumulator bit per MVM
    gmem_rate: float = 0.0       # per 32-bit gmem word
    seed: int = 0
    failed_chips: Tuple[int, ...] = ()
    failed_links: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self) -> None:
        for f in ("rate", "transient_rate", "gmem_rate"):
            v = getattr(self, f)
            if not (0.0 <= v <= 1.0) or not math.isfinite(v):
                raise ValueError(f"{f} must be in [0, 1], got {v!r}")
        if not (isinstance(self.seed, int) and self.seed >= 0):
            raise ValueError(f"seed must be a non-negative int, "
                             f"got {self.seed!r}")
        object.__setattr__(self, "failed_chips",
                           tuple(sorted(int(c) for c in self.failed_chips)))
        object.__setattr__(
            self, "failed_links",
            tuple(sorted(tuple(sorted((int(a), int(b))))
                         for a, b in self.failed_links)))

    @property
    def is_null(self) -> bool:
        """True when the model injects nothing and fails nothing."""
        return (self.rate == 0.0 and self.transient_rate == 0.0
                and self.gmem_rate == 0.0 and not self.failed_chips
                and not self.failed_links)

    def to_dict(self) -> Dict[str, Any]:
        return {"rate": self.rate, "transient_rate": self.transient_rate,
                "gmem_rate": self.gmem_rate, "seed": self.seed,
                "failed_chips": list(self.failed_chips),
                "failed_links": [list(l) for l in self.failed_links]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultModel":
        return cls(rate=float(d.get("rate", 0.0)),
                   transient_rate=float(d.get("transient_rate", 0.0)),
                   gmem_rate=float(d.get("gmem_rate", 0.0)),
                   seed=int(d.get("seed", 0)),
                   failed_chips=tuple(d.get("failed_chips", ())),
                   failed_links=tuple(tuple(l) for l in
                                      d.get("failed_links", ())))

    def mitigated(self, chip: Any) -> "FaultModel":
        """The residual model after the chip's protection hardware.

        Reads :class:`repro_torch.core.arch.ProtectionConfig` off the chip
        and scales the stuck-at / transient rates by
        :func:`residual_rate` — the "how much protection is worth it at
        fault rate X" half of a DSE sweep (the cost half lives on the
        :class:`~repro_torch.core.machine.MachineModel`).
        """
        import dataclasses
        p = chip.core.cim.protection
        return dataclasses.replace(
            self,
            rate=residual_rate(self.rate, p, chip.core.cim.macro),
            transient_rate=residual_rate(self.transient_rate, p,
                                         chip.core.cim.macro,
                                         transient=True))


def residual_rate(rate: float, protection: Any, macro: Any,
                  transient: bool = False) -> float:
    """First-order residual fault rate after mitigation hardware.

    * **TMR** votes three copies: a bit survives unless >= 2 copies
      fault — residual ``3p^2 - 2p^3``.
    * **ECC** (SECDED over 72-bit words) corrects any single error: a
      bit stays wrong only if another bit of its word also faulted —
      residual ``p * (1 - (1-p)^71)``.
    * **Row sparing** remaps faulty rows to ``spare_rows`` spares per
      macro: residual scales by the fraction of expected faulty rows
      the spares cannot cover.  Spares hold *weights*, so they do not
      reduce transient (datapath) faults.

    These are independence-assuming closed forms — good enough to rank
    protection levels in a sweep, not a reliability sign-off.
    """
    p = float(rate)
    if p <= 0.0:
        return 0.0
    if protection.tmr:
        p = 3.0 * p * p - 2.0 * p ** 3
    if protection.ecc:
        p = p * (1.0 - (1.0 - p) ** 71)
    if protection.spare_rows > 0 and not transient:
        row_bits = macro.cols            # bits per row per macro
        p_row = 1.0 - (1.0 - p) ** row_bits
        expected_bad = macro.rows * p_row
        if expected_bad > 0:
            p *= max(0.0, 1.0 - protection.spare_rows / expected_bad)
    return min(1.0, max(0.0, p))


def _stuck_masks(shape: Tuple[int, int], tile_k: int, tile_n: int,
                 rate: float, seed_key: Tuple[int, ...]
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-tile stuck-at draw over an int8 matrix of ``shape``.

    Returns ``(or_mask, and_mask, n_faults)`` uint8 masks: stuck-at-1
    bits set in ``or_mask``, stuck-at-0 bits cleared in ``and_mask``.
    Each MG-sized tile draws from its own SeedSequence stream, so the
    set is independent of traversal order and of the other tiles.
    """
    K, N = shape
    or_mask = np.zeros(shape, dtype=np.uint8)
    and_mask = np.full(shape, 0xFF, dtype=np.uint8)
    n_faults = 0
    for ti in range((K + tile_k - 1) // tile_k):
        for tj in range((N + tile_n - 1) // tile_n):
            kk = min(tile_k, K - ti * tile_k)
            nn = min(tile_n, N - tj * tile_n)
            bits = kk * nn * 8
            rng = _rng(*seed_key, ti, tj)
            cnt = int(rng.binomial(bits, rate))
            if cnt == 0:
                continue
            pos = rng.choice(bits, size=cnt, replace=False)
            val = rng.integers(0, 2, size=cnt, dtype=np.uint8)
            k = ti * tile_k + pos // (nn * 8)
            r = pos % (nn * 8)
            n = tj * tile_n + r // 8
            bit = (r % 8).astype(np.uint8)
            m = (np.uint8(1) << bit).astype(np.uint8)
            one = val.astype(bool)
            np.bitwise_or.at(or_mask, (k[one], n[one]), m[one])
            np.bitwise_and.at(and_mask, (k[~one], n[~one]),
                              np.bitwise_not(m[~one]))
            n_faults += cnt
    return or_mask, and_mask, n_faults


def _apply_masks(w: Any, or_mask: Any, and_mask: Any) -> Any:
    """Stuck-at corruption of an int8 array or tensor (returns a copy);
    a tensor takes uint8 mask tensors on its own device."""
    if isinstance(w, torch.Tensor):
        u = w.to(torch.int8).contiguous().view(torch.uint8)
        return ((u | or_mask) & and_mask).view(torch.int8)
    u = np.ascontiguousarray(w, dtype=np.int8).view(np.uint8)
    return ((u | or_mask) & and_mask).view(np.int8)


@dataclass
class FaultSet:
    """The resolved logical faults of one workload (see module docs)."""

    model: FaultModel
    # gid -> (or_mask, and_mask) uint8, same shape as the weight matrix
    stuck: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    counts: Dict[int, int] = field(default_factory=dict)
    # (gid, device) -> the stuck masks as uint8 tensors on that device,
    # moved there once per set
    _on_device: Dict[Tuple[int, torch.device],
                     Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_stuck(self) -> int:
        return sum(self.counts.values())

    # -- weight-space corruption --------------------------------------------

    def _device_masks(self, gid: int, device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (gid, device)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.from_numpy(m).to(device) for m in self.stuck[gid])
        return self._on_device[key]

    def corrupt_weight_matrix(self, gid: int, w: Any) -> Any:
        """Stuck-at corruption of group ``gid``'s ``(K, N)`` int8 weights,
        a numpy array or a tensor (corrupted on its device)."""
        masks = self.stuck.get(gid)
        if masks is None:
            return w
        if masks[0].shape != tuple(w.shape):
            raise ValueError(
                f"fault set for group {gid} was resolved for shape "
                f"{masks[0].shape}, got weights of shape {tuple(w.shape)}")
        if isinstance(w, torch.Tensor):
            masks = self._device_masks(gid, w.device)
        return _apply_masks(w, *masks)

    def corrupt_weights(self, weights: Dict[int, Any]) -> Dict[int, Any]:
        """Corrupted copy of a ``{gid: (K, N) int8}`` weight dict."""
        return {gid: self.corrupt_weight_matrix(gid, w)
                for gid, w in weights.items()}

    # -- transient accumulator flips ----------------------------------------

    def corrupt_acc(self, acc: Any, gid: int, sample: int) -> Any:
        """Transient bit flips in one MVM's int32 accumulator, a numpy
        array or an ``(M, N)`` tensor (flipped on its device); flip
        positions index the accumulator flattened row-major.

        Keyed by ``(seed, gid, sample)``: re-running the same sample
        reproduces the same flips, and samples/groups are independent.
        """
        if self.model.transient_rate <= 0.0:
            return acc
        rng = _rng(self.model.seed, _NS_TRANSIENT, gid, sample)
        n_words = acc.numel() if isinstance(acc, torch.Tensor) \
            else acc.size
        bits = n_words * 32
        cnt = int(rng.binomial(bits, self.model.transient_rate))
        if cnt == 0:
            return acc
        pos = rng.choice(bits, size=cnt, replace=False)
        if isinstance(acc, torch.Tensor):
            return _flip_words(acc, pos)
        out = np.ascontiguousarray(acc, dtype=np.int32).copy()
        u = out.view(np.uint32).reshape(-1)
        flip = (np.uint32(1) << (pos % 32).astype(np.uint32))
        np.bitwise_xor.at(u, pos // 32, flip)
        return out.reshape(acc.shape)


def _flip_words(acc: torch.Tensor, pos: np.ndarray) -> torch.Tensor:
    """``acc`` (int32) with bit ``pos % 32`` of word ``pos // 32`` of its
    row-major flattening flipped, for each of the distinct ``pos``.

    A word may take several flips.  Its flips are combined on the host
    in int64, where the bits are distinct so their OR is their sum,
    and wrapped to int32 (bit 31 does not fit a positive int32); one
    XOR per word then applies them.
    """
    words, inv = np.unique(pos // 32, return_inverse=True)
    flips = np.zeros(words.size, dtype=np.int64)
    np.add.at(flips, inv, np.left_shift(1, pos % 32, dtype=np.int64))
    flips = flips.astype(np.uint32).view(np.int32)
    out = acc.to(torch.int32).contiguous().clone()
    flat = out.view(-1)
    idx = torch.from_numpy(words).to(acc.device)
    flat[idx] = flat[idx] ^ torch.from_numpy(flips).to(acc.device)
    return out


def resolve_faults(weights: Dict[int, Any], chip: Any,
                   model: FaultModel) -> FaultSet:
    """Resolve a :class:`FaultModel` against a workload's weights
    (numpy arrays or tensors; the masks are drawn on the host).

    Tiles each group's ``(K, N)`` matrix into MG-sized tiles
    (``macro.rows`` x ``group_n_out`` of ``chip``) and draws stuck-at
    faults per tile.  ``model.rate == 0`` resolves to an empty set —
    every downstream hook is then an exact no-op.
    """
    fs = FaultSet(model=model)
    if model.rate <= 0.0:
        return fs
    cim = chip.core.cim
    tile_k, tile_n = cim.macro.rows, cim.group_n_out
    for gid in sorted(weights):
        w = weights[gid]
        if w.ndim != 2:
            raise ValueError(f"group {gid}: weights must be (K, N), "
                             f"got shape {tuple(w.shape)}")
        or_mask, and_mask, cnt = _stuck_masks(
            tuple(w.shape), tile_k, tile_n, model.rate,
            (model.seed, _NS_STUCK, gid))
        if cnt:
            fs.stuck[gid] = (or_mask, and_mask)
            fs.counts[gid] = cnt
    return fs


def corrupt_gmem(image: np.ndarray, model: FaultModel) -> np.ndarray:
    """Single-bit flips in a fraction ``model.gmem_rate`` of the
    image's 32-bit words (returns a corrupted int8 copy)."""
    out = np.ascontiguousarray(image, dtype=np.int8).copy()
    if model.gmem_rate <= 0.0:
        return out
    n_words = out.size // 4
    if n_words == 0:
        return out
    rng = _rng(model.seed, _NS_GMEM)
    cnt = int(rng.binomial(n_words, model.gmem_rate))
    if cnt == 0:
        return out
    widx = rng.choice(n_words, size=cnt, replace=False)
    bit = rng.integers(0, 32, size=cnt).astype(np.uint32)
    u = out[:n_words * 4].view(np.uint32)
    np.bitwise_xor.at(u, widx, np.uint32(1) << bit)
    return out


class PhysicalCimFaults:
    """Stuck-at faults pinned to physical ``(core, macro group)`` arrays.

    The functional ISS calls :meth:`corrupt_loaded` when ``CIM_LOAD``
    latches ``(rows, n_len)`` weights into an array: the top-left
    window of that array's stuck-bit masks corrupts whatever the
    compiler placed there.  Masks are drawn lazily per ``(core, mg)``
    from independent SeedSequence streams and cached, so repeated
    loads into the same array see the same stuck bits — the defining
    property of a stuck-at fault.
    """

    def __init__(self, chip: Any, model: FaultModel) -> None:
        self.chip = chip
        self.model = model
        cim = chip.core.cim
        self._shape = (cim.macro.rows, cim.group_n_out)
        self._masks: Dict[Tuple[int, int],
                          Optional[Tuple[np.ndarray, np.ndarray]]] = {}

    def _masks_for(self, core_id: int, mg: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        key = (core_id, mg)
        if key not in self._masks:
            if self.model.rate <= 0.0:
                self._masks[key] = None
            else:
                or_mask, and_mask, cnt = _stuck_masks(
                    self._shape, self._shape[0], self._shape[1],
                    self.model.rate,
                    (self.model.seed, _NS_PHYSICAL, core_id, mg))
                self._masks[key] = (or_mask, and_mask) if cnt else None
        return self._masks[key]

    def corrupt_loaded(self, core_id: int, mg: int,
                       w: np.ndarray) -> np.ndarray:
        masks = self._masks_for(core_id, mg)
        if masks is None:
            return w
        rows, n_len = w.shape
        return _apply_masks(w, masks[0][:rows, :n_len],
                            masks[1][:rows, :n_len])

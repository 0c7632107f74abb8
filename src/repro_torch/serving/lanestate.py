"""Spec-driven per-lane state ledger for the serving engine.

The engine's device pools — slot KV planes, paged KV pools, recurrent
``(C, n, m)`` / ``(h, c)`` buffers, MoE routing counters — are fixed
allocations; what varies per lane is which slices are *live*. The
``LaneStatePool`` is the host-side authority for that liveness:
admission reserves a lane's declared state kinds
(``LaneStateSpec.state_kinds``) with their extents, streaming feeds
extend the cross reservation, abort/free releases everything, and
``check()`` asserts the ledger is internally consistent.

Reservation units by kind:

* ``self_kv``  — causal-KV token budget (prompt + max_new)
* ``cross_kv`` — cached encoder frames (grows per streamed chunk)
* ``ssm`` / ``mstate`` / ``sstate`` — constant-size recurrent buffers,
  always exactly 1 per declaring layer family (O(1) state is the point)
* ``routing``  — per-lane expert counters (units = n_experts)

``drained`` (no live reservations) is the conformance suite's
end-of-battery invariant: no engine path — EOS, mid-block EOS, abort,
stream finalize — leaks lane state. The allocator is deliberately
family-agnostic: one pool can carry lanes of different specs (the
hypothesis property test drives exactly that mix), while a real engine
reserves every lane with its single model's spec.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.models.model import LaneStateSpec

RECURRENT_KINDS = ("ssm", "mstate", "sstate")


class LaneStatePool:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self._lanes: dict[int, dict] = {}      # slot -> {kind: units}
        self._specs: dict[int, LaneStateSpec] = {}

    # ------------------------------------------------------------- reserve
    def reserve(self, slot: int, spec: LaneStateSpec, *,
                n_tokens: int = 0, enc_frames: int = 0) -> dict:
        """Mark ``slot`` live with every state kind ``spec`` declares.
        ``n_tokens`` is the lane's self-KV token extent (prompt +
        decode budget); ``enc_frames`` the initially cached encoder
        frames. Returns the reservation dict (a copy)."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.n_slots})")
        if slot in self._lanes:
            raise ValueError(f"slot {slot} already reserved")
        if n_tokens < 0 or enc_frames < 0:
            raise ValueError("negative reservation extent")
        r: dict = {}
        if spec.self_kv:
            r["self_kv"] = int(n_tokens)
        if spec.cross_kv:
            r["cross_kv"] = int(enc_frames)
        for kind in spec.recurrent:
            r[kind] = 1
        if spec.moe_experts:
            r["routing"] = int(spec.moe_experts)
        self._lanes[slot] = r
        self._specs[slot] = spec
        return dict(r)

    def extend_cross(self, slot: int, frames: int) -> None:
        """Grow a streaming lane's cached-encoder-frame extent."""
        r = self._lanes[slot]
        if "cross_kv" not in r:
            raise ValueError(f"slot {slot}: lane spec declares no "
                             f"cross-KV state")
        if frames < 0:
            raise ValueError("negative extension")
        r["cross_kv"] += int(frames)

    def release(self, slot: int) -> dict:
        """Free every reservation of ``slot`` (KeyError if not live)."""
        self._specs.pop(slot)
        return self._lanes.pop(slot)

    # ------------------------------------------------------------- queries
    def holds(self, slot: int) -> bool:
        return slot in self._lanes

    def held(self, slot: int) -> Optional[dict]:
        r = self._lanes.get(slot)
        return None if r is None else dict(r)

    def spec_of(self, slot: int) -> Optional[LaneStateSpec]:
        return self._specs.get(slot)

    @property
    def n_live(self) -> int:
        return len(self._lanes)

    @property
    def drained(self) -> bool:
        return not self._lanes

    def totals(self) -> dict:
        """Aggregate live units by kind (all-zero iff drained)."""
        out = {k: 0 for k in ("self_kv", "cross_kv", "routing")
               + RECURRENT_KINDS}
        for r in self._lanes.values():
            for k, v in r.items():
                out[k] += v
        return out

    def report(self) -> dict:
        return {"n_slots": self.n_slots, "live_lanes": self.n_live,
                "totals": self.totals(),
                "lanes": {s: dict(r)
                          for s, r in sorted(self._lanes.items())}}

    def check(self) -> None:
        """Internal-consistency invariants (property-test hook)."""
        assert len(self._lanes) == len(self._specs)
        for slot, r in self._lanes.items():
            spec = self._specs[slot]
            assert 0 <= slot < self.n_slots, slot
            assert set(r) == set(spec.state_kinds), (r, spec)
            for kind in RECURRENT_KINDS:
                if kind in r:
                    assert r[kind] == 1, (slot, kind, r[kind])
            if "routing" in r:
                assert r["routing"] == spec.moe_experts
            assert all(v >= 0 for v in r.values()), (slot, r)

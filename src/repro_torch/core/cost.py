"""Monetary cost accounting (paper Fig 8 d-f).

A copy of the whole of ``repro/core/cost.py`` (host-only).

The paper's cost waste model: resources in every cloud stay allocated for
the whole job makespan, so a cloud that finishes its local work early burns
``units × rate × waiting_time``.  Elastic scheduling trims allocations so
waiting (and hence cost) shrinks while the makespan stays put (it is set by
the straggler either way).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Mapping, Optional, Sequence

from repro_torch.core.sync import CODEC_TIERS, SyncConfig
from repro_torch.core.wan import SimResult


@dataclass(frozen=True)
class CostReport:
    total_cost: float
    waiting_cost: float            # cost attributable to straggler waiting
    cost_by_region: Dict[str, float]
    wait_fraction_by_region: Dict[str, float]
    traffic_mb: float = 0.0        # bytes-on-wire across all regions (WAN
    #   egress is already billed into per-region cost by the simulator when
    #   WANConfig.traffic_cost_per_gb is set; this is the volume itself)

    def reduction_vs(self, baseline: "CostReport") -> float:
        return 1.0 - self.total_cost / baseline.total_cost

    def waiting_reduction_vs(self, baseline: "CostReport") -> float:
        if baseline.waiting_cost == 0:
            return 0.0
        return 1.0 - self.waiting_cost / baseline.waiting_cost

    def traffic_reduction_vs(self, baseline: "CostReport") -> float:
        """Bytes-on-wire reduction — how the fused WAN codec shows up in the
        elasticity cost model (``SyncConfig.payload_mb`` drives both)."""
        if baseline.traffic_mb == 0:
            return 0.0
        return 1.0 - self.traffic_mb / baseline.traffic_mb


def tier_payload_table(model_mb: float, frac: float,
                       codec_block: int = 4096, interval: int = 8
                       ) -> Dict[str, Dict[str, float]]:
    """Per-sync payload for every codec tier at one (frac, block) point —
    the precision-ladder price list the adaptive controller walks and the
    ``BENCH_wan_codec.json`` bytes-on-wire rows report.

    ``fp32`` here is the sparse fp32 path (value+int32-index pairs, codec
    off); ``dense`` is the uncompressed reference.  Egress per tier is the
    per-step average at the given sync ``interval``."""
    rows: Dict[str, Dict[str, float]] = {
        "dense": {"payload_mb": model_mb,
                  "per_step_mb": model_mb / interval}}
    base = SyncConfig("asgd_ga", interval, compress_topk=frac,
                      codec_block=codec_block)
    rows["fp32"] = {"payload_mb": base.payload_mb(model_mb)}
    for dtype in CODEC_TIERS[1:]:
        cfg = replace(base, quantize_int8=True, value_dtype=dtype)
        rows[dtype] = {"payload_mb": cfg.payload_mb(model_mb)}
    for name, row in rows.items():
        row["per_step_mb"] = row["payload_mb"] / interval
        row["reduction_vs_dense"] = model_mb / row["payload_mb"]
        for k in row:
            row[k] = round(row[k], 4)
    return rows


def bucket_payload_table(cfg: SyncConfig, bucket_mb: Mapping[str, float],
                         wan_legs: Optional[int] = None
                         ) -> Dict[str, Dict[str, float]]:
    """Per-bucket traffic table for a layer-class config: each bucket
    group's model bytes, effective (top-k, tier) knobs, per-sync payload
    and reduction vs its dense share — the per-bucket price list the
    :class:`~repro_torch.core.autotune.BucketedSyncController` walks, and what
    the bench reports next to its decisions.  A ``total`` row sums the
    groups (equals ``cfg.payload_mb(model_mb, bucket_weights=...)``).

    ``wan_legs`` — payload-sized WAN transfers per sync round under the
    live aggregation schedule (``AggregationSchedule.wan_transfers``; the
    flat ring's value is ``n_pods``) — adds a ``wire_mb`` column per row:
    what one sync round actually puts on the WAN, not just what one pod
    encodes."""
    rows: Dict[str, Dict[str, float]] = {}
    total_mb = sum(bucket_mb.values())
    total_payload = 0.0
    for name in cfg.bucket_names:
        mb = float(bucket_mb.get(name, 0.0))
        eff = cfg.for_bucket(name)
        payload = eff.payload_mb(mb)
        total_payload += payload
        rows[name] = {
            "model_mb": round(mb, 4),
            "compress_topk": eff.compress_topk,
            "tier": CODEC_TIERS[eff.tier],
            # the per-bucket block override changes the wire bytes (one
            # fp32 scale per block — the 1/block payload term), so the
            # price list shows it next to the payload it produced
            "codec_block": eff.codec_block,
            "payload_mb": round(payload, 6),
            "reduction_vs_dense": round(mb / payload, 2) if payload else 0.0,
        }
    rows["total"] = {
        "model_mb": round(total_mb, 4),
        "payload_mb": round(total_payload, 6),
        "reduction_vs_dense": (round(total_mb / total_payload, 2)
                               if total_payload else 0.0),
    }
    if wan_legs is not None:
        for row in rows.values():
            row["wire_mb"] = round(row["payload_mb"] * wan_legs, 6)
    return rows


def adaptive_traffic_mb(decisions: Sequence, n_syncs_per_decision: Sequence[int],
                        model_mb: float, n_pods: int = 1,
                        bucket_weights: Optional[Mapping[str, float]] = None,
                        wan_legs: Optional[int] = None) -> float:
    """Bytes-on-wire of an adaptive run: each controller decision's config
    billed for the sync rounds it was live (``SyncPlanUpdate.sync`` carries
    the payload math; the launcher's traffic accounting uses the same
    ``payload_mb`` per active config, so simulator and emulation agree).
    Pass ``bucket_weights`` for a multi-bucket decision stream — each
    decision's per-bucket overrides are then billed at their own tier.

    The per-round multiplier is the number of payload-sized WAN transfers
    one sync round makes.  The historical default, ``n_pods``, is exact
    for the flat ring only (every pod ships to one peer).  Under a
    hierarchical schedule pass ``wan_legs``
    (``AggregationSchedule.wan_transfers`` / the transport's
    ``wan_transfers_per_round``): a tree over R regions makes ``2(R-1)``
    transfers, not ``n_pods``, and auxiliary routes pay two hops — the
    same count the DES bills (exact-accounting-tested against
    ``wan.simulate``)."""
    legs = wan_legs if wan_legs is not None else n_pods
    total = 0.0
    for update, n in zip(decisions, n_syncs_per_decision):
        total += update.sync.payload_mb(
            model_mb, bucket_weights=bucket_weights) * n * legs
    return total


def cost_report(result: SimResult, units: Dict[str, int],
                rates: Dict[str, float]) -> CostReport:
    by_region, wait_frac, waiting = {}, {}, 0.0
    for c in result.clouds:
        by_region[c.region] = c.cost
        wait_frac[c.region] = c.wait_fraction
        waiting += units[c.region] * rates[c.region] * c.wait_s / 3600.0
    return CostReport(
        total_cost=result.total_cost,
        waiting_cost=waiting,
        cost_by_region=by_region,
        wait_fraction_by_region=wait_frac,
        traffic_mb=result.total_traffic_mb,
    )

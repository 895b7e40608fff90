"""The paper's control-plane figures through the PyTorch port.

Reruns ``bench_scheduling`` (Fig 8 / Table IV: elastic scheduling against
the greedy baseline, waiting-time and cost reduction) and ``bench_sync``
(Fig 10: each sync strategy's speedup and communication-time reduction
over per-step async SGD at frequencies 4 and 8) of
``benchmarks/paper_repro.py`` with ``repro_torch``'s scheduler
(Algorithm 1), WAN simulator and cost model, on the paper's own inputs:
Table I device quantifications, Table III gradient sizes, a 100 Mbps WAN.
Host-only (no device, no JAX); the numbers must equal the reference's,
which ``tests/test_torch_wan.py`` holds.

Run:  PYTHONPATH=src python tools/torch_paper_control.py
"""
from __future__ import annotations

import json
from typing import Dict

from repro_torch.core.cost import cost_report
from repro_torch.core.scheduler import (CATALOG, CloudResources,
                                        optimal_matching)
from repro_torch.core.sync import SyncConfig
from repro_torch.core.wan import (SimCloud, WANConfig, compare_strategies,
                                  simulate)
from repro_torch.models.reference import PAPER_MODELS

# the reference's calibration (benchmarks/paper_repro.py): per-iteration
# compute seconds of the paper's eval models and its WAN
ITER_S = {"lenet": 0.54, "resnet": 0.70, "deepfm": 0.56}
WAN = WANConfig(bandwidth_mbps=100.0, latency_s=0.05, fluctuation=0.25,
                overlap=0.55, seed=0)

SCHED_CASES = [
    # (id, data ratio SH:CQ, device types)
    (1, (1.0, 1.0), ("cascade", "sky")),
    (2, (2.0, 1.0), ("cascade", "cascade")),
    (3, (2.0, 1.0), ("cascade", "sky")),
]


def bench_scheduling(model: str = "resnet", n_iters: int = 300) -> Dict:
    """Fig 8: elastic scheduling vs the greedy baseline in the paper's
    three cases; the makespan stays pinned by the straggler."""
    grad_mb = PAPER_MODELS[model]["grad_mb"]
    out = {}
    for cid, ratio, devs in SCHED_CASES:
        clouds = [CloudResources("sh", ((devs[0], 6),), data_size=ratio[0]),
                  CloudResources("cq", ((devs[1], 6),), data_size=ratio[1])]
        plans = optimal_matching(clouds)

        def sim(alloc_units):
            # iteration time scales inversely with allocated power and
            # proportionally with the local shard size
            sims = []
            for c, units in zip(clouds, alloc_units):
                dev = c.devices[0][0]
                power = units * CATALOG[dev].power()
                t = ITER_S[model] * (c.data_size / (ratio[0] + ratio[1])) \
                    / (power / (6 * CATALOG["cascade"].power()))
                sims.append(SimCloud(c.region, iter_time_s=t, units=2 * units))
            return simulate(sims, SyncConfig("asgd", 1), n_iters=n_iters,
                            model_mb=grad_mb, wan=WAN)

        base = sim([6, 6])
        plan_units = [dict(p.allocation).get(d, 0)
                      for p, d in zip(plans, devs)]
        elastic = sim(plan_units)
        rates = {"sh": 1.0, "cq": 1.0}
        rb = cost_report(base, {"sh": 12, "cq": 12}, rates)
        re = cost_report(elastic, {"sh": 2 * plan_units[0],
                                   "cq": 2 * plan_units[1]}, rates)
        wait_b = sum(c.wait_s for c in base.clouds)
        wait_e = sum(c.wait_s for c in elastic.clouds)
        out[f"case{cid}"] = {
            "plan_cores": {p.region: 2 * u for p, u in zip(plans, plan_units)},
            "wait_reduction": round(1 - wait_e / max(wait_b, 1e-9), 3),
            "cost_reduction": round(re.reduction_vs(rb), 3),
            "makespan_ratio": round(elastic.makespan_s / base.makespan_s, 3),
        }
    return out


def bench_sync(n_iters: int = 400) -> Dict:
    """Fig 10: speedup and communication-time reduction of every strategy
    against the per-step async-SGD baseline at frequencies 4 and 8."""
    out = {}
    for model in ("lenet", "resnet", "deepfm"):
        grad_mb = PAPER_MODELS[model]["grad_mb"]
        clouds = [SimCloud("sh", iter_time_s=ITER_S[model] * 1.2, units=12),
                  SimCloud("cq", iter_time_s=ITER_S[model], units=12)]
        res = compare_strategies(clouds, n_iters=n_iters, model_mb=grad_mb,
                                 intervals=(4, 8), wan=WAN)
        base = res["asgd"]
        out[model] = {
            key: {"speedup": round(base.makespan_s / r.makespan_s, 3),
                  "comm_reduction": round(
                      1 - r.clouds[0].comm_s / base.clouds[0].comm_s, 3),
                  "traffic_mb": round(r.total_traffic_mb, 1)}
            for key, r in res.items()}
    return out


def main() -> Dict:
    sched, sync = bench_scheduling(), bench_sync()
    cost = [v["cost_reduction"] for v in sched.values()]
    wait = [v["wait_reduction"] for v in sched.values()]
    print(f"[fig8] elastic scheduling: cost reduction "
          f"{min(cost):.1%}-{max(cost):.1%}, waiting-time reduction "
          f"{min(wait):.1%}-{max(wait):.1%} over {len(sched)} cases")
    for model, rows in sync.items():
        print(f"[fig10] {model}: speedup at frequency 8 "
              f"asgd_ga {rows['asgd_ga@8']['speedup']}x, ama "
              f"{rows['ama@8']['speedup']}x, sma {rows['sma@8']['speedup']}x")
    out = {"bench_scheduling": sched, "bench_sync": sync}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Serving launcher of the port: geo-routed continuous batching over replica
slot pools.

Counterpart of ``repro/launch/serve.py``, with its flags and defaults: one
slot-pool engine per regional replica (all replicas share the parameters),
a :class:`~repro_torch.serving.router.GeoRouter` that places each request by
measured link beliefs and catalog cost/latency, and, with ``--autoscale``,
a :class:`~repro_torch.core.control_plane.ServingElasticityController` that
sizes the replica count from the offered load before the engines are built.
``--device`` picks the card (default) or the CPU; on the card, each prefill
runs the CUDA flash-attention kernel in every attention layer when the
config says ``attention_impl="pallas"``.

Example::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --scheduler continuous --slots 4 --prompt-len 32 --new-tokens 16 \\
      --replicas 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.control_plane import (CloudEvent,
                                            ServingElasticityController)
from repro_torch.models.registry import get_model_fns
from repro_torch.serving.engine import (BatchScheduler, ContinuousEngine,
                                        ContinuousScheduler, ServingEngine)
from repro_torch.serving.router import ROUTER_MODES, GeoRouter, ReplicaSpec

# replica regions are assigned from this palette in order
REGIONS = ("us-east", "eu-west", "ap-south", "us-west", "eu-north",
           "ap-north", "sa-east", "af-south")


def route_and_submit(router: GeoRouter, scheds: Mapping, regions: Sequence,
                     n_requests: int, prompt_len: int, new_tokens: int,
                     vocab_size: int, seed: int = 0
                     ) -> Dict[int, Tuple[str, int, np.ndarray]]:
    """Draw ``n_requests`` prompts as the reference launcher does (lengths
    uniform in ``[prompt_len // 2, prompt_len]``, tokens and client region
    from one numpy generator), route each and submit it to its replica.
    Returns global rid -> (region, local rid, prompt)."""
    rng = np.random.default_rng(seed)
    placed = {}
    for rid in range(n_requests):
        plen = int(rng.integers(prompt_len // 2, prompt_len + 1))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        src = regions[int(rng.integers(len(regions)))]
        region = router.route(rid, src, plen, new_tokens)
        placed[rid] = (region, scheds[region].submit(prompt, new_tokens),
                       prompt)
    return placed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--scheduler", default="continuous",
                    choices=["batch", "continuous"],
                    help="'continuous': slot-pool engine with per-slot "
                         "insert/evict (prefill->insert->generate); "
                         "'batch': run-to-completion baseline")
    ap.add_argument("--slots", type=int, default=4,
                    help="slot-pool width per replica (continuous)")
    ap.add_argument("--batch", type=int, default=4,
                    help="group size for the run-to-completion baseline "
                         "(--scheduler batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--router", default="balanced", choices=ROUTER_MODES,
                    help="placement objective: 'nearest', 'cheapest' or "
                         "'balanced' (network + queue + compute seconds)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="regional replicas serving the same parameters "
                         "(with --autoscale: the replica-count ceiling)")
    ap.add_argument("--autoscale", action="store_true",
                    help="size the replica count from the offered load "
                         "via the ServingElasticityController")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    fns = get_model_fns(arch.module)
    params = fns.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device)
    cache_len = args.prompt_len + args.new_tokens

    # ------------------------------------------------- replica scaling
    n_replicas, autoscale_reason = args.replicas, None
    if args.autoscale:
        ctrl = ServingElasticityController(
            replicas=1, max_replicas=max(1, args.replicas))
        # offered load: the whole request burst over one observation window
        d = ctrl.handle(CloudEvent("load_changed", time_s=0.0,
                                   rps=args.requests / 10.0))
        n_replicas, autoscale_reason = ctrl.replicas, d.reason
    regions = REGIONS[:n_replicas]

    router = GeoRouter([ReplicaSpec(region=r, n_slots=args.slots)
                        for r in regions], mode=args.router)
    if args.scheduler == "continuous":
        scheds = {r: ContinuousScheduler(ContinuousEngine(
            arch, params, n_slots=args.slots, cache_len=cache_len,
            use_smoke=args.smoke)) for r in regions}
    else:
        scheds = {r: BatchScheduler(
            ServingEngine(arch, params, cache_len=cache_len,
                          use_smoke=args.smoke),
            batch_size=args.batch) for r in regions}

    # ------------------------------------------------- route + submit
    placed = route_and_submit(router, scheds, regions, args.requests,
                              args.prompt_len, args.new_tokens,
                              cfg.vocab_size)

    t0 = time.time()
    by_region = {r: s.run() for r, s in scheds.items()}
    dt = time.time() - t0
    results = {}
    for rid, (region, local, _) in placed.items():
        results[rid] = by_region[region][local]
        router.complete(rid)

    total_new = sum(len(v) for v in results.values())
    print(json.dumps({
        "arch": args.arch, "scheduler": args.scheduler,
        "router": args.router, "replicas": list(regions),
        "autoscale": autoscale_reason,
        "requests": len(results), "new_tokens": total_new,
        "routes": {r: sum(1 for p in placed.values() if p[0] == r)
                   for r in regions},
        "wall_s": round(dt, 2),
        "tok_per_s": round(total_new / dt, 1),
        "device": str(device),
    }, indent=1))
    for rid, toks in sorted(results.items())[:3]:
        print(f"req {rid}: {np.asarray(toks)[:12].tolist()} ...")
    return results


if __name__ == "__main__":
    main()

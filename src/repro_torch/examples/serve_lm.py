"""Serving demo: batched decode with continuous batching (slot refill).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch stablelm-1.6b] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.examples import add_device_flag, resolve_device, sync
from repro_torch.models import get_family
from repro_torch.serve import Request, ServeEngine

MAX_LEN = 256


def _requests(n: int, new_tokens: int) -> list[Request]:
    return [Request(rid=i, prompt=[1 + (i * 7) % 100, 2, 3, 4], max_new_tokens=new_tokens)
            for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    fam = get_family(cfg)
    params = fam.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)

    # the warm call: one short request through an engine of its own, so
    # that a first kernel build and launch stay out of the timed run
    warm = ServeEngine(cfg, params, slots=args.slots, max_len=MAX_LEN, device=dev)
    warm.submit(_requests(1, 2)[0])
    warm.run_until_drained()
    del warm

    engine = ServeEngine(cfg, params, slots=args.slots, max_len=MAX_LEN, device=dev)
    reqs = _requests(args.requests, args.new_tokens)
    for r in reqs:
        engine.submit(r)

    sync(dev)
    t0 = time.perf_counter()
    ticks = engine.run_until_drained()
    sync(dev)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    done = sum(r.done for r in reqs)
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"served {done}/{len(reqs)} requests, {total_tokens} tokens, "
          f"{ticks} engine ticks, {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {where})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={r.prompt} -> {r.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

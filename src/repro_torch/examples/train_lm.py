"""End-to-end training run: a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--arch stablelm-1.6b]

Builds a ~100M-param variant of the chosen family (width-reduced from the
assigned config), streams the deterministic synthetic corpus, checkpoints
periodically and survives a --simulate-crash restart.  The checkpoints go
to /tmp/repro_torch_train_lm by default (not the JAX script's directory,
whose checkpoints a restart would otherwise read).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.examples import add_device_flag, resolve_device
from repro_torch.models import ModelConfig, get_family
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, TrainLoop, run_with_restarts

CKPT_DIR = "/tmp/repro_torch_train_lm"


def make_100m(arch: str) -> ModelConfig:
    """~100M-parameter member of the assigned family."""
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-100m",
        n_layers=8,
        d_model=768,
        n_heads=12,
        n_kv_heads=min(cfg.n_kv_heads, 12),
        d_ff=2048,
        vocab=32_768,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        attn_every=2 if cfg.family == "hybrid" else 0,
        compute_dtype="float32",
        remat="none",
        rwkv_head_dim=64,
        ssm_head_dim=64,
        moe_group=256,
    )


def run(device=None, cfg: ModelConfig | None = None, steps: int = 300, batch: int = 8,
        seq: int = 256, ckpt_dir: str = CKPT_DIR, simulate_crash: bool = False) -> dict:
    """Train ``cfg`` (default: the ~100M stablelm) for ``steps`` steps;
    returns the loop's result with its ``restarts``."""
    dev = resolve_device(device)
    cfg = cfg or make_100m("stablelm-1.6b")
    fam = get_family(cfg)
    model = fam.init(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    tc = TrainConfig(
        steps=steps,
        checkpoint_every=max(steps // 5, 25),
        checkpoint_dir=ckpt_dir,
        log_every=max(steps // 20, 5),
    )
    oc = AdamWConfig(lr=1e-3, warmup_steps=steps // 10, total_steps=steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, noise=0.05)

    fault = None
    if simulate_crash:
        fired = {"n": 0}

        def fault(step):
            if step == steps // 2 and fired["n"] == 0:
                fired["n"] += 1
                raise RuntimeError("simulated node failure")

    out, restarts = run_with_restarts(
        lambda: TrainLoop(cfg, oc, tc, dc, fault_hook=fault, device=dev)
    )
    for row in out["log"]:
        mark = " straggler!" if row["straggler"] else ""
        print(
            f"step {row['step']:5d}  loss {row['loss']:.4f}  "
            f"lr {row['lr']:.2e}  {row['step_time_s']*1e3:7.1f} ms{mark}"
        )
    print(f"final loss: {out['final_loss']:.4f}  restarts: {restarts}")
    return {**out, "restarts": restarts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--simulate-crash", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    run(args.device, make_100m(args.arch), args.steps, args.batch, args.seq, args.ckpt_dir,
        args.simulate_crash)
    return 0


if __name__ == "__main__":
    sys.exit(main())

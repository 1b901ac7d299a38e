"""Training launcher: the reference's ``repro.launch.train`` on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 50 --ckpt ckpt_dir [--device cpu]

Trains the reduced config (``smoke_config``) on the card by default, on
the CPU with ``--device cpu``; asserts that the loss went down.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import smoke_config
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    out = train(cfg, dcfg, TrainConfig(steps=args.steps, lr=args.lr,
                                       ckpt_dir=args.ckpt,
                                       device=args.device))
    losses = out["losses"]
    print(f"steps={len(losses)} first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} events={out['events']}")
    assert losses[-1] < losses[0], "training did not reduce loss"


if __name__ == "__main__":
    main()

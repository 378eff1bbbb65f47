"""End-to-end training driver: a ~15M-param SmolLM-family model for a
few hundred steps on the synthetic pipeline, with checkpointing and
the fault-tolerant training loop.

(The full 135M config trains the same way; the reduced width keeps a
300-step run short on the CPU.  Pass --full to use the real config.)

Run:  python -m repro_torch.examples.e2e_train [--steps 300] [--full]
      [--device cpu]
(with PYTHONPATH=src from the repository root)
"""

import argparse
import tempfile
from dataclasses import replace

import torch

from repro_torch import configs
from repro_torch.data.synthetic import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")

    cfg = configs.get_config("smollm-135m")
    if not args.full:
        # ~15M params: same family, 8 layers x 256 wide
        cfg = replace(cfg.reduced(), n_layers=8, d_model=256, n_heads=8,
                      n_kv_heads=4, head_dim=32, d_ff=1024, vocab=8192)
    dc = DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8)
    with tempfile.TemporaryDirectory() as ckdir:
        tr = Trainer(
            cfg,
            adamw.AdamWConfig(lr=1e-3, warmup_steps=30),
            TrainerConfig(steps=args.steps, ckpt_every=100,
                          ckpt_dir=ckdir, log_every=20),
            dc, device=dev)
        state = tr.run()
    n = len(state.losses)
    print(f"\ntrained {n} steps on {dev.type}: loss {state.losses[0]:.3f} "
          f"-> {min(state.losses[-10:]):.3f}")
    assert state.losses[-1] < state.losses[0]


if __name__ == "__main__":
    main()

"""Training launcher CLI, the port of `repro/launch/train.py`.

  python -m repro_torch.launch.train --arch smollm-135m --steps 100 \
      --batch 8 --seq 128 [--reduced] [--ckpt-dir DIR] [--device cpu]

Runs on the card unless `--device cpu` asks for the CPU.  Without
--reduced it trains the published config.  The trainer resumes from the
latest checkpoint in --ckpt-dir; without one it writes its checkpoints
to a fresh temporary directory, removed at exit.  --crash-at STEP
raises a simulated node failure once at STEP (the trainer restores its
latest checkpoint and goes on); --deterministic turns on PyTorch's
deterministic algorithms (on the card the embedding's backward
accumulates in a nondeterministic order otherwise), so that two runs
end with the same bits.  It prints the final parameters' sha256.
--mesh runs the trainer under a mesh over the process's devices
(`models/sharding.py:use_mesh`), JAX's host-device mesh: on the CPU
`make_host_mesh(1)`, on the card `make_device_mesh()`.  The port runs
one device a process, so a mesh of more than one device raises; the
multi-process path is `train/ddp_shardmap.py`, one process a rank.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt as CK
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch.mesh import make_device_mesh, make_host_mesh
from repro_torch.models.sharding import use_mesh
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and write checkpoints here "
                         "(default: a temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject one node failure at this step")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic algorithms (bit-reproducible)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", action="store_true",
                    help="run under a mesh over the process's devices")
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    mesh = None
    if args.mesh:
        mesh = make_host_mesh(1) if args.device.type == "cpu" \
            else make_device_mesh()
        if mesh.size > 1:
            ap.error(f"--mesh over {mesh.size} devices in one process: "
                     "the port trains on one device a process; train "
                     "over several with repro_torch/train/ddp_shardmap.py, "
                     "one process a rank")
        args.device = mesh.devices[0]
    if args.deterministic:
        # cuBLAS reads this when it makes its first handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    oc = adamw.AdamWConfig(lr=args.lr,
                           warmup_steps=max(args.steps // 10, 1))
    crashed = []

    def fault(step):
        if step == args.crash_at and not crashed:
            crashed.append(step)
            raise RuntimeError(f"injected node failure at step {step}")

    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir or tmp,
                           microbatches=args.microbatches)
        with use_mesh(mesh):
            tr = Trainer(cfg, oc, tc, dc, fault_hook=fault,
                         device=args.device)
            state = tr.run()
    print(f"final loss {state.losses[-1]:.4f} "
          f"(start {state.losses[0]:.4f}); restarts={state.restarts}; "
          f"stragglers={len(state.straggler_events)}")
    print(f"params sha256 {CK.digest(dict(tr.model.named_parameters()))} "
          f"on {args.device.type}")


if __name__ == "__main__":
    main()

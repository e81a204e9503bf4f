"""End-to-end LM training driver with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --reduced --device cpu --steps 40                       # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --reduced --steps 200 --ckpt-dir build/run1             # on the card

Port of ``repro/launch/train.py``, with the same flags and output lines,
plus ``--device`` (default: the card) and ``--attention-impl`` (default
``cuda``: the flash kernel on the card, its plain version on the CPU):

  * auto-resume: restores the newest valid checkpoint under ``--ckpt-dir``
    (the port's store, the reference's format) and continues from its step;
  * stateless-seeded data: batch(step) is a pure function
    (``data/pipeline.py``), so a resumed run's losses equal an
    uninterrupted run's bit for bit;
  * at most ``--ckpt-every`` steps of work are lost to a failure.

Weights are random, drawn from ``--seed`` on the target device in the
config's param dtype (f32).  Over 30 steps or more the run must lower the
loss (the mean of the last five against the first), as the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import training
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import DataConfig, device_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.models.params import tree_size
from repro_torch.optim import adamw


def main(argv=None):
    """Train; returns the losses of the steps this call ran."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--reduced", action="store_true", help="tiny config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--attention-impl", default="cuda", choices=("cuda", "chunked", "reference"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(
        learning_rate=args.lr, warmup_steps=20, total_steps=args.steps
    )
    data_cfg = DataConfig(seed=args.seed, batch=args.batch, seq_len=args.seq)

    state = training.init_train_state(model, args.seed, dev)
    n_params = tree_size(state.params)
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M reduced={args.reduced} device={dev}")

    start_step = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start_step, state = restore(args.ckpt_dir, state)
        print(f"resumed from checkpoint step {start_step}")

    step_fn = training.make_train_step(model, opt_cfg)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = device_batch(data_cfg, cfg, step, dev)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"ce {float(metrics['ce']):.4f} gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time()-t0)/max(step-start_step+1,1):.2f}s/step)"
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(args.ckpt_dir, step + 1, state)
            print(f"checkpointed step {step+1}")

    if args.ckpt_dir:
        save(args.ckpt_dir, args.steps, state)
    if not losses:
        return losses
    first, last = losses[0], np.mean(losses[-5:])
    print(f"loss {first:.4f} → {last:.4f} over {len(losses)} steps")
    if len(losses) >= 30 and not last < first:
        raise AssertionError("training did not reduce the loss")
    return losses


if __name__ == "__main__":
    main()

"""LM decode serving driver: prefill a batch of prompts, then decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --no-reduced --batch 4 --prompt-len 128 --gen 64          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu  # reduced rwkv6

Port of ``repro/launch/serve.py``: prompts from a numpy seed, the prompt
prefilled token by token into the decode cache through ``decode_step``, then
greedy decoding, the printed rates and the finite-logits check.  Every
config of ``configs/archs.py`` serves.  As in the reference, the loop feeds
tokens only: a VLM's decode cache holds no patch K/V and an
encoder–decoder's ``cross_kv`` stays zero (ROADMAP §3).  It adds
``--device`` (default: the card) and makes ``--reduced`` switchable
(``--no-reduced`` for the published config); the reference's flag is
``store_true`` with ``default=True``, so its full configs are unreachable
from the command line (ROADMAP §3).

Weights are random, drawn from ``--seed`` on the target device and held in
the compute dtype, except the leaves the reference reads in f32
(``Model.init``): the reference casts its f32 weights to the compute dtype
at every use, and one cast up front gives the same values.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> Dict[str, Any]:
    """Run the demo; returns the model, parameters, prompt, tokens, logits
    and timings for callers that check them."""
    ap = argparse.ArgumentParser(
        description="LM decode serving demo: batched greedy decode through "
        "decode_step, on the card unless --device cpu.")
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, device=dev, dtype=model.compute_dtype)

    max_seq = args.prompt_len + args.gen
    cache = model.init_cache(args.batch, max_seq, dev)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)

    step = torch.no_grad()(model.decode_step)

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for i in range(args.prompt_len):
        logits, cache = step(params, cache, prompt[:, i : i + 1], i)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prompt_logits = logits

    generated = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for i in range(args.prompt_len, max_seq):
        generated.append(tok[:, 0].cpu().numpy())
        logits, cache = step(params, cache, tok, i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_tokens = np.stack(generated, axis=1)
    tps = args.batch * args.gen / t_decode
    print(f"{cfg.name} on {dev}: prefill {args.prompt_len} tok in {t_prefill:.2f}s, "
          f"decoded {args.gen} tok/seq in {t_decode:.2f}s ({tps:.1f} tok/s)")
    print("sample generations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {gen_tokens[b][:16].tolist()}")
    assert bool(torch.isfinite(logits).all())
    print("serving OK")
    return dict(config=cfg, model=model, params=params, prompt=prompt,
                prompt_logits=prompt_logits, logits=logits, generated=gen_tokens,
                prefill_s=t_prefill, decode_s=t_decode, tokens_per_s=tps)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Hold two checkouts' force kernels to each other, bit for bit, on one
NVIDIA GPU.

    python3 chip_smoke.py --save-force-inputs inputs.pt
    python3 scripts/force_kernel_bits.py run --inputs inputs.pt --tree DIR --out a.pt
    python3 scripts/force_kernel_bits.py compare a.pt b.pt

``run`` imports ``repro_torch`` from the checkout at ``--tree`` (its kernels
are built there, from its own sources), calls its ``cell_list_force_cuda``,
``cell_window_force_cuda`` and ``pairwise_force_cuda`` on the saved inputs
of ``chip_smoke.py``'s kernels phases (the soma path's cell list, the
spheroid's sorted pool at its window, cell_list_force on the spheroid's cell
list, and every 8th row of the spheroid's dense candidates) and saves the
outputs, and prints each call's mean CUDA-event time over 20 calls after
a warm-up (``ms``; time two checkouts in one machine, in turns).
``run --plain`` also runs that checkout's plain PyTorch versions of the
three kernels on the same inputs (in chunks, as chip_smoke.py calls them;
saved as ``plain:<name>``, not timed).  ``compare`` prints one JSON line:
for each kernel (and plain version), whether the two outputs are equal bit
for bit, how many values differ, by how much at most, and the largest
magnitude of the first output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def plain(name: str, call: dict) -> torch.Tensor:
    """The plain version of the kernel that ``name``'s saved call ran."""
    from repro_torch.kernels.cell_force.ref import cell_list_force_ref, cell_window_force_ref
    from repro_torch.kernels.pairwise_force.ref import pairwise_force_ref

    if name == "pairwise_force":
        pos, rad, cand, mask = call["args"]
        step = 8192
        return torch.cat([pairwise_force_ref(
            pos[i:i + step], rad[i:i + step], cand[i:i + step], mask[i:i + step],
            all_position=call["all_position"], all_radius=call["all_radius"])
            for i in range(0, pos.shape[0], step)])
    *tensors, dims = call["args"]
    if name.startswith("cell_list_force"):
        n_cells, m = tensors[2].shape
        chunk = max(1, int(1e8 // (27 * m * m)))
        return sum(cell_list_force_ref(*tensors, dims, num_out=call["num_out"],
                                       cells=(lo, min(lo + chunk, n_cells)))
                   for lo in range(0, n_cells, chunk))
    block, window = call["block"], call["half_window"]
    nbw = -(-tensors[0].shape[0] // block)
    return sum(cell_window_force_ref(*tensors, dims, block=block, half_window=window,
                                     tiles=(t, min(t + 64, nbw)))
               for t in range(0, nbw, 64))


def run(inputs: str, tree: str, out: str, with_plain: bool = False) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels.cell_force import kernel as cf_k
    from repro_torch.kernels.pairwise_force import kernel as pf_k

    saved = torch.load(inputs, map_location="cuda:0")
    got, ms = {}, {}
    for name, call in saved.items():
        if name == "pairwise_force":
            fn = lambda call=call: pf_k.pairwise_force_cuda(
                *call["args"], all_position=call["all_position"],
                all_radius=call["all_radius"])
        elif name.startswith("cell_list_force"):
            *tensors, dims = call["args"]
            fn = lambda t=tensors, d=dims, call=call: cf_k.cell_list_force_cuda(
                *t, d, num_out=call["num_out"])
        else:
            *tensors, dims = call["args"]
            fn = lambda t=tensors, d=dims, call=call: cf_k.cell_window_force_cuda(
                *t, d, block=call["block"], half_window=call["half_window"])
        got[name] = fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        ms[name] = start.elapsed_time(end) / 20
    if with_plain:
        for name, call in saved.items():
            got[f"plain:{name}"] = plain(name, call)
    torch.save({k: v.cpu() for k, v in got.items()}, out)
    print(json.dumps({"tree": tree, "saved": out, "kernels": sorted(got), "ms": ms,
                      "module": cf_k.__file__}))


def compare(a: str, b: str) -> None:
    x, y = torch.load(a), torch.load(b)
    result = {}
    for name in sorted(x):
        diff = (x[name] != y[name])
        result[name] = dict(bit_identical=bool(torch.equal(x[name], y[name])),
                            values=x[name].numel(), differing=int(diff.sum()),
                            max_abs_diff=float((x[name] - y[name]).abs().max()),
                            max_abs=float(x[name].abs().max()))
    print(json.dumps(result))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--inputs", required=True)
    r.add_argument("--tree", required=True, help="root of the checkout whose kernels run")
    r.add_argument("--out", required=True)
    r.add_argument("--plain", action="store_true",
                   help="also run the checkout's plain versions on the inputs")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "run":
        if not torch.cuda.is_available():
            print("force_kernel_bits: no CUDA device is available", file=sys.stderr)
            return 1
        run(args.inputs, args.tree, args.out, with_plain=args.plain)
    else:
        compare(args.a, args.b)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probes of kernel 1's warp route on one CUDA card.

    python3 tools/probe_warp_route.py [--seed N] [--sass DIR]

1. Occupancy: the warp route at LocalLDA's K = 50 shape (U = 128, A = 56,
   M = 1) with every position of every document live, at D = 132 (one
   document per SM) up to 4,635; ns per step (device time over the 128
   steps of each document) and ns per document-step (device time over
   D × 128 steps).  At D = 132 a step takes its chain's latency; where it
   grows with D, the SM's instruction throughput sets it.
2. With ``--sass DIR``: ``cuobjdump -sass`` of the built library into
   ``DIR/fused_block.sass``, and each warp-route instantiation's
   instruction count.

Prints one JSON line per probe.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

A_B = (0.1, 0.01)  # alpha, beta


def full_case(seed: int, D: int, U: int, A: int):
    """Kernel-1 inputs of D documents with every position live (f in 1..3),
    every slot valid, and cv the block-start slot's own count plus 0..49."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    f = torch.randint(1, 4, (U, D), **kw).to(torch.float32)
    z0 = torch.randint(0, A, (U, D), dtype=torch.int32, **kw)
    ndk0 = torch.zeros((A, D), device="cuda").scatter_add_(0, z0.long(), f)
    own = torch.zeros((D, U, A), device="cuda").scatter_(
        2, z0.T.long().contiguous()[:, :, None], f.T.contiguous()[:, :, None])
    cv = own + torch.randint(0, 50, (D, U, A), **kw).to(torch.float32)
    nkg = torch.randint(5000, 20000, (A, D), **kw).to(torch.float32) + 89.69
    valid = torch.ones((A, D), device="cuda")
    u = torch.rand((1, U, D), **kw)
    return cv, f, u, z0, nkg, valid, ndk0


def occupancy_probe(seed: int) -> list:
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    U, A = 128, 56
    rows = []
    for D in (132, 264, 528, 1056, 2112, 3168, 3696, 4224, 4635):
        args = full_case(seed, D, U, A)
        got = fbc._launch("warp", *args, *A_B)
        want = fbc.fused_block_torch(*args, *A_B) if D <= 528 else got
        chip_smoke._check(chip_smoke._bitwise(got, want), f"D={D}: warp == plain")
        ms = chip_smoke._batch_ms(lambda: fbc._launch("warp", *args, *A_B), 10)
        rows.append(dict(D=D, U=U, A=A, ms=ms, ns_per_step=1e6 * ms / U,
                         ns_per_doc_step=1e6 * ms / (U * D)))
        print(json.dumps({"occupancy": rows[-1]}), flush=True)
        del args, got, want
    return rows


def sass_probe(out_dir: Path) -> dict:
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    lib, _, _ = fbc.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "fused_block.sass").write_text(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return {k: v for k, v in counts.items() if "warp" in k}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sass", type=Path, default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_warp_route: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card_line())
    print(json.dumps({"occupancy_rows": occupancy_probe(args.seed)}), flush=True)
    if args.sass is not None:
        print(json.dumps({"sass_instructions": sass_probe(args.sass)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

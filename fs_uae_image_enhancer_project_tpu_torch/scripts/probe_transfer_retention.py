"""Host-RSS retention of host->card transfers.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.probe_transfer_retention \\
        [--mb 8] [--n 200] [--sample_every 25] [--device cpu]

Port of the repo's ``scripts/probe_transfer_retention.py``: the JAX package
saw long training runs grow host RSS in proportion to the bytes sent to its
device, with every array dropped. This probe isolates that path on the card:
N copies of one M-MB float32 host array with ``torch.from_numpy(host).to(dev)``,
each forced to complete by fetching one element and then dropped; RSS is
sampled every K copies (after a ``gc.collect``) and printed as the root
script's lines, GB retained per GB sent. The last line is one JSON object:
the baseline RSS and every sample.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys


def rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1048576.0
    return float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Host RSS retained by host->card copies")
    ap.add_argument("--mb", type=float, default=8.0, help="array size, MB")
    ap.add_argument("--n", type=int, default=200, help="number of copies")
    ap.add_argument("--sample_every", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device

    dev = resolve_device(args.device)
    print(f"device={dev} array={args.mb} MB x {args.n} puts", flush=True)
    host = np.ones((int(args.mb * 1048576) // 4,), np.float32)

    base = rss_gb()
    print(f"baseline rss: {base:.2f} GB", flush=True)
    samples = []
    for i in range(1, args.n + 1):
        a = torch.from_numpy(host).to(dev)
        # force the copy to complete, then drop every reference
        a[:1].cpu()
        del a
        if i % args.sample_every == 0:
            gc.collect()
            sent_gb = i * args.mb / 1024.0
            grown = rss_gb() - base
            ratio = grown / sent_gb if sent_gb else 0.0
            print(f"puts={i} sent={sent_gb:.2f} GB rss_growth={grown:.2f} GB "
                  f"(ratio {ratio:.2f})", flush=True)
            samples.append({"puts": i, "sent_gb": sent_gb, "rss_growth_gb": grown,
                            "ratio": ratio})
    print(json.dumps({"device": str(dev), "mb": args.mb, "n": args.n,
                      "baseline_rss_gb": base, "samples": samples}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serve a model with batched requests: prefill once, decode greedily,
report latency per token (the port's counterpart of the reference's
``examples/serve_lm.py``).  The reduced configuration by default, as the
reference serves; ``--full-width`` takes the published one.  Prefill
attends through the flash kernel (``attn_impl="pallas"``; CPU tensors
take its plain version).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma-2b --gen 24
"""

from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_config, get_reduced
from ..launch.serve import serve_batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published configuration")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (get_config if args.full_width else get_reduced)(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    out = serve_batch(args.arch, args.batch, args.prompt_len, args.gen,
                      device=args.device, cfg=cfg)
    print(f"{out['config']}: batch {args.batch}, prompt {args.prompt_len}")
    print(f"  prefill: {out['prefill_s']*1e3:8.1f} ms")
    print(f"  decode : {out['decode_s_per_token']*1e3:8.2f} ms/token")
    print(f"  kernel launches: prefill {out['prefill_launches']}, "
          f"decode {out['decode_launches']}")
    print("  sample generations (token ids): "
          f"{out['tokens'][:2, :8].tolist()}")
    return out


if __name__ == "__main__":
    main()

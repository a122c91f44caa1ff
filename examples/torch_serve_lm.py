"""Serving example on the PyTorch/CUDA port: prefill + batched decode
with per-family KV caches.

The twin of ``serve_lm.py`` on ``repro_torch``: initializes a reduced
model, prefills a batch of prompts and streams greedy tokens, through
the same prefill / decode steps the dry run counts at scale (GQA cache,
MLA latent cache, SSM state).  It runs on the card; ``--device cpu``
runs it on the host.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma3_1b \
          --tokens 16 [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import api


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this example runs on the card and found no "
                           "CUDA device; pass --device cpu")
    cfg = get_config(args.arch).reduced()
    model = api.get_model(cfg, remat=False)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)

    B, P, T = args.batch, args.prompt_len, args.prompt_len + args.tokens
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(B, P))).to(device)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    with torch.no_grad():
        t0 = time.time()
        logits, cache = model.prefill(params, batch, cache_len=T)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(device)
        print(f"prefill {B}x{P} on {device}: {time.time()-t0:.2f}s")

        out = [tok]
        t0 = time.time()
        for i in range(args.tokens - 1):
            logits, cache = model.decode_step(params, cache, tok, P + i)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        _sync(device)
    dt = time.time() - t0
    gen = torch.cat(out, dim=1)
    print(f"decoded {args.tokens-1} steps x {B} seqs in {dt:.2f}s "
          f"({(args.tokens-1)*B/max(dt,1e-9):.1f} tok/s)")
    print("sample token ids:", gen[0, :12].tolist())
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all())


if __name__ == "__main__":
    main()

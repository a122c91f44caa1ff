"""Serving launcher of the port: batched prefill + greedy decode loop.

On the card, at full width, from a SEARS checkpoint:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32_1b --ckpt

On the CPU, at the reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32_1b \
      --tiny --device cpu

A VLM config (``phi3_vision_4b``) prefills seeded image patch embeddings
before the prompt's tokens.

Port of the JAX reference's ``repro/launch/serve.py``.  The weights come
from a seeded ``torch.Generator``; ``--ckpt`` first saves them through
``SEARSCheckpointManager`` (engine ``"fused"`` on the card, ``"numpy"``
on the CPU) and serves the copy restored from the store.  It runs on
CUDA unless ``--device cpu`` is given, and fails without a card.
"""

from __future__ import annotations

import argparse
import time


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompts(cfg, B: int, P: int, seed: int, device):
    """(tokens (B, P), patches or None): the tokens of ``seed``'s numpy
    generator and, for a config with ``n_patches``, image patch
    embeddings (B, n_patches, d_model) drawn after them, N(0, 1) in bf16,
    as ``api.make_batch`` draws a VLM batch."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, P)))
    patches = None
    if cfg.n_patches:
        patches = torch.from_numpy(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return tokens.to(device), patches


def serve(model, params, tokens, n_tokens: int, device,
          patches=None) -> dict:
    """Prefill ``tokens`` (B, P) -- after ``patches`` (B, n_patches,
    d_model), where given, which take the first cache slots -- then
    ``n_tokens - 1`` greedy decode steps; returns the generated tokens
    (B, n_tokens), the last step's logits and cache, and the times."""
    import torch
    batch = {"tokens": tokens}
    if patches is not None:
        batch["patches"] = patches
    P = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache_len=P + n_tokens)
    tok = torch.argmax(logits, -1)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(n_tokens - 1):
        logits, cache = model.decode_step(params, cache, tok, P + i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "cache": cache, "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", action="store_true",
                    help="save the weights through a SEARS checkpoint "
                         "and serve the restored copy")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import api

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve runs on the card and found no CUDA "
                           "device; pass --device cpu to run on the host")
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.reduced()
    model = api.get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    if args.ckpt:
        from repro_torch.checkpoint import SEARSCheckpointManager
        mgr = SEARSCheckpointManager(
            engine="fused" if device.type == "cuda" else "numpy")
        t0 = time.perf_counter()
        saved = mgr.save(1, params)
        t1 = time.perf_counter()
        params = mgr.restore(params)
        print(f"checkpoint: {saved['bytes']} bytes saved in {t1 - t0:.2f}s,"
              f" restored in {time.perf_counter() - t1:.2f}s")
    tokens, patches = prompts(cfg, args.batch, args.prompt_len, 0, device)
    with torch.no_grad():
        res = serve(model, params, tokens, args.tokens, device, patches)
    steps = args.tokens - 1
    seen = f" after {cfg.n_patches} patches" if cfg.n_patches else ""
    print(f"{cfg.name} on {device}: prefill {args.batch}x{args.prompt_len}"
          f"{seen} "
          f"in {res['prefill_s']:.2f}s; {steps} decode steps x "
          f"{args.batch} seqs in {res['decode_s']:.2f}s "
          f"({steps * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("sample token ids:", res["tokens"][0, :12].tolist())


if __name__ == "__main__":
    main()

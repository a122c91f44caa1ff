"""Serving launcher of the port: batched prefill + greedy decode loop.

On the card, at full width, from a SEARS checkpoint:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32_1b --ckpt

On the CPU, at the reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama32_1b \
      --tiny --device cpu

A VLM config (``phi3_vision_4b``) prefills seeded image patch embeddings
before the prompt's tokens; an encoder-decoder (``whisper_tiny``)
encodes seeded frame embeddings, as many as the prompt's tokens, first.

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


def prompts(cfg, B: int, P: int, seed: int, device) -> dict:
    """The serve batch of ``seed``'s numpy generator: ``tokens`` (B, P),
    then, drawn after them, N(0, 1) in bf16 (rounded through fp32): image
    patch embeddings ``patches`` (B, n_patches, d_model) for a config
    with ``n_patches``, as ``api.make_batch`` draws a VLM batch, and
    audio frame embeddings ``frames`` (B, P, d_model) for an
    encoder-decoder, as the reference's launcher draws them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(B, P))).to(device)}
    extra = ("patches", cfg.n_patches) if cfg.n_patches else \
        ("frames", P) if cfg.family == "encdec" else None
    if extra is not None:
        batch[extra[0]] = torch.from_numpy(rng.normal(
            size=(B, extra[1], cfg.d_model)).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return batch


def serve(model, params, batch: dict, n_tokens: int, device) -> dict:
    """Prefill ``batch`` -- its ``tokens`` (B, P) after its ``patches``
    (B, n_patches, d_model), where given, which take the first cache
    slots; an encoder-decoder's ``frames`` take none -- then
    ``n_tokens - 1`` greedy decode steps; returns the generated tokens
    (B, n_tokens), the last step's logits and cache, and the times."""
    import torch
    P = prefix_len(batch)
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


def prefix_len(batch: dict) -> int:
    """Decoder positions a batch's prefill takes: its tokens and
    patches."""
    patches = batch.get("patches")
    return batch["tokens"].shape[1] + (
        0 if patches is None else patches.shape[1])


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
    batch = prompts(cfg, args.batch, args.prompt_len, 0, device)
    # --tokens decode steps after the prefill's token, as the reference
    # runs them, in a cache of prompt + tokens + 1 slots
    steps = args.tokens
    with torch.no_grad():
        res = serve(model, params, batch, steps + 1, device)
    seen = f" after {cfg.n_patches} patches" if cfg.n_patches else \
        f" over {args.prompt_len} frames" if "frames" in batch else ""
    print(f"{cfg.name} on {device}: prefill {args.batch}x{args.prompt_len}"
          f"{seen} "
          f"in {res['prefill_s']:.2f}s; {steps} decode steps x "
          f"{args.batch} seqs in {res['decode_s']:.2f}s "
          f"({steps * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("sample token ids:", res["tokens"][0, :12].tolist())


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SEARS (``repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA device:

    python3 chip_smoke.py [--log-dir DIR]

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (first
use compiles them with ``nvcc``), then drives the store's main path
through the entry points a user calls, on the card:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions, build time,
   the integer peak of the storage kernels' bounds (``int_peak``).
2. ``put``: one put window of 16 users x 4 files x 3 MiB (192 MiB; a
   quarter of each file from a seeded shared pool) into
   ``SEARSStore(classes=[StorageClass.realtime()])`` -- 20 clusters, ULB
   binding, (10,5) code, 1/4/8 KB chunker, the default ``kernel`` engine,
   the runtime sanitizer on.  Its launch counts must fit the sanitizer's
   model: 1 gear, <= ceil(chunks/512) SHA-1, <= one GF per length bucket.
3. ``get``: every file back, byte for byte.
4. ``degraded_get``: five nodes of a cluster that holds data killed; the
   gets decode through the GF kernel and must still be byte-equal.
5. ``repair``: the killed nodes replaced, ``repair_all()``; the report
   must balance and a get afterwards must be byte-equal.
6. ``fused_put``, ``fused_get``, ``fused_degraded_get``,
   ``fused_repair``: the fused ingest path -- the same window into a
   fresh store on ``engine="fused"`` (``TorchFusedEngine``): 1 gear,
   no SHA-1 and no GF launch, at most one fused launch per length
   bucket.  Its node piece digests, index records and stats must equal
   the ``kernel`` store's after phase 2; then every file back, a
   degraded get and a repair, as in phases 3-5.
7. ``kernels``: each CUDA kernel against its plain torch version on the
   card at main-path shapes (exact equality), timed beside its bound in
   two ways: ``ms``, one wrapper call in each CUDA-event pair (host work
   included), and ``device_ms``, the device alone (``device_time``: 20
   calls captured in one CUDA graph, replayed in one event pair, inputs
   rotated over twice the L2).  The GF kernel runs every (r, k) it has
   an instantiation for -- the (10,5) encode, (5,5) decodes -- and the
   generic one at (14,10); SHA-1 also hashes 512 messages of 8 KB (the
   longest chain) and one 8 KB message among empty ones against
   hashlib.  The fused ingest kernel runs one bucket of the main path's
   (10,5) encode and one of the archival (14,10), each batch with the
   SHA-1 padding edges and chunks that end on a row end, and is also held
   to the staged SHA-1 + GF kernels on the same chunks (``staged_ms``,
   ``staged_device_ms_by_shape``) and to hashlib.  Launch counts in this
   line are those of the main paths (phases 2-5 for the staged kernels,
   6 for the fused one): every kernel must have launched there.
8. ``differential``: a 32 MiB trace through the port's ``NumpyEngine``
   and through ``TorchEngine()`` on the card; node piece digests, index
   records and stats must be identical.
9. ``fused_paths``: the store paths a fused engine changes, each at
   <= 32 MiB on ``engine="fused"`` beside the port's ``NumpyEngine`` on
   the same trace, identical: a mixed realtime + archival window, a
   ``shards=4`` window, a ``BatchScheduler`` flush with gets, and a
   write-back cache window (no fused launch at commit, GF at the drain).
10. ``profile_put``, ``profile_fused_put``: the put window once more on
   each engine, into a fresh store, under ``torch.profiler``: the
   device's busy time by kernel and copy, and its idle share.
11. ``checkpoint``: llama3.2-1b at full width, cut to 8 of its 16
   layers (``SERVE_LAYERS``), built on the card from
   ``torch.Generator`` seed 0 (~1.5 GB of bf16), saved as step 1
   through ``SEARSCheckpointManager`` into a store on
   ``engine="fused"`` (one SEARS file per leaf), restored and held equal
   leaf for leaf; then step 2 with only ``final_norm`` changed, whose
   dedup saving must be near 1.
12. ``serve``: the restored weights serve 4 prompts of 1024 tokens
   (seed 0): prefill, then greedy decode to 32 tokens with a KV cache of
   1056, in bf16 with the reference's bf16 cache.  Then one prefill
   over the prompt plus the 31 tokens fed back: the k/v that decode
   wrote into the cache must equal the same slots of that prefill's
   cache, layer by layer, and the last decode step's logits its logits,
   each within a share of the largest |value| (``SERVE_CACHE_TOL``,
   ``SERVE_LOGIT_TOL``), with the same argmax where the top two logits
   lie further apart than that; the same again on the prompts of seeds
   1 and 2 (``SERVE_SEEDS``).
13. ``flash``: the flash-attention kernel (K6) through
   ``ops.flash_attention``, which sends bf16 to the tensor-core kernel
   (``KERNELS["flash_attn"]``) and fp32 to the CUDA-core kernel
   (``KERNELS["flash_attn_fp32"]``); each shape must launch its dtype's
   kernel and no other.  Shapes: layer 0's q (recomputed from the
   prompt) and k, v (the serve prefill's cache); a long shape (B=1,
   S=T=8192, 32 query and 8 KV heads, hd 64, causal: the model's
   attention takes its blockwise branch there); small shapes with a
   window, without causal, at hd 128 and at hd 256; the reference's own
   hd-32 shapes (``HD_SHAPES``: causal, unaligned, more keys than
   queries, window 128, non-causal), a head dim between the kernels'
   instances (hd 80, run on the hd-96 instance), and the long shape's
   layout at hd 32.  In bf16 every
   shape runs on the seeds of ``FLASH_SEEDS`` and is held to its plain
   version element by element within ``FLASH_BF16_C`` * 2^-8 * |plain|
   + ``FLASH_BF16_A`` (the line prints the readings the constants come
   from); at layer 0's, the long shape and every shape of hd 32, 80 and
   96 a control, the plain version with the keys and values shifted by
   one slot (the keys alone where nothing is masked), must read above
   that gate (2e-5 in fp32).  fp32 copies of every shape but gemma3-1b's
   and internlm2-20b's layers are held within 2e-5; both
   dtypes are held against ``layers.attention`` within 2e-2 (bf16) or 2e-5
   (fp32), the tolerances of ``tests/test_flash_attn.py``.  Then K6 is
   timed at the long shape in bf16 and fp32 and at layer 0's shape (per
   call and on the device alone), each beside
   ``F.scaled_dot_product_attention`` (``library_ms`` and
   ``library_device_ms``, never called by the port), with its plain
   version and the model's
   attention at the long shape; the rows give TFLOP/s, the share of the
   bound and ``ptxas -v``'s registers and spills for each head dim.
   In bf16 K6 is also held and timed (``device_ms`` beside SDPA's) at
   the attention shapes of three more configs' layers, at the serve batch
   and prompt: gemma3-1b's (16 stored query heads, one KV head, head dim
   256, window 512), internlm2-20b's (48:8 heads, head dim 128) and
   phi-3-vision's (32:32 heads, head dim 96, over the prompt and its 576
   patches), and at hd 32's long shape.  In fp32 it is timed the same way
   at layer 0's shape, at hd 128 and 256, at phi-3-vision's layer and at
   hd 32's long shape, so the fp32 row shows each head dim's instance.
   Each timed shape carries its bound and the bound's term (bytes, the
   products, or the softmax's exponent at ``MUFU_PER_SM_CLOCK``: the
   larger at bf16's hd 32).

14. ``train``: llama3.2-1b at full width, cut to 2 of its 16 layers
   (``TRAIN_LAYERS``), trained through ``Trainer(mesh=default_mesh())``
   (the (1, 1) host mesh over a one-rank nccl group; the state DTensors
   in the train step's placements) with int8 moments at B =
   8, S = 512 on ``SyntheticCorpus``, random weights from
   ``torch.Generator`` seed 0: steps 1-2, the save of the whole train state
   at step 2 through the trainer's own manager (``engine="kernel"``: K2, K4
   and K1 must launch), then steps 3-8, timed, under
   ``torch.use_deterministic_algorithms``.  Then a crash: a new ``Trainer``
   on the same manager, nodes 0, 2, 4, 6, 8 of every cluster dead,
   ``restore_or_init``, each leaf straight onto its placements
   (``restore(shardings=)``; K1 must decode); the restored state must
   equal the step-2 state, placements included, and step 3 run again the
   uninterrupted step 3, bit for bit, and the restore must make no
   whole-tree host copy (``HostLeaves``: the deserializer's host leaves
   alive at once peak under the state's bytes).  The line gives the
   mesh, the leaves by placement, that peak, the step times and tokens/s,
   the trainer's peak
   device memory (steps 1-2 and the save, read before the checks keep the
   step-2 and step-3 states), the losses, the save's and the restore's
   seconds, bytes and launches.
15. ``dense_configs``: after ``train``, with the card freed, three more
   dense models at full width (``DENSE_CONFIGS``), random bf16 weights
   made on the card from ``torch.Generator`` seed 0: gemma3-1b (26
   layers, head dim 256, a 512-token window on five of every six layers,
   4 query heads padded to 16, one KV head), internlm2-20b (48 layers,
   d 6144, 48:8 heads) and deepseek-coder-33b cut to 24 of its 62 layers
   (56 query heads padded to 64).  gemma3-1b's weights are saved through
   ``SEARSCheckpointManager`` on ``engine="fused"`` (K2 and K5 must
   launch), nodes 0, 2, 4, 6, 8 of every cluster are killed, and the
   restore (K1 must decode) must equal the save bit for bit; it serves
   from that copy.  Each model then runs the serve check of phase 12
   (``decode_vs_prefill``: 4 x 1024-token prompts, 32 greedy tokens, on
   ``SERVE_SEEDS``, under ``SERVE_CACHE_TOL`` / ``SERVE_LOGIT_TOL``, or
   the config's own gates of ``SERVE_GATES``, each with the shifted
   control above it).  Then seed 0's prompts once more through the step
   builders (``mesh_serve``: ``build_prefill_step`` and
   ``build_decode_step`` on ``make_host_mesh()``, a ``ShapeConfig`` of
   prompt + 32 slots and batch 4, the weights wrapped as DTensors without
   a copy): its tokens, last logits and every cache leaf must equal the
   plain serve's bit for bit, and each prefill output's shape
   ``cache_specs``'s (but a VLM's slots and an encoder-decoder's cross
   length, which the reference's builders give otherwise).  This holds
   for the config phases 16 and 17 too.
   One line per config: its layers (and the cut), parameters and stored
   bytes, init seconds, the peak of ``max_memory_allocated``, prefill
   and decode tokens/s, the check's readings, and for gemma3-1b the
   save's and restore's seconds and launches; each beside the card's
   name and power limit.
16. ``moe_mla_configs``: after ``dense_configs``, on a freed card, the
   same for the MoE, MLA and VLM configs (``MOE_MLA_CONFIGS``):
   granite-moe-1b (12 of its 24 layers, for the script's time; 32
   experts top-8; its weights saved
   through the ``fused`` store, K2 and K5 must launch, and restored with
   nodes 0, 2, 4, 6, 8 of every cluster dead, K1 must decode, bit for
   bit), deepseek-v2-236b cut to 4 of its 60 layers (160 routed experts
   top-6, 2 shared, MLA with a 512-wide latent cache) and phi-3-vision
   (all 32 layers, 576 seeded patch embeddings prefilled before each
   prompt).  An MoE config serves at its published capacity factor
   (1.25; timed, with the share of routed slots dropped at prefill and
   at decode) and runs the serve check at ``capacity_factor = E / k``,
   which drops nothing: a decode group is the 4 new tokens alone, so
   under drops decode and prefill differ by design.  The extended
   prefill routes each token as the serve did (``replayed_routing``: a
   near tie of the router that the two paths round apart would move the
   token's later entries), and the check counts the (token, MoE layer)
   pairs whose top-k set the prefill would have chosen otherwise, with
   their router margins.  One line per
   config, as ``dense_configs`` prints them, plus the active parameters
   and the routing readings.
17. ``ssm_encdec_configs``: after ``moe_mla_configs``, on a freed card, the
   same for the SSM, hybrid and encoder-decoder configs
   (``SSM_ENCDEC_CONFIGS``): whisper-tiny (4 encoder and 4 decoder layers,
   6 heads stored as 16; 1024 seeded frame embeddings encoded before each
   prompt; its weights through the ``fused`` store, K2 and K5 must launch,
   and restored with nodes 0, 2, 4, 6, 8 of every cluster dead, K1 must
   decode, bit for bit), falcon-mamba-7b (all 64 Mamba-1 layers) and
   jamba-1.5-large cut to one period of its pattern, 8 of 72 layers (one
   attention layer, seven Mamba mixers, four MLPs and four 16-expert top-2
   MoE layers), whose routed experts are drawn once a group and shared by
   its four MoE layers (``SHARED_EXPERT_DRAW``: a stride-0 view, every
   shape and FLOP kept).  The serve check compares the SSM state caches
   (``h``, ``conv``) whole, per layer, after the same P+n-1 tokens, with a
   control of layer 0's ``h`` from a prefill one token shorter; the cross
   caches (``ek``, ``ev``) must be equal bit for bit.  jamba serves timed at
   capacity 1.25 and is checked at E / k, as the MoE configs are.  One line
   per config, as ``moe_mla_configs`` prints them, plus the SSM widths
   (``d_inner``, ``ssm_state``, ``dt_rank``), the cache's bytes by kind,
   whisper's encoder layers and frames, and jamba's ``depth_cut`` and
   ``shared_expert_draw``.  The ``kernels`` line then gives, for each
   kernel, its launches in the checkpoints of ``train``, gemma3-1b,
   granite-moe-1b and whisper-tiny (``checkpoint_launches``).
18. ``roofline``: every step the phases above timed -- the train step
   and each served config's prefill and one decode step at the cache
   length its serve reached (21 steps) -- counted by
   ``repro_torch.launch.analysis.analyze_step`` on fake ``cuda`` tensors
   at exactly the shapes it ran (dots' FLOPs, every op's bytes), off any
   timed window, and set beside the time its phase measured: the
   compute term (FLOPs at 989 TFLOP/s bf16), the memory term (bytes at
   3.35 TB/s), ``bound_share`` (the larger over the measured time) and
   ``mfu`` (6 or 2 N D over the measured time at the peak).  No compute
   term may exceed its measured time by over 5%
   (``ROOFLINE_COMPUTE_SLACK``), and llama3.2-1b's prefill, run once for
   real on the card under the counter, must count the fake trace's
   FLOPs exactly.  One line per step, then one with the checks.
19. ``examples``: ``examples/torch_*.py`` run on the card as
   subprocesses, all four together (``EXAMPLES``); each must exit 0.
20. ``mesh_ranks``: the models on a mesh of more than one device.
   Here, the mesh of one's serve (4 x 1024-token prompts of seed 0, 32
   greedy tokens, seed-0 weights at full width) of each
   ``MESH_RANK_CONFIGS`` arch -- llama3.2-1b (8 of 16 layers, its 8 KV
   heads over ``model``), gemma3-1b (26 layers; one KV head, so the
   cache shards its slots; a 262,144-row vocabulary), whisper-tiny
   (heads padded to 16, cross caches), falcon-mamba-7b at 8 of its 64
   layers (the ``in_proj`` exchange), granite-moe-1b at 8 of 24 (its
   experts over ``model``), deepseek-v2-236b at 2 of 60 (MLA; 160
   experts) and jamba-1.5-large at 8 of 72 (one period, its routed
   experts drawn once a group), the MoE configs at their published
   capacity 1.25, their routing logged -- and 3 train steps of
   llama3.2-1b (the train phase's config) and of granite-moe-1b at 4
   layers on the mesh of one.  Then two rank subprocesses
   (``chip_smoke.py --mesh-rank``) share the card, a gloo group over
   localhost (NCCL refuses two ranks on one device): each config served
   through the step builders on its mesh, (1, 2) (and deepseek-v2 also
   (2, 1): its experts over the data plane, by all-to-all, and a decode
   step's 4 tokens one group across both ranks), weights drawn leaf by
   leaf, each rank keeping its shards, the ranks in turn; decode fed the
   mesh of one's tokens, the MoE layers routed as the mesh of one routed
   them (each rank's count of the pairs its own routing would have
   changed printed, ``routing_flips_by_rank``), its last logits and
   every cache leaf whole (``whole``: an all-reduce of each shard placed
   into zeros) held by the serve gates, each decided argmax equal; and
   the train steps through ``Trainer(mesh=)`` on (2, 1) (ZeRO-1, int8
   moments) and (1, 2), loss and grad norm a step within
   ``MESH_TRAIN_LOSS_TOL`` / ``MESH_TRAIN_GNORM_TOL``.  One line: each
   config's readings, times and the collectives of a prefill and a
   decode step (and of a train step), labelled ``MESH_RANKS_LABEL``:
   two ranks on one card over gloo through the host are not a
   tensor-parallel speed.  A failing rank fails the phase.
21. ``dryrun``: ``python -m repro_torch.launch.dryrun`` in subprocesses
   (``DRYRUN_RUNS``: llama3.2-1b at ``train_4k`` and every config at
   ``decode_32k``, each on the 16x16 and 2x16x16 meshes, fake ``cuda``
   tensors), started before phase 18 and traced on the host's CPU
   while phases 18-20 run: their fake 512-rank process group cannot
   share this process with the mesh phases' one-rank group.  One line
   with each cell's resident GB per chip, roofline terms and trace
   seconds; every cell must trace one rank's sharded step, with its
   collective term.
22. ``total``: the script's seconds from its start, the build included
   (the ``env`` line gives the build's own).

K1-K5 must equal their plain versions exactly; K6 sums floats in
another order than its plain version, so it is held to its gate.
Each phase prints one JSON line; then the ``{"kernels": [...]}`` line,
the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without
a CUDA device, or without the repository beside it, it exits non-zero
and prints no result.  ``--log-dir`` writes the compilers' output and
the profiler's table there.  ``time_kernels.py`` runs phase 7 alone
on any checkout's kernels, to compare two commits in one call.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth,
# the fp32 rate outside the tensor cores (K6's fp32 kernel) and the dense
# bf16 tensor core rate (K6's bf16 kernel).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_TC_PER_S = 989e12
# The storage kernels (K1-K5) do 32-bit integer and logic work: an SM
# executes 64 such operations a clock (4 x 16 INT32 lanes), so their peak
# is 64 x SMs x the maximum SM clock that nvidia-smi reports
# (``int_peak``).  Without a card: the data sheet's 132 SMs at 1980 MHz.
INT_OPS_PER_SM_CLOCK = 64
NOMINAL_SMS, NOMINAL_MAX_SM_MHZ = 132, 1980.0
# Device-only timing (``device_time``): this many calls captured in one
# CUDA graph, replayed inside one event pair; inputs rotate over copies
# that span twice the 50 MB L2, so each call finds its inputs in HBM as
# a main-path call finds freshly uploaded ones.
DEVICE_LAUNCHES = 20
DEVICE_REPLAYS = 5
L2_SPAN_BYTES = 100 << 20
# K6 against the model's attention (both dtypes) and the fp32 kernel
# against its plain version: the tolerances of tests/test_flash_attn.py
# (rtol = atol).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The bf16 kernel against its plain version, element by element:
# |got - plain| <= FLASH_BF16_C * 2^-8 * |plain| + FLASH_BF16_A.  Rule
# (PERF.md, written before the run that read them): twice the largest
# reading over every bf16 shape on FLASH_SEEDS, rounded up to one
# significant digit.  Readings: a, the largest |got - plain| where
# |plain| < FLASH_GATE_SPLIT (there the relative term is under 2.5e-4);
# c, the largest |got - plain| / (2^-8 |plain|) where |plain| >= it.
FLASH_SEEDS = (13, 14)
# bf16 shapes of more configs' attention layers, at the serve batch and
# prompt: (name, stored query heads, KV heads, head dim, window, positions
# after the prompt: phi-3-vision's 576 patches)
LAYER_SHAPES = (("gemma3_layer", 16, 1, 256, 512, 0),
                ("internlm2_layer", 48, 8, 128, 0, 0),
                ("phi3_vision_layer", 32, 32, 96, 0, 576))
# K6's shapes at the head dims the reference's own tests run (hd 32,
# tests/test_flash_attn.py) and one hd between the kernels' instances:
# (name, B, S, T, H, KV, hd, causal, window), in both dtypes
HD_SHAPES = (("hd32", 1, 256, 256, 2, 2, 32, True, 0),
             ("hd32_unaligned", 1, 300, 300, 2, 1, 32, True, 0),
             ("hd32_more_kv", 1, 256, 768, 4, 4, 32, True, 0),
             ("hd32_window", 1, 512, 512, 2, 2, 32, True, 128),
             ("hd32_non_causal", 1, 256, 256, 2, 2, 32, False, 0),
             ("hd80_routed", 1, 300, 300, 4, 2, 80, True, 0))
# The softmax's exponent: an SM's MUFU units issue 16 ex2 a clock, one a
# live query-key pair (K6's third bound term, beside bytes and products)
MUFU_PER_SM_CLOCK = 16
# What the K6 rows give for each timed shape (as ``<key>_by_shape``)
BY_SHAPE_KEYS = ("ms", "device_ms", "plain_ms", "library_ms",
                 "library_device_ms", "bound_ms", "bound_term")
FLASH_GATE_SPLIT = 2.0 ** -4
FLASH_BF16_C = 9.0
FLASH_BF16_A = 3e-3
# The serve check: the last decode step against one prefill over the
# prompt and the fed-back tokens, on the prompts of each seed.  The two
# paths round to bf16 at different places (matmuls of B rows against
# B x 1055), and 16 layers of random weights carry it forward.  Each
# tolerance is a share of the compared tensor's largest |value|: the bf16
# k/v that decode wrote into the cache, layer by layer, against the same
# slots of the extended prefill's cache; and the last logits.  Each is
# twice the largest reading over the three seeds on an H100, rounded up
# (cache 0.0245 at layer 15, logits 0.0211: PERF.md, the serve check);
# a cache one slot off reads above 1.
SERVE_SEEDS = (0, 1, 2)
SERVE_CACHE_TOL = 5e-2
SERVE_LOGIT_TOL = 5e-2
# Config-specific serve gates, (cache, logits), by the rule PERF.md wrote
# before any reading (section 5, the dense configs): twice the config's
# largest reading over the three seeds, rounded up to one significant
# digit, kept only while its shifted control reads above it.
# internlm2-20b read 0.0704 at most on an H100 80GB HBM3 at 700 W (its 48
# layers carry the two paths' bf16 roundings further: its layer 15 read
# 0.0296), its shifted control 1.45-1.64.  falcon-mamba-7b's 64 layers
# read 0.0714 (its state ``h``; ``conv`` 0.0546, logits 0.0517; layer 0
# reads 0, and the reading grows ~0.001 a layer, as internlm2-20b's), its
# control (layer 0's ``h`` one token short) 0.381-0.637.  The MoE configs
# keep the base gates: their check replays the serve's routing into the
# prefill (``replayed_routing``), so a router's near tie that the two
# paths' roundings break apart moves neither a token's later entries nor
# its row's state.
SERVE_GATES = {"internlm2_20b": (2e-1, 2e-1),
               "falcon_mamba_7b": (2e-1, 2e-1)}
# SHA-1 integer operations per 64-byte block, in the card's 3-input
# forms: 64 schedule words x (two 3-input XORs (LOP3) + a rotate) + 80
# rounds x (f as one LOP3, two adds for f + e + W + K, rotl(a, 5) + X as
# one LEA.HI, rotl(b, 30)) + 5 adds into the state.
SHA1_OPS_PER_BLOCK = 64 * 3 + 80 * 5 + 5
# GF(2^8) product by bit planes (K1's form), per 32-bit word of data:
# the eight byte masks of an input word (a shift and a PRMT each, one
# shift fewer for bit 7), needed by inputs with an entry that is neither
# 0 nor 1; eight AND-XORs (LOP3) for each such entry; one XOR for an
# entry 1; nothing for an entry 0.
GF_MASK_OPS, GF_ENTRY_OPS = 15, 8
# Chunk lengths every K5 batch holds besides its bucket's: SHA-1's padding
# edges (the 0x80 byte and the bit length in one block or two) on rows
# shorter than 64 bytes, and a pad row (length 0).
FUSED_EDGES = (0, 1, 55, 56, 63, 64, 119, 120)


# Steps timed after the save (3-8); their median skips the first.
TRAIN_TIMED_STEPS = 6
# Layers of llama3.2-1b the train phase keeps (of 16).  Its save and
# degraded restore are host-bound and scale with the state's bytes: at
# all 16 layers (11.45 GB) they took 600 s of a 1227 s run on a slow
# host, over the script's limit beside the later phases; 4 layers (4.6
# GB) took 250 s of a 1260 s run on a slow host once the mesh_ranks
# phase came (PERF.md, PR 23); 2 layers keep 3.5 GB of state (the
# embedding and its optimizer state are 2.4 GB of it).
TRAIN_LAYERS = 2
# Layers of llama3.2-1b the checkpoint and serve phases keep (of 16), for
# the same reason: its weights' save, restore and deduplicated second
# save took 154 s of that run at 16 layers (2.47 GB); 8 layers keep 1.5
# GB, every width and the serve check's shapes.
SERVE_LAYERS = 8
# The dense configs served after the train phase, at full width: (arch,
# layers kept, None for all of them).  deepseek-coder-33b holds 0.545e9
# parameters a layer: its 62 layers (68.5 GB of bf16) leave an 80 GB card
# no room for the cache and the check, so it keeps 24 (27 GB).  The
# first config's weights go through a SEARS checkpoint before it serves.
DENSE_CONFIGS = (("gemma3_1b", None), ("internlm2_20b", None),
                 ("deepseek_coder_33b", 24))
# The MoE, MLA and VLM configs served after them, at full width: (arch,
# layers kept, None for all of them).  deepseek-v2-236b holds 7.95 GB of
# bf16 a layer (160 routed experts): ``init`` draws each stacked expert
# leaf in fp32 beside its bf16 result (5.03e9 elements, 20.1 GB at 4
# layers), so at 6 layers the init peak would near 80 GB; it keeps 4
# (33.9 GB with embed and unembed).  granite-moe-1b's weights go through
# a SEARS checkpoint before it serves: at all 24 layers its save and
# degraded restore took 97 s of a 962 s call on an H100 (PERF.md), so it
# keeps 12; phi-3-vision prefills 576 patch embeddings before each
# prompt.
MOE_MLA_CONFIGS = (("granite_moe_1b", 12), ("deepseek_v2_236b", 4),
                   ("phi3_vision_4b", None))
# The SSM, hybrid and encoder-decoder configs served after them, at full
# width: (arch, layers kept, None for all of them).  whisper-tiny (4
# encoder and 4 decoder layers, 96 MB stored with its head padding) goes
# through a SEARS checkpoint before it serves.  falcon-mamba-7b keeps all
# 64 layers (14.3 GB; its stacked in_proj, 8.6 GB, is drawn in fp32
# beside its bf16 result, ~31 GB at the init's peak).  jamba-1.5-large
# keeps one period of its pattern, 8 of 72 layers (one attention layer,
# seven Mamba mixers, four MLPs and four MoE layers): 8 layers hold 90.6
# GB, more than the card, so it draws its routed experts once a group
# (``SHARED_EXPERT_DRAW``): 32.6 GB resident.
SSM_ENCDEC_CONFIGS = (("whisper_tiny", None), ("falcon_mamba_7b", None),
                      ("jamba_15_large", 8))
SHARED_EXPERT_DRAW = ("jamba_15_large",)
# nodes killed in every cluster before a degraded restore: n - k of (10,5)
KILLED_NODES = (0, 2, 4, 6, 8)
# The roofline phase: a step's compute term (its dots at the card's bf16
# peak) may exceed the time the phase measured by this factor at most.
ROOFLINE_COMPUTE_SLACK = 1.05
# The dryrun phase's subprocesses: (name, --arch, --shape), "*" for every
# arch of ARCH_IDS; each on both meshes.  Their traces run on the host's
# CPU beside the roofline and examples phases.
DRYRUN_RUNS = (("train", "llama32_1b", "train_4k"),
               ("decode", "*", "decode_32k"))
DRYRUN_TIMEOUT_S = 600
# The mesh_ranks phase: two rank subprocesses on the one card, a gloo
# group over localhost (NCCL refuses two ranks on one device), serve these
# configs at full width -- (arch, layers kept, None for all of them, the
# mesh): llama3.2-1b's 8 KV heads shard (at ``SERVE_LAYERS``, as the
# serve phase, for the script's time), gemma3-1b's one does not (its
# cache shards its slots), whisper-tiny's 16 stored heads and cross
# caches, falcon-mamba-7b's in_proj exchange at 8 of its 64 layers (for
# time); granite-moe-1b's 32 experts over ``model`` at 8 of 24 layers;
# deepseek-v2-236b at 2 of 60 layers (the init draws each stacked expert
# leaf in fp32 beside its bf16 result, 15 GB a rank at 2 layers) on (1,
# 2), its experts' F and MLA's heads and latent slots over ``model``, and
# on (2, 1), its experts over the data plane (the all-to-all) and a
# decode step's 4 tokens one group across both ranks; jamba-1.5-large at
# one period, 8 of 72 layers, its routed experts drawn once a group
# (``SHARED_EXPERT_DRAW``), F over ``model`` -- and train llama3.2-1b
# (the train phase's config) and granite-moe-1b at
# ``MESH_RANK_TRAIN_MOE_LAYERS`` layers on these meshes.  A rank draws
# each leaf whole and keeps its shard, the two ranks in turn, so one
# draw's fp32 transient is on the card at a time.  A rank that fails
# fails the phase.
MESH_RANK_CONFIGS = (("llama32_1b", SERVE_LAYERS, (1, 2)),
                     ("gemma3_1b", None, (1, 2)),
                     ("whisper_tiny", None, (1, 2)),
                     ("falcon_mamba_7b", 8, (1, 2)),
                     ("granite_moe_1b", 8, (1, 2)),
                     ("deepseek_v2_236b", 2, (1, 2)),
                     ("deepseek_v2_236b", 2, (2, 1)),
                     ("jamba_15_large", 8, (1, 2)))
MESH_RANK_TRAIN = (("llama32_1b", (2, 1)), ("llama32_1b", (1, 2)),
                   ("granite_moe_1b", (2, 1)), ("granite_moe_1b", (1, 2)))
MESH_RANK_TRAIN_MOE_LAYERS = 4
MESH_RANK_TRAIN_STEPS = 3
# The mesh train against the mesh of one, per step (PERF.md, written
# before the first reading): the loss within 2e-3 and the grad norm
# within 2e-2, relative.  The two runs round their bf16 matmuls apart
# (column- and row-parallel halves, sums over ranks), and AdamW's
# normalised update moves an entry whose gradient is near 0 by up to lr
# whichever way it rounds (the reduced model on 4 CPU ranks read 1e-4
# and 7.8e-4: tests/test_torch_multirank.py).
MESH_TRAIN_LOSS_TOL = 2e-3
MESH_TRAIN_GNORM_TOL = 2e-2
MESH_RANKS_TIMEOUT_S = 400
# the phase's time, its subprocesses' included: 124.6 s with the MoE,
# MLA and hybrid configs on a 700 W H100 (PERF.md), room for a
# host 45% slower
MESH_RANKS_BUDGET_S = 200
MESH_RANKS_LABEL = ("two ranks on one card over gloo through the host: "
                    "not a tensor-parallel speed")
# The examples phase: (example, arguments), run on the card together.
EXAMPLES = (("torch_quickstart", ()), ("torch_serve_lm", ()),
            ("torch_train_lm", ("--tiny", "--steps", "20", "--ckpt-every",
                                "10", "--crash-at", "10")),
            ("torch_checkpoint_restore", ()))
EXAMPLES_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Sizes:
    users: int = 16
    files_per_user: int = 4
    file_bytes: int = 3 << 20
    segment: int = 64 << 10   # shared-pool granule of the put files
    diff_bytes: int = 32 << 20
    gf_batch: int = 1024
    gf_len: int = 2048
    gear_bytes: int = 64 << 20
    sha1_msgs: int = 512
    sha1_max: int = 8192
    fused_batch: int = 16384    # a put window's bucket (K5 timing)
    fused_len: int = 1024
    reps: int = 20
    reduced: bool = False       # llama32_1b.reduced() (CPU rehearsal)
    serve_batch: int = 4
    prompt_len: int = 1024
    gen_tokens: int = 32
    long_seq: int = 8192
    train_batch: int = 8
    train_seq: int = 512


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data --
def make_files(sizes: Sizes, seed: int) -> dict[str, list[tuple[str, bytes]]]:
    """Per-user files; a quarter of each file's segments from a shared pool."""
    import numpy as np
    rng = np.random.default_rng(seed)
    seg = sizes.segment
    nseg = sizes.file_bytes // seg
    pool = [rng.bytes(seg) for _ in range(64)]
    out: dict[str, list[tuple[str, bytes]]] = {}
    for u in range(sizes.users):
        files = []
        for f in range(sizes.files_per_user):
            shared = set(rng.choice(nseg, size=nseg // 4, replace=False))
            parts = [pool[int(rng.integers(len(pool)))] if i in shared
                     else rng.bytes(seg) for i in range(nseg)]
            files.append((f"user{u}/file{f}.bin", b"".join(parts)))
        out[f"user{u}"] = files
    return out


def get_all(store, files) -> float:
    """Get every file back and hold it byte-equal; returns seconds."""
    t0 = time.perf_counter()
    for user, fl in files.items():
        got = store.get_files(user, [name for name, _ in fl])
        for (name, data), (blob, _) in zip(fl, got):
            if blob != data:
                raise AssertionError(f"{name}: bytes differ after get")
    return time.perf_counter() - t0


def artifacts(store) -> dict:
    """Node piece digests, index records, listings and stats of a store."""
    nodes = {}
    for cl in store.clusters:
        for node in cl.nodes:
            h = hashlib.sha1()
            for cid, pidx in sorted(node._pieces):
                h.update(cid)
                h.update(pidx.to_bytes(4, "big"))
                h.update(hashlib.sha1(node._pieces[(cid, pidx)]).digest())
            nodes[(cl.cluster_id, node.node_id)] = h.hexdigest()
    return {"nodes": nodes,
            "records": sorted((cid, cl, info.refcount, info.length)
                              for cid, cl, info in store.index.records()),
            "listings": {u: sorted(sw.table)
                         for u, sw in sorted(store.switching.items())},
            "stats": dataclasses.asdict(store.stats())}


# ------------------------------------------------------------ main path --
def main_path(sizes: Sizes, engine, sync, prefix: str = ""
              ) -> tuple[list[dict], dict, dict]:
    """put / get / degraded_get / repair on ``engine``; returns the phase
    lines (names prefixed by ``prefix``), the kernel launch counts of the
    whole path and the store's artifacts right after the put."""
    from repro_torch.core import SEARSStore, StorageClass
    from repro_torch.kernels import gf_matmul, ops
    from repro_torch.kernels.launches import KERNELS, LAUNCHES, reset_kernels

    files = make_files(sizes, seed=11)
    logical = sum(len(d) for fl in files.values() for _, d in fl)
    cls = StorageClass.realtime()
    store = SEARSStore(classes=[cls], engine=engine, sanitize=True)
    fused = store.engine.supports_fused_ingest
    lines = []

    reset_kernels()
    before = LAUNCHES.snapshot()
    t0 = time.perf_counter()
    stats = store.put_windows_pipelined([list(files.items())])[0]
    sync()
    put_s = time.perf_counter() - t0
    d = LAUNCHES.delta(before)
    chunks = sum(s.n_chunks for s in stats)
    buckets = math.ceil(cls.code.piece_len(cls.chunk_max) / gf_matmul.TILE_L)
    if fused:
        if d.gear != 1 or d.sha1 or d.gf or not 1 <= d.fused <= buckets:
            raise AssertionError(f"fused put launches {d} outside the "
                                 f"model: 1 gear, 0 sha1, 0 gf, 1..{buckets}"
                                 f" fused")
    elif d.gear != 1 or d.sha1 > math.ceil(chunks / 512) or d.gf > buckets \
            or d.gf < 1 or d.sha1 < 1 or d.fused:
        raise AssertionError(f"put launches {d} outside the model: 1 gear, "
                             f"<= {math.ceil(chunks / 512)} sha1, 1..{buckets}"
                             f" gf for {chunks} chunks")
    put_art = artifacts(store)
    lines.append({"phase": prefix + "put", "files": len(stats),
                  "mib": logical / 2**20, "seconds": put_s,
                  "mib_per_s": logical / 2**20 / put_s, "chunks": chunks,
                  "dedup_ratio": store.stats().dedup_ratio,
                  "launches": dataclasses.asdict(d),
                  "kernels": dict(KERNELS)})

    before = LAUNCHES.snapshot()
    get_s = get_all(store, files)
    lines.append({"phase": prefix + "get", "seconds": get_s,
                  "mib_per_s": logical / 2**20 / get_s,
                  "launches": dataclasses.asdict(LAUNCHES.delta(before))})

    victim = max(store.clusters, key=lambda c: c.used)
    victim.kill_nodes([0, 2, 4, 6, 8])
    before = LAUNCHES.snapshot()
    deg_s = get_all(store, files)
    d = LAUNCHES.delta(before)
    if d.gf < 1:
        raise AssertionError("degraded get launched no GF decode")
    lines.append({"phase": prefix + "degraded_get",
                  "cluster": victim.cluster_id, "seconds": deg_s,
                  "launches": dataclasses.asdict(d)})

    victim.replace_nodes([0, 2, 4, 6, 8])
    before = LAUNCHES.snapshot()
    t0 = time.perf_counter()
    report = store.repair_all()
    sync()
    rep_s = time.perf_counter() - t0
    d = LAUNCHES.delta(before)
    if not report.balanced or report.pieces_rebuilt < 1:
        raise AssertionError(f"repair did not balance: {report}")
    after_s = get_all(store, files)
    # every (r, k) the GF kernel ran at so far in this process
    gf_shapes = sorted({tuple(key[2]) for key in ops._SEEN_SHAPES
                        if key[0] == "gf"})
    lines.append({"phase": prefix + "repair", "seconds": rep_s,
                  "gf_shapes": gf_shapes,
                  "pieces_rebuilt": report.pieces_rebuilt,
                  "chunks_rebuilt": len(report.rebuilt),
                  "get_after_seconds": after_s,
                  "launches": dataclasses.asdict(d),
                  "kernels": dict(KERNELS)})
    return lines, dict(KERNELS), put_art


def differential(sizes: Sizes, engine) -> dict:
    """Same trace through NumpyEngine and the torch engine: identical."""
    from repro_torch.core import SEARSStore, StorageClass
    per_user = sizes.diff_bytes // 8 // 4
    sub = dataclasses.replace(sizes, users=8, files_per_user=4,
                              file_bytes=per_user)
    files = make_files(sub, seed=23)
    users = sorted(files)
    arts, obs, t = [], [], []
    for eng in ("numpy", engine):
        store = SEARSStore(classes=[StorageClass.realtime()], engine=eng,
                           sanitize=True)
        t0 = time.perf_counter()
        # two pipelined put windows, a delete, an overwrite, then gets
        store.put_windows_pipelined([list(files.items())[:4],
                                     list(files.items())[4:]])
        store.delete_file(users[0], files[users[0]][0][0])
        store.put_files(users[1], [(files[users[1]][0][0],
                                    files[users[2]][1][1])])
        seen = []
        for user in users[1:]:
            names = [name for name, _ in files[user]]
            for blob, st in store.get_files_pipelined(user, names):
                seen.append((hashlib.sha1(blob).hexdigest(),
                             dataclasses.astuple(st)))
        obs.append(seen)
        arts.append(artifacts(store))
        t.append(time.perf_counter() - t0)
    if obs[0] != obs[1]:
        raise AssertionError("differential: gets diverged")
    for key in ("nodes", "records", "listings", "stats"):
        if arts[0][key] != arts[1][key]:
            raise AssertionError(f"differential: {key} diverged")
    return {"phase": "differential", "mib": sizes.diff_bytes / 2**20,
            "numpy_seconds": t[0], "torch_seconds": t[1],
            "nodes": len(arts[0]["nodes"]), "records": len(arts[0]["records"]),
            "identical": True}


def fused_paths(sizes: Sizes, engine) -> list[dict]:
    """The store paths a fused engine changes, each on ``engine`` and on
    the port's ``NumpyEngine`` with the same trace: identical results."""
    from repro_torch.core import SEARSStore, StorageClass
    from repro_torch.core.cache import CacheConfig
    from repro_torch.core.workload import MixedClassConfig, mixed_class_trace
    from repro_torch.kernels.launches import LAUNCHES

    cap = sizes.diff_bytes
    # mixed realtime + archival: 8 users x (4 hot files of cap/128 + 2
    # cold of cap/32) = 3/4 of the cap, 24 MiB at full size
    mixed = mixed_class_trace(MixedClassConfig(
        n_users=8, hot_files_per_user=4, hot_kb=cap // 2**17,
        cold_files_per_user=2, cold_kb=cap // 2**15, seed=41))
    per_file = cap // 32
    # 16 users x 2 files: one window over four shards
    wide = make_files(dataclasses.replace(sizes, users=16, files_per_user=2,
                                          file_bytes=per_file), seed=43)
    # 8 users x 4 files: one scheduler flush, then their gets
    narrow = make_files(dataclasses.replace(sizes, users=8, files_per_user=4,
                                            file_bytes=per_file), seed=47)
    wb_files = dict(list(narrow.items())[:4])

    def via_scheduler(store, requests, gets=()):
        sched = store.scheduler()
        puts = [sched.submit_put(u, fl, storage_class=c)
                for u, fl, c in requests]
        sched.flush()
        futs = [sched.submit_get(u, names) for u, names in gets]
        sched.flush()
        return ([[dataclasses.astuple(x) for x in f.result()] for f in puts]
                + [[(hashlib.sha1(b).hexdigest(), dataclasses.astuple(st))
                    for b, st in f.result()] for f in futs]), None

    def writeback(store):
        before = LAUNCHES.snapshot()
        up = [[dataclasses.astuple(x) for x in store.put_files(u, fl)]
              for u, fl in wb_files.items()]
        commit = LAUNCHES.delta(before)
        return (up, store.flush()), commit

    realtime, archival = StorageClass.realtime(), StorageClass.archival()
    cases = [
        ("mixed_class", dict(classes=[realtime, archival]),
         lambda st: via_scheduler(st, mixed),
         [b for _, fl, _ in mixed for _, b in fl]),
        ("shards", dict(classes=[realtime], shards=4),
         lambda st: via_scheduler(st, [(u, fl, None)
                                       for u, fl in wide.items()]),
         [b for fl in wide.values() for _, b in fl]),
        ("scheduler", dict(classes=[realtime]),
         lambda st: via_scheduler(
             st, [(u, fl, None) for u, fl in narrow.items()],
             [(u, [n for n, _ in fl]) for u, fl in narrow.items()]),
         [b for fl in narrow.values() for _, b in fl]),
        ("writeback", dict(classes=[realtime], cache=CacheConfig(
            capacity_bytes=4 * cap, write_back=True)), writeback,
         [b for fl in wb_files.values() for _, b in fl]),
    ]
    lines = []
    for name, kw, drive, blobs in cases:
        logical = sum(len(b) for b in blobs)
        if logical > cap:
            raise AssertionError(f"fused_paths {name}: {logical} > {cap} "
                                 f"bytes")
        got, arts, secs = [], [], []
        for eng in ("numpy", engine):
            store = SEARSStore(engine=eng, sanitize=True, **kw)
            before = LAUNCHES.snapshot()
            t0 = time.perf_counter()
            result, commit = drive(store)
            secs.append(time.perf_counter() - t0)
            got.append(result)
            arts.append(artifacts(store))
        d = LAUNCHES.delta(before)  # the fused store's whole case
        if got[0] != got[1]:
            raise AssertionError(f"fused_paths {name}: results diverged")
        for key in ("nodes", "records", "listings", "stats"):
            if arts[0][key] != arts[1][key]:
                raise AssertionError(f"fused_paths {name}: {key} diverged")
        line = {"name": name, "mib": logical / 2**20,
                "numpy_seconds": secs[0], "fused_seconds": secs[1],
                "launches": dataclasses.asdict(d),
                "records": len(arts[0]["records"]), "identical": True}
        if name == "writeback":
            # the ack hashes on the staged path; the drain encodes
            if commit.fused or commit.gf or commit.sha1 < 1 or d.fused \
                    or d.gf < 1:
                raise AssertionError(f"fused_paths writeback: commit "
                                     f"{commit}, whole {d}")
            line["commit_launches"] = dataclasses.asdict(commit)
        elif d.fused < 1 or d.sha1 or d.gf:
            raise AssertionError(f"fused_paths {name}: launches {d}")
        lines.append(line)
    return lines


# -------------------------------------------------------------- kernels --
def timer(device):
    """Median milliseconds of ``fn`` over ``reps`` runs after warm-up: one
    call of the Python wrapper in each CUDA-event pair, so the wrapper's
    host work counts where the device waits for it."""
    import torch

    def run(fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if device.type != "cuda":
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)
    return run


def device_time(fns, device) -> float | None:
    """Device milliseconds of one call: ``DEVICE_LAUNCHES`` calls, cycling
    over ``fns``, captured in one CUDA graph and replayed inside one event
    pair (median of ``DEVICE_REPLAYS`` replays, over the launch count).  A
    replay runs only the captured kernels, never the wrappers' host work.
    Each fn is called once before the capture (builds, uploads, memos).
    None without a card."""
    if device.type != "cuda":
        return None
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(DEVICE_LAUNCHES):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(DEVICE_REPLAYS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / DEVICE_LAUNCHES)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(ts)


def copies(tensors: tuple, nbytes: int) -> list[tuple]:
    """``tensors`` and clones of them, enough that the calls of
    ``device_time`` cycling over them move L2_SPAN_BYTES (``nbytes`` a
    call): each call then reads its inputs from HBM."""
    n = max(1, math.ceil(L2_SPAN_BYTES / nbytes)) \
        if tensors[0].device.type == "cuda" else 1
    return [tensors] + [tuple(x.clone() for x in tensors)
                        for _ in range(n - 1)]


def int_peak(device) -> dict:
    """The 32-bit integer / logic peak of the card: INT_OPS_PER_SM_CLOCK x
    SMs x the maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    if device.type != "cuda":
        sms, mhz, source = NOMINAL_SMS, NOMINAL_MAX_SM_MHZ, "nominal"
    else:
        import torch
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60)
        mhz, source = float(out.stdout.split()[0]), "nvidia-smi"
    return {"ops_per_s": INT_OPS_PER_SM_CLOCK * sms * mhz * 1e6, "sms": sms,
            "max_sm_mhz": mhz, "source": source}


def gf_ops(M, words: int) -> int:
    """Integer operations that an (r, k) matrix ``M`` times (k, 4 x
    ``words``) bytes of data needs (GF_MASK_OPS, GF_ENTRY_OPS)."""
    import numpy as np
    M = np.asarray(M)
    general = (M != 0) & (M != 1)
    return words * (GF_MASK_OPS * int(general.any(axis=0).sum())
                    + GF_ENTRY_OPS * int(general.sum())
                    + int((M == 1).sum()))


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, launches, err, ms, device_ms, plain_ms,
          nbytes, ops, shape, peak_ops) -> dict:
    bms, by = bound(nbytes, ops, peak_ops)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": shape, "bytes": nbytes, "ops": ops}


def kernels(sizes: Sizes, device, counts: dict) -> list[dict]:
    """Each kernel against its plain version at main-path shapes, timed
    per wrapper call (``ms``) and on the device alone (``device_ms``).
    ``counts`` gives each row's ``launches``."""
    import numpy as np
    import torch
    from repro_torch.core import chunking, hashing, rs_code
    from repro_torch.core.classes import StorageClass
    from repro_torch.kernels import (_build, fused_ingest, gear_cdc,
                                     gf_matmul, ref, sha1, tables)

    run = timer(device)
    peak = int_peak(device)["ops_per_s"]
    usage = ptxas_by_entry(_build.BUILD_INFO["log"])
    t = tables.tables(device)
    rng = np.random.default_rng(5)
    reps = sizes.reps
    out = []

    def maxerr(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def upload(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(device)

    # K1: GF(2^8) matmul at every (r, k) of the main path -- the (10,5)
    # encode and (5,5) decodes: the received set (1,3,5,7,9) of the
    # degraded get and the repair (unit rows among them) and parity only
    # (5..9) -- and at (14,10), the archival encode, which no main path
    # runs (the kernel's generic instantiation)
    B, L = sizes.gf_batch, sizes.gf_len
    data = upload(rng.integers(0, 256, (B, 5, L), dtype=np.uint8))
    data10 = upload(rng.integers(0, 256, (B, 10, L), dtype=np.uint8))
    G = rs_code.generator_matrix(10, 5)
    mats = {"encode_10_5": (G, data),
            "decode_5_5": (rs_code.decode_matrix(10, 5, (1, 3, 5, 7, 9)),
                           data),
            "decode_parity_5_5": (rs_code.decode_matrix(10, 5, tuple(
                range(5, 10))), data),
            "generic_14_10": (rs_code.generator_matrix(14, 10), data10)}
    err, errs, by_shape = 0, {}, {}
    for name, (M, d) in mats.items():
        got = gf_matmul.gf_matmul(M, d)
        want = ref.gf_matmul_ref(torch.from_numpy(M.astype(np.uint8)).to(
            device), d, t.gf_log, t.gf_exp)
        errs[name] = maxerr(got, want)
        err = max(err, errs[name])
        r, k = M.shape
        # gf_matmul at L % TILE_L == 0 launches the kernel and nothing else
        sets = copies((d,), B * L * (k + r))
        by_shape[name] = device_time(
            [lambda M=M, x=x: gf_matmul.gf_matmul(M, x) for (x,) in sets],
            device)
        del got, want, sets
    del data10
    Gt = torch.from_numpy(G.astype(np.uint8)).to(device)
    ms = run(lambda: gf_matmul.gf_matmul(G, data), reps)
    plain = run(lambda: ref.gf_matmul_ref(Gt, data, t.gf_log, t.gf_exp), 3, 1)
    e = entry("gf_matmul", "gf_matmul.cu",
              "src/repro/kernels/gf_matmul.py:34", counts["gf_matmul"], err,
              ms, by_shape["encode_10_5"], plain, B * L * (5 + 10),
              gf_ops(G, B * L // 4), [B, 5, L], peak)
    e.update(max_abs_err_by_shape=errs, device_ms_by_shape=by_shape,
             ptxas={f: u for f, u in usage.items() if "gf_matmul" in f})
    out.append(e)

    # K2/K3: gear fire (realtime and archival masks) and gear hash
    n = sizes.gear_bytes
    stream = upload(rng.integers(0, 256, n, dtype=np.uint8))
    masks = [StorageClass.realtime().chunker.mask,
             StorageClass.archival().chunker.mask]
    h_plain = ref.gear_hash_ref(stream, t.gear)
    err = 0
    for mask in masks:
        got = gear_cdc.gear_fire(stream, mask)
        want = (h_plain & gear_cdc._mask_bits(mask)) == 0
        err = max(err, maxerr(got, want))
    ms = run(lambda: gear_cdc.gear_fire(stream, masks[0]), reps)
    fire = torch.empty(n, dtype=torch.bool, device=device)
    dms = device_time([lambda: gear_cdc.launch(stream, masks[0], fire)],
                      device)
    plain = run(lambda: (ref.gear_hash_ref(stream, t.gear)
                         & gear_cdc._mask_bits(masks[0])) == 0, 3, 1)
    # cheapest form: per byte a lookup, shift, add, and, compare
    out.append(entry("gear_fire", "gear_cdc.cu",
                     "src/repro/kernels/gear_cdc.py:92", counts["gear_fire"],
                     err, ms, dms, plain, 2 * n + 1024, 5.0 * n, [n], peak))
    got = gear_cdc.gear_hash(stream)
    err = maxerr(got, h_plain)
    head = min(n, 1 << 16)
    seq = chunking.gear_hash_sequential(stream[:head].cpu().numpy())
    if not np.array_equal(got[:head].cpu().numpy().view(np.uint32), seq):
        raise AssertionError("gear hash differs from the sequential oracle")
    ms = run(lambda: gear_cdc.gear_hash(stream), reps)
    hashes = torch.empty(n, dtype=torch.int32, device=device)
    dms = device_time([lambda: gear_cdc.launch(stream, 0, hashes)], device)
    plain = run(lambda: ref.gear_hash_ref(stream, t.gear), 3, 1)
    out.append(entry("gear_hash", "gear_cdc.cu",
                     "src/repro/kernels/gear_cdc.py:68", counts["gear_hash"],
                     err, ms, dms, plain, 5 * n + 1024, 3.0 * n, [n], peak))
    del stream, h_plain, got, fire, hashes

    # K4: SHA-1 over 512 messages of 0..8192 bytes, also against hashlib;
    # then two batches against hashlib alone: every message 8 KB (129
    # blocks each, the chain's worst case) and one 8 KB message among
    # empty ones (a single chain)
    def sha1_batch(msgs):
        blocks, cnt = hashing.sha1_pad_batch(msgs, max_len=sizes.sha1_max)
        bt, ct = upload(blocks.view(np.int32)), upload(cnt)
        got = sha1.sha1_digest_words(bt, ct)
        digests = hashing.digest_words_to_bytes(
            got.cpu().numpy().view(np.uint32))
        if digests != [hashlib.sha1(m).digest() for m in msgs]:
            raise AssertionError(f"SHA-1 kernel differs from hashlib on "
                                 f"{len(msgs)} messages of up to "
                                 f"{max(map(len, msgs))} bytes")
        return bt, ct, got

    def sha1_device_ms(bt, ct):
        sets = copies((bt, ct), bt.numel() * 4)
        outs = [torch.empty((bt.shape[0], 5), dtype=torch.int32,
                            device=device) for _ in sets]
        return device_time([lambda b=b, c=c, o=o: sha1.launch(b, c, o)
                            for (b, c), o in zip(sets, outs)], device)

    m = sizes.sha1_msgs
    lens = rng.integers(0, sizes.sha1_max + 1, m)
    lens[:2] = (0, sizes.sha1_max)
    msgs = [rng.bytes(int(x)) for x in lens]
    bt, ct, got = sha1_batch(msgs)
    want = ref.sha1_ref(bt, ct)
    err = maxerr(got, want)
    ms = run(lambda: sha1.sha1_digest_words(bt, ct), reps)
    dms = sha1_device_ms(bt, ct)
    plain = run(lambda: ref.sha1_ref(bt, ct), 1, 1)
    nblk = int(ct.sum())
    e = entry("sha1", "sha1.cu", "src/repro/kernels/sha1.py:56",
              counts["sha1"], err, ms, dms, plain,
              nblk * 64 + m * (4 + 20), nblk * SHA1_OPS_PER_BLOCK,
              list(bt.shape), peak)
    worst = [rng.bytes(sizes.sha1_max) for _ in range(m)]
    wbt, wct, _ = sha1_batch(worst)
    one = [rng.bytes(sizes.sha1_max)] + [b""] * (m - 1)
    obt, oct_, _ = sha1_batch(one)
    e["longest_chain_rounds"] = int(ct.max()) * 80
    e["ptxas"] = {f: u for f, u in usage.items() if "sha1" in f}
    e["device_ms_all_8k"] = sha1_device_ms(wbt, wct)
    e["device_ms_one_8k"] = sha1_device_ms(obt, oct_)
    out.append(e)
    del bt, ct, got, want, wbt, wct, obt, oct_

    # K5: fused SHA-1 + encode of one bucket of chunks in (k*(Lp-512),
    # top] bytes: at B x Lp = gf_batch x gf_len, the main path's (10,5)
    # and the archival (14,10) of the mixed-class path, up to its 16 KB
    # chunks; and at fused_batch x fused_len, a (10,5) bucket the size of
    # a put window's (its launch takes the small-block form).  Each batch
    # also holds the padding edges and chunks that end on a row end; each
    # against its plain version, the staged K4 + K1 kernels and hashlib.
    def fused_case(n, k, top, B, Lp):
        code = rs_code.RSCode(n, k)
        Gc = np.ascontiguousarray(rs_code.generator_matrix(n, k),
                                  dtype=np.uint8)
        Gd = gf_matmul._device_matrix(Gc.tobytes(), n, k, device)
        lens = rng.integers(k * (Lp - 512) + 1, top + 1, B)
        full = top // k * k  # ends on the end of its last row
        fixed = (FUSED_EDGES + (full, full - 1, full - 9))[:B]
        lens[:len(fixed)] = fixed
        msgs = [rng.bytes(int(x)) for x in lens]
        plens = [code.piece_len(len(m)) for m in msgs]
        packed = np.stack([rs_code.pack_blob(m, k, L, Lp)
                           for m, L in zip(msgs, plens)])
        data = upload(packed)
        nb = upload(lens.astype(np.int32))
        pl = upload(np.asarray(plens, np.int32))
        words, enc = fused_ingest.fused_ingest(Gc, data, nb, pl)
        pw, pe = ref.fused_ingest_ref(Gd, data, nb, pl, t.gf_log, t.gf_exp)
        err = max(maxerr(words, pw), maxerr(enc, pe))
        blocks, cnt = hashing.sha1_pad_batch(msgs, max_len=k * Lp)
        bt, ct = upload(blocks.view(np.int32)), upload(cnt)
        if not (torch.equal(words, sha1.sha1_digest_words(bt, ct))
                and torch.equal(enc, gf_matmul.gf_matmul(Gc, data))):
            raise AssertionError(f"fused ingest ({n},{k}) differs from "
                                 f"staged SHA-1 + GF")
        digests = hashing.digest_words_to_bytes(
            words.cpu().numpy().view(np.uint32))
        if digests != [hashlib.sha1(m).digest() for m in msgs]:
            raise AssertionError(f"fused ingest ({n},{k}) SHA-1 differs "
                                 f"from hashlib")
        nbytes = B * Lp * (k + n) + B * (4 + 4 + 20)
        sets = copies((data, nb, pl, bt, ct), nbytes + bt.numel() * 4)
        outs = [(torch.empty_like(words), torch.empty_like(enc))
                for _ in sets]
        dms = device_time([lambda s=s, o=o: fused_ingest.launch(
            Gd, s[0], s[1], s[2], o[0], o[1], t)
            for s, o in zip(sets, outs)], device)
        staged_dms = device_time([lambda s=s, o=o: (
            sha1.launch(s[3], s[4], o[0]), gf_matmul.gf_matmul(Gc, s[0]))
            for s, o in zip(sets, outs)], device)
        return dict(G=Gc, Gd=Gd, data=data, nb=nb, pl=pl, bt=bt, ct=ct,
                    cnt=cnt, err=err, dms=dms, staged_dms=staged_dms,
                    nbytes=nbytes, rounds=int(cnt.max()) * 80)

    B, Lp = sizes.gf_batch, sizes.gf_len
    arch = StorageClass.archival()
    main = fused_case(10, 5, 5 * Lp, B, Lp)
    archival = fused_case(arch.n, arch.k, min(arch.k * Lp, arch.chunk_max),
                          B, Lp)
    big = fused_case(10, 5, 5 * sizes.fused_len, sizes.fused_batch,
                     sizes.fused_len)
    del big["data"], big["bt"]
    G, data, nb, pl = main["G"], main["data"], main["nb"], main["pl"]
    bt, ct, Gt = main["bt"], main["ct"], main["Gd"]
    ms = run(lambda: fused_ingest.fused_ingest(G, data, nb, pl), reps)
    staged = run(lambda: (sha1.sha1_digest_words(bt, ct),
                          gf_matmul.gf_matmul(G, data)), reps)
    plain = run(lambda: ref.fused_ingest_ref(Gt, data, nb, pl, t.gf_log,
                                             t.gf_exp), 3, 1)
    nblk = int(main["cnt"].sum())
    e = entry("fused_ingest", "fused_ingest.cu",
              "src/repro/kernels/ops.py:320", counts["fused_ingest"],
              main["err"], ms, main["dms"], plain,
              main["nbytes"],
              nblk * SHA1_OPS_PER_BLOCK + gf_ops(G, B * Lp // 4),
              [B, 5, Lp], peak)
    cases = {f"encode_10_5_{B}x{Lp}": main,
             f"encode_{arch.n}_{arch.k}_{B}x{Lp}": archival,
             f"encode_10_5_{sizes.fused_batch}x{sizes.fused_len}": big}
    e.update(staged_ms=staged, staged_device_ms=main["staged_dms"],
             ptxas={f: u for f, u in usage.items() if "fused_ingest" in f},
             **{f"{field}_by_shape": {name: c[key]
                                      for name, c in cases.items()}
                for field, key in (("max_abs_err", "err"),
                                   ("device_ms", "dms"),
                                   ("staged_device_ms", "staged_dms"),
                                   ("longest_chain_rounds", "rounds"))})
    e["max_abs_err"] = max(c["err"] for c in cases.values())
    out.append(e)
    return out


def profile_put(sizes: Sizes, engine, device, log_dir=None,
                phase: str = "profile_put") -> dict:
    """The put window again, into a fresh store, under ``torch.profiler``:
    the device's busy time by kernel and copy, and its idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import SEARSStore, StorageClass

    files = make_files(sizes, seed=11)
    store = SEARSStore(classes=[StorageClass.realtime()], engine=engine,
                       sanitize=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        store.put_windows_pipelined([list(files.items())])
        if device.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side events only (kernels, copies): a host op such as
    # aten::copy_ also carries the device time of the copy it issued
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in avgs if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    if log_dir is not None:
        (pathlib.Path(log_dir) / f"chip_smoke_{phase}.txt").write_text(
            avgs.table(sort_by="self_device_time_total", row_limit=40))
    return {"phase": phase, "wall_seconds": wall,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / 1e3 / wall,
            "by_name_ms": [[k, n, ms] for k, n, ms in rows[:10]]}


# ---------------------------------------------------------------- model --
def checkpoint_phase(sizes: Sizes, device, fused_engine, sync
                     ) -> tuple[dict, object, dict]:
    """The model's weights through SEARS: save, restore (bit for bit),
    and a second step that differs in one small leaf."""
    import torch
    from repro_torch.checkpoint import SEARSCheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.launches import KERNELS, LAUNCHES, reset_kernels
    from repro_torch.models import api
    from repro_torch.tree import flatten_with_path

    cfg = get_config("llama32_1b")
    cfg = cfg.reduced() if sizes.reduced else dataclasses.replace(
        cfg, n_layers=SERVE_LAYERS)
    model = api.get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sync()
    init_s = time.perf_counter() - t0
    mgr = SEARSCheckpointManager(engine=fused_engine)
    reset_kernels()
    before = LAUNCHES.snapshot()
    t0 = time.perf_counter()
    s1 = mgr.save(1, params)
    save_s = time.perf_counter() - t0
    save_launches = LAUNCHES.delta(before)
    save_kernels = dict(KERNELS)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in flatten_with_path(params))
    if s1["bytes"] != nbytes or save_launches.gear < 1 \
            or save_launches.fused < 1:
        raise AssertionError(f"checkpoint save: {s1}, launches "
                             f"{save_launches}")
    reset_kernels()
    before = LAUNCHES.snapshot()
    t0 = time.perf_counter()
    restored = mgr.restore(params)
    sync()
    restore_s = time.perf_counter() - t0
    restore_launches = LAUNCHES.delta(before)
    restore_kernels = dict(KERNELS)
    for (path, a), (_, b) in zip(flatten_with_path(restored),
                                 flatten_with_path(params)):
        if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
            raise AssertionError(f"checkpoint leaf {'/'.join(path)} differs "
                                 f"after restore")
    params2 = dict(params, final_norm=params["final_norm"] + 1.0)
    t0 = time.perf_counter()
    s2 = mgr.save(2, params2)
    save2_s = time.perf_counter() - t0
    if s2["dedup_saving"] < 0.99:
        raise AssertionError(f"step 2 deduped only {s2['dedup_saving']}")
    # the store's millions of piece objects hold reference cycles: free
    # them now, not in a collection that lands inside the serve timing
    del params, params2, mgr
    gc.collect()
    leaves = flatten_with_path(restored)
    line = {"phase": "checkpoint", "arch": cfg.name,
            "params": cfg.param_count(), "leaves": len(leaves),
            "largest_leaf_bytes": max(t.numel() * t.element_size()
                                      for _, t in leaves),
            "init_seconds": init_s, "save_seconds": save_s,
            "save_mib_per_s": s1["bytes"] / 2**20 / save_s,
            "restore_seconds": restore_s,
            "restore_mib_per_s": s1["bytes"] / 2**20 / restore_s,
            "bytes": s1["bytes"], "bytes_after_dedup": s1["bytes_after_dedup"],
            "save_launches": dataclasses.asdict(save_launches),
            "save_kernels": save_kernels,
            "restore_launches": dataclasses.asdict(restore_launches),
            "restore_kernels": restore_kernels,
            "restore_identical": True,
            "step2_seconds": save2_s,
            "step2_bytes_after_dedup": s2["bytes_after_dedup"],
            "step2_dedup_saving": s2["dedup_saving"]}
    return line, model, restored


# Caches by kind: slot caches hold one entry per position (GQA's k/v,
# MLA's c/kr), state caches the SSM state after the last position, cross
# caches the encoder's k/v for every position of the frames.
SLOT_CACHES = ("k", "v", "c", "kr")
STATE_CACHES = ("h", "conv")
CROSS_CACHES = ("ek", "ev")


def layer_rel_err(got, want) -> list:
    """max |got - want| / max |want| per layer (the first axis)."""
    dims = tuple(range(1, got.dim()))
    return ((got - want).abs().amax(dim=dims)
            / want.abs().amax(dim=dims)).tolist()


def decode_vs_prefill(model, params, batch: dict, n: int, device, sync,
                      cache_tol: float = SERVE_CACHE_TOL,
                      logit_tol: float = SERVE_LOGIT_TOL) -> dict:
    """Serve ``batch`` (its tokens after its patches, where given; an
    encoder-decoder's frames take no position) to ``n`` greedy tokens,
    then one prefill over the same input and the n-1 tokens fed back.
    Decode step i fed token i at slot P+i (P counts the patches), so the
    slots P..P+n-2 of both slot caches hold the same tokens' entries
    (GQA's k/v, MLA's c/kr); both state caches (the SSM's ``h`` and
    ``conv``) hold the state after the same P+n-1 tokens; both runs
    encode the same frames, so the cross caches (``ek``/``ev``) must be
    equal bit for bit; and the last step's logits and the prefill's are
    for the same position.  Errors are shares of the compared tensor's
    largest |value|; the caches' per layer.  The controls, which must
    read above ``cache_tol``: layer 0's first slot cache one slot off,
    and layer 0's ``h`` of a prefill one token shorter.  With MoE the
    prefills route each token as the serve did (``replayed_routing``:
    decode and the prefill round a router's near ties apart, and a
    flipped token moves its later entries and its row's state), and the
    check counts the (token, MoE layer) pairs whose top-k set the
    prefill would have chosen otherwise (``routing_flips``), with the
    router margins the two runs saw there."""
    import torch
    from repro_torch.launch.serve import prefix_len, serve

    P = prefix_len(batch)
    moe = bool(model.cfg.n_experts)
    model.moe_log = [] if moe else None
    try:
        res = serve(model, params, batch, n, device)
        serve_log = model.moe_log
    finally:
        model.moe_log = None
    ext_batch = dict(batch, tokens=torch.cat(
        [batch["tokens"], res["tokens"][:, :n - 1]], dim=1))
    with replayed_routing(serve_log, n, P + n - 1) as ext_log:
        t0 = time.perf_counter()
        ext, ext_cache = model.prefill(params, ext_batch)
        sync()
        ext_s = time.perf_counter() - t0
    logits, ext = res["logits"].float(), ext.float()
    scale = float(ext.abs().max())
    d = (logits - ext).abs()
    top2 = ext.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > logit_tol * scale
    agree = logits.argmax(-1) == ext.argmax(-1)
    out = {"seed": None, "extended_prefill_seconds": ext_s,
           "logit_scale": scale, "logit_max_abs_err": float(d.max()),
           "logit_rel_err": float(d.max()) / scale,
           "logit_rms_rel_err": float(d.pow(2).mean().sqrt()
                                      / ext.pow(2).mean().sqrt()),
           "argmax_agrees": bool(agree.all()),
           "argmax_decided_rows": int(decided.sum()),
           "argmax_decided_agree": bool(agree[decided].all()),
           "finite": bool(torch.isfinite(logits).all())}
    cache = res["cache"]
    slots = [name for name in sorted(ext_cache) if name in SLOT_CACHES]
    states = [name for name in sorted(ext_cache) if name in STATE_CACHES]
    cross = [name for name in sorted(ext_cache) if name in CROSS_CACHES]
    for name in slots:
        out[f"cache_rel_err_{name}"] = layer_rel_err(
            cache[name][:, :, P:P + n - 1].float(),
            ext_cache[name][:, :, P:P + n - 1].float())
    for name in states:
        out[f"cache_rel_err_{name}"] = layer_rel_err(
            cache[name].flatten(0, -4), ext_cache[name].flatten(0, -4))
    out["cross_caches_identical"] = all(
        torch.equal(cache[name], ext_cache[name]) for name in cross)
    controls = []
    if slots:  # the check must see a cache one slot off
        first = "c" if "c" in ext_cache else "k"
        got = cache[first][0, :, P:P + n - 2].float()
        want = ext_cache[first][0, :, P + 1:P + n - 1].float()
        out["shifted_rel_err"] = float((got - want).abs().max()
                                       / want.abs().max())
        controls.append(out["shifted_rel_err"])
    if states:  # ... and a state one token short
        short_batch = dict(ext_batch, tokens=ext_batch["tokens"][:, :-1])
        with replayed_routing(serve_log, n, P + n - 2):
            _, short_cache = model.prefill(params, short_batch)
        got = short_cache["h"].flatten(0, -4)[0]
        want = ext_cache["h"].flatten(0, -4)[0]
        out["state_short_rel_err"] = float((got - want).abs().max()
                                           / want.abs().max())
        controls.append(out["state_short_rel_err"])
        del short_cache
    if moe:
        out.update(routing_flips(serve_log, ext_log, P, n))
    out["ok"] = (out["finite"] and out["argmax_decided_agree"]
                 and out["logit_rel_err"] <= logit_tol
                 and all(err <= cache_tol for name in slots + states
                         for err in out[f"cache_rel_err_{name}"])
                 and out["cross_caches_identical"]
                 and min(controls) > cache_tol)
    return {"res": res, "check": out}


def served(serve_log, n: int, field: int) -> list:
    """Per MoE layer, one field of a serve's routing log (0 ``idx``, 2
    ``margin``) over the prompt and the n-1 fed-back tokens: the
    prefill's entry, then the decode steps' (as many entries a pass as
    MoE layers), joined along the positions."""
    import torch
    n_moe = len(serve_log) // n
    return [torch.cat([serve_log[j][field]] + [
        serve_log[n_moe * (1 + i) + j][field] for i in range(n - 1)], dim=1)
        for j in range(n_moe)]


@contextlib.contextmanager
def replayed_routing(serve_log, n: int, length: int):
    """Within the block, route the MoE layers of a prefill over the
    first ``length`` positions of a serve's prompt and fed-back tokens
    as that serve routed them: layer j takes the top-k sets of
    ``serve_log`` (the serve's prefill, then its n-1 decode steps, as
    many entries a pass as MoE layers), through ``moe_route(idx=...)``.
    Yields the list that gets, per MoE layer, the prefill's own routing
    of the real tokens, ``(idx, margin)``, (B, length, K) and (B,
    length).  Without a log (no MoE) it does nothing."""
    import torch
    from repro_torch.models import layers as L

    own = []
    if serve_log is None:
        yield own
        return
    want = [idx[:, :length] for idx in served(serve_log, n, 0)]
    route = L.moe_route

    def replay(xg, router, cfg):
        r = route(xg, router, cfg)
        idx = want[len(own)]
        B, S, K = idx.shape
        own.append((r.idx.reshape(-1, K)[:B * S].reshape(B, S, K),
                    r.margin.reshape(-1)[:B * S].reshape(B, S)))
        full = r.idx.reshape(-1, K).clone()  # the group's pad rows: own
        full[:B * S] = idx.reshape(-1, K)
        return route(xg, router, cfg, idx=full.reshape(r.idx.shape))

    L.moe_route = replay
    try:
        yield own
    finally:
        L.moe_route = route


def routing_flips(serve_log, ext_log, P: int, n: int) -> dict:
    """(token, MoE layer) pairs whose top-k expert set the extended
    prefill (its own routing, ``ext_log``) chose otherwise than the
    serve (``serve_log``: the prefill, then the n-1 decode steps): at
    the decoded slots P..P+n-2, with the smaller of the two router
    margins at each flip, and at the prompt's slots."""
    import torch
    flips, prompt, margins = 0, 0, []
    for (e_idx, e_margin), idx, margin in zip(
            ext_log, served(serve_log, n, 0), served(serve_log, n, 2)):
        differ = (idx.sort(-1).values != e_idx.sort(-1).values).any(-1)
        prompt += int(differ[:, :P].sum())
        flips += int(differ[:, P:].sum())
        margins += torch.minimum(margin, e_margin)[:, P:][
            differ[:, P:]].tolist()
    pairs = len(ext_log) * ext_log[0][0].shape[0] * (n - 1)
    return {"routing_pairs": pairs,
            "routing_flips": flips, "routing_flip_margins": sorted(margins),
            "prompt_routing_flips": prompt}


def drop_shares(log, n: int) -> dict:
    """The share of routed slots dropped by capacity at prefill and at
    decode, from the log of a ``serve`` to ``n`` tokens (a prefill and
    n-1 decode steps, each pass as many entries as MoE layers)."""
    def share(entries):
        kept = sum(int(keep.sum()) for _, keep, _ in entries)
        return 1.0 - kept / sum(keep.numel() for _, keep, _ in entries)
    n_moe = len(log) // n
    return {"prefill": share(log[:n_moe]), "decode": share(log[n_moe:])}


def serve_phase(sizes: Sizes, device, model, params, sync
                ) -> tuple[dict, tuple]:
    """Prefill + greedy decode on the restored weights, on the prompts
    of each of ``SERVE_SEEDS``; the KV cache and the logits checked
    against one longer prefill.  Returns the line (``ok`` false if a
    check failed) and layer 0's (q, k, v) of the first prompts'
    prefill."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L

    cfg = model.cfg
    B, P, n = sizes.serve_batch, sizes.prompt_len, sizes.gen_tokens
    checks = []
    with torch.no_grad():
        for seed in SERVE_SEEDS:
            tokens = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab_size, size=(B, P))).to(device)
            r = decode_vs_prefill(model, params, {"tokens": tokens}, n,
                                  device, sync)
            r["check"]["seed"] = seed
            checks.append(r["check"])
            if seed != SERVE_SEEDS[0]:
                del r
                continue
            res = r["res"]
            gen = res["tokens"]
            # layer 0's attention inputs: k, v as the prefill cached them,
            # q from the same layer input the prefill saw
            p0 = model._layer(params, 0)
            h = L.rms_norm(params["embed"][tokens], p0["ln1"], cfg.norm_eps)
            q = L.gqa_query(h, p0["attn"], cfg,
                            torch.arange(P, device=device))
            k = res["cache"]["k"][0, :, :P].contiguous()
            v = res["cache"]["v"][0, :, :P].contiguous()
            del r, res["cache"]
    ok = bool(gen.shape == (B, n) and ((gen >= 0) & (gen < cfg.vocab_size))
              .all()) and all(c["ok"] for c in checks)
    steps = n - 1
    line = {"phase": "serve", "batch": B, "prompt_len": P,
            "cache_len": P + n, "tokens": n,
            "prefill_seconds": res["prefill_s"],
            "prefill_tok_per_s": B * P / res["prefill_s"],
            "decode_seconds": res["decode_s"],
            "decode_tok_per_s": B * steps / res["decode_s"],
            "cache_tol": SERVE_CACHE_TOL, "logit_tol": SERVE_LOGIT_TOL,
            "decode_vs_prefill": checks,
            "first_tokens": gen[:, :8].tolist(), "ok": ok}
    return line, (q, k, v)


def leaves_by_placement(tree) -> dict[str, int]:
    """Count of a tree's leaves by their DTensor placements."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import flatten_with_path

    out: dict[str, int] = {}
    for _, t in flatten_with_path(tree):
        key = repr(tuple(t.placements)) if isinstance(t, DTensor) \
            else "not a DTensor"
        out[key] = out.get(key, 0) + 1
    return out


class HostLeaves:
    """Within the block, the bytes of the host tensors that the
    checkpoint deserializer makes from the store's blobs (one a leaf,
    ``serializer._from_record``) that are alive at once: ``peak``, and
    ``largest``, the largest one.  A restore that kept a whole tree on
    the host before copying it to the card would peak at the tree's
    bytes; one that puts each leaf on the card as it comes peaks at
    about its largest leaf."""

    def __init__(self) -> None:
        self.now = self.peak = self.largest = 0

    @contextlib.contextmanager
    def watch(self):
        import weakref
        from repro_torch.checkpoint import serializer

        make = serializer._from_record

        def tracked(rec, raw):
            t = make(rec, raw)
            n = t.numel() * t.element_size()
            self.now += n
            self.peak, self.largest = max(self.peak, self.now), max(
                self.largest, n)
            weakref.finalize(t, self._free, n)
            return t
        serializer._from_record = tracked
        try:
            yield self
        finally:
            serializer._from_record = make

    def _free(self, n: int) -> None:
        self.now -= n


def train_config(sizes: Sizes, arch: str = "llama32_1b"):
    """The train phase's model config (llama3.2-1b at ``TRAIN_LAYERS``;
    the mesh_ranks phase's other arch at ``MESH_RANK_TRAIN_MOE_LAYERS``;
    or reduced) and step config (int8 moments)."""
    from repro_torch.configs.base import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig
    cfg = get_config(arch)
    layers = TRAIN_LAYERS if arch == "llama32_1b" \
        else MESH_RANK_TRAIN_MOE_LAYERS
    cfg = cfg.reduced() if sizes.reduced else dataclasses.replace(
        cfg, n_layers=layers)
    return cfg, TrainStepConfig(adamw=AdamWConfig(moment_dtype="int8"))


def train_phase(sizes: Sizes, device, sync, card: str = "") -> dict:
    """Train llama3.2-1b with int8 moments through ``Trainer`` on the
    host mesh (``default_mesh``: (1, 1) on the card), its state DTensors
    in the train step's placements; save the step-2 state through the
    trainer's own SEARS manager (``kernel`` engine), crash, kill n-k
    nodes of every cluster, restore straight onto the placements
    (``restore(shardings=)``, no whole-tree host copy), and run step 3
    again: the restored state must equal the saved one and the rerun
    step the uninterrupted one, bit for bit."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed.sharding import local
    from repro_torch.kernels.launches import KERNELS, LAUNCHES, reset_kernels
    from repro_torch.train.trainer import Trainer, TrainerConfig, default_mesh
    from repro_torch.tree import flatten_with_path

    full_layers = get_config("llama32_1b").n_layers
    cfg, step_cfg = train_config(sizes)
    B, S = sizes.train_batch, sizes.train_seq
    dcfg = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size)
    tcfg = TrainerConfig(total_steps=2, ckpt_every=2, step_cfg=step_cfg)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def equal(a, b) -> list[str]:
        return ["/".join(map(str, path)) for (path, x), (_, y) in zip(
            flatten_with_path(a), flatten_with_path(b))
            if x.dtype != y.dtype or x.device != y.device
            or getattr(x, "placements", None) != getattr(y, "placements",
                                                         None)
            or not torch.equal(local(x), local(y))]

    # steps 1-2 and the save at step 2, through Trainer.run
    tr = Trainer(cfg, dcfg, tcfg, mesh=default_mesh(device.type))
    mesh = {"shape": list(tr.mesh.shape),
            "dims": list(tr.mesh.mesh_dim_names),
            "device_type": tr.mesh.device_type}
    marks = {}

    def on_step(step, rec):
        if step == 2:  # the save follows this callback
            reset_kernels()
            marks["launches"] = LAUNCHES.snapshot()
            marks["t"] = time.perf_counter()
    t0 = time.perf_counter()
    tr.run(on_step)
    save_s = time.perf_counter() - marks["t"]
    run_s = time.perf_counter() - t0
    # the trainer's own peak: its state, steps 1-2 and the save, before
    # the checks below keep the step-2 and step-3 states beside it
    peak = torch.cuda.max_memory_allocated() if on_card else None
    save_launches = LAUNCHES.delta(marks["launches"])
    save_kernels = dict(KERNELS)
    ckpt = tr.metrics[-1]
    losses = [m["loss"] for m in tr.metrics if "loss" in m]
    state2 = tr.final_state

    # the uninterrupted run on from step 2, deterministic: step 3 is the
    # restart's reference, steps 3.. are timed
    torch.use_deterministic_algorithms(True)
    try:
        step_s = []
        state, state3 = state2, None
        for step in range(2, 2 + TRAIN_TIMED_STEPS):
            t1 = time.perf_counter()
            *state, m = tr.sharded_step(*state, tr.batch(step))
            losses.append(float(m["loss"]))  # waits for the step
            step_s.append(time.perf_counter() - t1)
            if state3 is None:
                state3, loss3 = tuple(state), losses[-1]
        del state
    finally:
        torch.use_deterministic_algorithms(False)

    # crash: a new trainer on the same manager, n-k nodes of every
    # cluster dead (every systematic piece of half the chunks lost)
    tr2 = Trainer(cfg, dcfg, tcfg, mesh=tr.mesh, manager=tr.manager)
    del tr
    gc.collect()
    for cluster in tr2.manager.store.clusters:
        cluster.kill_nodes(list(KILLED_NODES))
    reset_kernels()
    before = LAUNCHES.snapshot()
    t1 = time.perf_counter()
    with HostLeaves().watch() as host:
        restored, start = tr2.restore_or_init()
        sync()
    restore_s = time.perf_counter() - t1
    restore_launches = LAUNCHES.delta(before)
    restore_kernels = dict(KERNELS)
    restore_diff = equal(restored, state2)
    torch.use_deterministic_algorithms(True)
    try:
        t1 = time.perf_counter()
        *again, m = tr2.sharded_step(*restored, tr2.batch(start))
        loss3_again = float(m["loss"])
        rerun_s = time.perf_counter() - t1
    finally:
        torch.use_deterministic_algorithms(False)
    rerun_diff = equal(tuple(again), state3)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in flatten_with_path(state2))
    placed = {"step_2_state": leaves_by_placement(state2),
              "restored": leaves_by_placement(restored)}
    whole_tree_copy = host.peak >= nbytes
    del again, restored, state2, state3
    gc.collect()
    med = statistics.median(step_s[1:])
    checks = {
        "losses_finite": all(math.isfinite(x) for x in losses),
        # each step draws another batch: the later half's mean must fall
        "loss_falls": statistics.mean(losses[len(losses) // 2:])
        < statistics.mean(losses[:len(losses) // 2]),
        "saved_all_bytes": ckpt.get("ckpt_bytes") == nbytes,
        "restored_step_2": start == 2,
        "restore_identical": not restore_diff,
        "rerun_identical": not rerun_diff and loss3_again == loss3,
        "state_on_placements": "not a DTensor" not in placed["step_2_state"]
        and placed["restored"] == placed["step_2_state"],
        "no_whole_tree_host_copy": not whole_tree_copy}
    if on_card:
        checks["save_launched_k1_k2_k4"] = min(
            save_kernels[k] for k in ("gf_matmul", "gear_fire", "sha1")) > 0
        checks["restore_decoded_on_k1"] = restore_kernels["gf_matmul"] > 0
    return {"phase": "train", "card": card, "arch": cfg.name,
            "mesh": mesh, "leaves_by_placement": placed,
            "restore_host_leaf_peak_bytes": host.peak,
            "restore_host_leaf_largest_bytes": host.largest,
            "restore_whole_tree_host_copy": whole_tree_copy,
            "layers": cfg.n_layers, "full_layers": full_layers,
            "params": cfg.param_count(), "batch": B, "seq": S,
            "moment_dtype": "int8", "deterministic": "steps 3 on, rerun",
            "steps_1_2_and_save_seconds": run_s,
            "step_seconds": step_s, "step_seconds_median": med,
            "tokens_per_s": B * S / med, "max_memory_allocated": peak,
            "losses": losses, "state_bytes": nbytes,
            "save_seconds": save_s, "save_bytes": ckpt.get("ckpt_bytes"),
            "save_bytes_after_dedup": ckpt.get("ckpt_bytes_after_dedup"),
            "save_launches": dataclasses.asdict(save_launches),
            "save_kernels": save_kernels,
            "killed_nodes_per_cluster": list(KILLED_NODES),
            "restore_seconds": restore_s, "restored_step": start,
            "restore_launches": dataclasses.asdict(restore_launches),
            "restore_kernels": restore_kernels,
            "restore_differs": restore_diff,
            "rerun_step_seconds": rerun_s,
            "restart_seconds": restore_s + rerun_s,
            "rerun_differs": rerun_diff, "loss3": loss3,
            "loss3_again": loss3_again, "checks": checks,
            "ok": all(checks.values())}


def checkpoint_round_trip(params, fused_engine, sync, on_card: bool
                          ) -> tuple[object, dict, dict]:
    """Save ``params`` through ``SEARSCheckpointManager`` on the fused
    engine, kill ``KILLED_NODES`` of every cluster, restore.  Returns the
    restored copy, the line's save / restore fields and the checks (K2
    and K5 on the save, K1 on the restore, on the card; the restore
    bit for bit the save)."""
    import torch
    from repro_torch.checkpoint import SEARSCheckpointManager
    from repro_torch.kernels.launches import KERNELS, LAUNCHES, reset_kernels
    from repro_torch.tree import flatten_with_path

    nbytes = sum(t.numel() * t.element_size()
                 for _, t in flatten_with_path(params))
    mgr = SEARSCheckpointManager(engine=fused_engine)
    reset_kernels()
    before = LAUNCHES.snapshot()
    t0 = time.perf_counter()
    saved = mgr.save(1, params)
    save_s = time.perf_counter() - t0
    save_launches = LAUNCHES.delta(before)
    save_kernels = dict(KERNELS)
    for cluster in mgr.store.clusters:
        cluster.kill_nodes(list(KILLED_NODES))
    reset_kernels()
    before = LAUNCHES.snapshot()
    t0 = time.perf_counter()
    restored = mgr.restore(params)
    sync()
    restore_s = time.perf_counter() - t0
    restore_launches = LAUNCHES.delta(before)
    restore_kernels = dict(KERNELS)
    differs = ["/".join(path) for (path, a), (_, b) in zip(
        flatten_with_path(restored), flatten_with_path(params))
        if a.dtype != b.dtype or a.device != b.device
        or not torch.equal(a, b)]
    # free the store's pieces now, not in a collection inside the serve
    # timing
    del mgr
    gc.collect()
    fields = dict(
        save_seconds=save_s, save_bytes=saved["bytes"],
        save_mib_per_s=saved["bytes"] / 2**20 / save_s,
        save_launches=dataclasses.asdict(save_launches),
        save_kernels=save_kernels,
        killed_nodes_per_cluster=list(KILLED_NODES),
        restore_seconds=restore_s,
        restore_mib_per_s=saved["bytes"] / 2**20 / restore_s,
        restore_launches=dataclasses.asdict(restore_launches),
        restore_kernels=restore_kernels, restore_differs=differs)
    checks = {"saved_all_bytes": saved["bytes"] == nbytes,
              "restore_identical": not differs}
    if on_card:
        checks["save_launched_k2_k5"] = min(
            save_kernels[k] for k in ("gear_fire", "fused_ingest")) > 0
        checks["restore_decoded_on_k1"] = restore_kernels["gf_matmul"] > 0
    return restored, fields, checks


def shared_expert_leaf(n_experts: int):
    """A per-leaf init, ``leaf(gen, path, spec)``, that draws each stacked
    routed-expert leaf of a hybrid, (G, 4, E, D, F), once at (G, 1, E,
    D, F) by the reference's rule and expands it over the group's MoE
    layers: a stride-0 view, so every shape and every FLOP stays and the
    four layers share one draw of expert weights.  Other leaves are made
    by the rule itself."""
    from repro_torch.models import layers as L

    def leaf(gen, path, spec):
        if path[-1] in ("wg", "wu", "wd") and \
                spec.shape[-3:-2] == (n_experts,):
            one = L.init_leaf(gen, path, L.Spec(
                spec.shape[:1] + (1,) + spec.shape[2:], spec.dtype))
            return one.expand(spec.shape)
        return L.init_leaf(gen, path, spec)
    return leaf


def cache_bytes(cache: dict) -> dict:
    """A cache's bytes by kind: slot, state and cross caches."""
    out = {}
    for kind, names in (("slot", SLOT_CACHES), ("state", STATE_CACHES),
                        ("cross", CROSS_CACHES)):
        out[kind] = sum(t.numel() * t.element_size()
                        for name, t in cache.items() if name in names)
    return out


def mesh_serve(cfg, params, batch: dict, res: dict, n: int, sync) -> dict:
    """Serve ``batch`` again through the step builders
    (``build_prefill_step`` / ``build_decode_step``) on the host mesh,
    with a ``ShapeConfig`` of ``seq_len`` prompt + n and the batch's
    rows, to n greedy tokens: the weights wrapped as DTensors without a
    copy, prefill, then n - 1 decode steps on the cache in place.  The
    tokens, the last logits and every cache leaf are held bit for bit
    against the plain serve's ``res``; each prefill output's shape
    against ``api.cache_specs``, but where the reference's builders give
    another: a VLM's prefill cache has ``max(seq_len, prompt +
    patches)`` slots (``cache_len=S`` counts no patches; it is copied
    into a zeroed cache of the spec's slots before decode), and an
    encoder-decoder's cross caches are as long as its frames."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import MeshRules, shard_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import prefix_len
    from repro_torch.models import api
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.tree import flatten_with_path

    device = batch["tokens"].device
    rules = MeshRules(make_host_mesh(device.type))
    B, P = batch["tokens"].shape
    Pt = prefix_len(batch)
    shape = ShapeConfig("mesh_serve", P + n, B, "decode")
    prefill, (param_sh, batch_sh), _, _ = build_prefill_step(cfg, rules,
                                                            shape)
    decode, in_sh, _, cache_shapes = build_decode_step(cfg, rules, shape)
    dparams = shard_tree(params, param_sh)
    no_copy = all(
        d.to_local().untyped_storage().data_ptr()
        == t.untyped_storage().data_ptr() for (_, d), (_, t) in zip(
            flatten_with_path(dparams), flatten_with_path(params)))
    t0 = time.perf_counter()
    logits, cache = prefill(dparams, shard_tree(batch, batch_sh))
    tok = torch.argmax(logits.to_local(), -1)[:, None]
    shapes, wrong = {}, []
    local = {}
    for name, t in cache.items():
        spec = tuple(cache_shapes[name].shape)
        expect = list(spec)
        if cfg.n_patches and name in ("k", "v"):
            expect[2] = max(shape.seq_len, Pt)
        if name in ("ek", "ev"):
            expect[2] = batch["frames"].shape[1]
        shapes[name] = {"prefill": list(t.shape), "spec": list(spec)}
        if tuple(t.shape) != tuple(expect):
            wrong.append(name)
        t = t.to_local()
        if name in ("k", "v") and tuple(t.shape) != spec:  # the VLM's
            t = torch.zeros(spec, dtype=t.dtype, device=t.device
                            ).index_copy_(2, torch.arange(
                                t.shape[2], device=t.device), t)
        local[name] = t
    del cache
    sync()
    prefill_s = time.perf_counter() - t0
    cache = shard_tree(local, in_sh[1])
    del local
    out = [tok]
    t0 = time.perf_counter()
    for i in range(n - 1):
        logits, cache = decode(dparams, cache, shard_tree(tok, in_sh[2]),
                               Pt + i)
        tok = torch.argmax(logits.to_local(), -1)[:, None]
        out.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    differ = [name for name in sorted(cache) if not torch.equal(
        cache[name].to_local(), res["cache"][name])]
    line = {"mesh": list(rules.mesh.shape), "seq_len": shape.seq_len,
            "batch": B, "cache_shapes": shapes, "shapes_as_reference":
            not wrong, "wrong_shapes": wrong, "no_weight_copy": no_copy,
            "tokens_identical": torch.equal(torch.cat(out, dim=1),
                                            res["tokens"]),
            "logits_identical": torch.equal(logits.to_local(),
                                            res["logits"]),
            "cache_identical": not differ, "cache_differs": differ,
            "prefill_seconds": prefill_s, "decode_seconds": decode_s,
            "decode_tok_per_s": B * (n - 1) / decode_s}
    line["ok"] = all(line[k] for k in (
        "shapes_as_reference", "no_weight_copy", "tokens_identical",
        "logits_identical", "cache_identical"))
    del cache, dparams
    return line


def configs_phase(phase: str, configs, sizes: Sizes, device, fused_engine,
                  sync, card: str = "") -> list[dict]:
    """The configs of ``configs`` ((arch, layers kept) pairs) at full
    width, one at a time on a freed card: weights from seed 0 (the first
    config's through a SEARS checkpoint restored with n-k nodes of every
    cluster dead, bit for bit; a config of ``SHARED_EXPERT_DRAW`` draws
    its routed experts once per group, ``shared_expert_leaf``), then the
    serve check on each of ``SERVE_SEEDS``.  A VLM config prefills
    seeded patch embeddings before each prompt, an encoder-decoder
    encodes as many seeded frame embeddings as the prompt has tokens.
    An MoE config serves at its published capacity factor (timed; the
    share of routed slots dropped at prefill and at decode), and runs
    the check at a capacity that drops nothing, ``capacity_factor = E /
    k``: a decode group holds the B new tokens alone, so under drops
    decode and prefill differ by design.  Returns one line per config,
    ``ok`` false if a check failed."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import prompts, serve
    from repro_torch.models import api
    from repro_torch.tree import flatten_with_path, map_with_path

    on_card = device.type == "cuda"
    B, P, n = sizes.serve_batch, sizes.prompt_len, sizes.gen_tokens
    lines = []
    for arch, depth in configs:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        full_layers = cfg.n_layers
        if sizes.reduced:
            cfg = cfg.reduced()
        elif depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        model = api.get_model(cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        shared = arch in SHARED_EXPERT_DRAW
        t0 = time.perf_counter()
        params = model._zero_pads(map_with_path(functools.partial(
            shared_expert_leaf(cfg.n_experts), gen), model.param_shapes())) \
            if shared else model.init(gen)
        sync()
        init_s = time.perf_counter() - t0
        leaves = flatten_with_path(params)
        nbytes = sum(t.numel() * t.element_size() for _, t in leaves)
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for _, t in leaves}
        heads = bool(cfg.n_heads)
        windows = model._windows() if hasattr(model, "_windows") else []
        line = {"phase": phase, "card": card, "arch": cfg.name,
                "family": cfg.family,
                "layers": cfg.n_layers, "full_layers": full_layers,
                "depth_cut": None if cfg.n_layers == full_layers
                else f"{full_layers} -> {cfg.n_layers} layers",
                "d_model": cfg.d_model,
                # an attention-free model has no heads and no windows
                "heads": cfg.n_heads if heads else None,
                "stored_heads": cfg.h_store if heads else None,
                "kv_heads": cfg.n_kv_heads if heads else None,
                "head_dim": cfg.head_dim if heads else None,
                "window": cfg.sliding_window if heads else None,
                "layers_past_window": sum(0 < w < P + n for w in windows)
                if heads else None,
                "params": cfg.param_count(),
                "stored_params": sum(t.numel() for _, t in leaves),
                "stored_bytes": nbytes,
                "resident_bytes": sum(storages.values()),
                "leaves": len(leaves),
                "init_seconds": init_s,
                "init_peak_bytes": torch.cuda.max_memory_allocated()
                if on_card else None}
        line["shared_expert_draw"] = (
            "one draw of each routed-expert leaf per group, expanded "
            "over the group's MoE layers (stride 0)" if shared else None)
        if cfg.n_experts:
            line.update(active_params=cfg.active_param_count(),
                        experts=cfg.n_experts,
                        experts_per_token=cfg.experts_per_token,
                        shared_experts=cfg.n_shared_experts,
                        moe_group_size=cfg.moe_group_size,
                        capacity_factor=cfg.capacity_factor,
                        check_capacity_factor=cfg.n_experts
                        / cfg.experts_per_token)
        if cfg.use_mla:
            line.update(mla={"kv_lora_rank": cfg.kv_lora_rank,
                             "q_lora_rank": cfg.q_lora_rank,
                             "qk_head_dim": cfg.qk_nope_head_dim
                             + cfg.qk_rope_head_dim,
                             "v_head_dim": cfg.v_head_dim})
        if cfg.ssm_state:
            line.update(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                        dt_rank=cfg.dt_rank, ssm_conv=cfg.ssm_conv,
                        ssm_compute_dtype=cfg.ssm_compute_dtype,
                        attn_every=cfg.attn_every or None)
        if cfg.n_patches:
            line["patches"] = cfg.n_patches
        if cfg.family == "encdec":
            line.update(encoder_layers=cfg.n_encoder_layers, frames=P)
        del leaves, storages
        checks = {}
        if arch == configs[0][0]:
            params, fields, ckpt_checks = checkpoint_round_trip(
                params, fused_engine, sync, on_card)
            line.update(fields)
            checks.update(ckpt_checks)
        # a config's own gates stand on its full-size readings; a
        # reduced rehearsal keeps the base gates
        cache_tol, logit_tol = (SERVE_CACHE_TOL, SERVE_LOGIT_TOL) \
            if sizes.reduced else SERVE_GATES.get(
                arch, (SERVE_CACHE_TOL, SERVE_LOGIT_TOL))
        check_model = model
        if cfg.n_experts:
            check_model = api.get_model(dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token))
        serve_checks, times, drops, first = [], [], [], None
        with torch.no_grad():
            for seed in SERVE_SEEDS:
                batch = prompts(cfg, B, P, seed, device)
                if cfg.n_experts:  # timed at the published capacity
                    model.moe_log = []
                    try:
                        res = serve(model, params, batch, n, device)
                        drops.append(drop_shares(model.moe_log, n))
                    finally:
                        model.moe_log = None
                r = decode_vs_prefill(check_model, params, batch, n, device,
                                      sync, cache_tol, logit_tol)
                if not cfg.n_experts:
                    res = r["res"]
                r["check"]["seed"] = seed
                serve_checks.append(r["check"])
                times.append((res["prefill_s"], res["decode_s"]))
                if first is None:
                    first = res["tokens"]
                    line["cache_bytes"] = cache_bytes(res["cache"])
                    line["mesh_serve"] = mesh_serve(cfg, params, batch, res,
                                                    n, sync)
                del r, res
        prefill_s = statistics.median(t[0] for t in times)
        decode_s = statistics.median(t[1] for t in times)
        checks["tokens_in_vocab"] = bool(
            first.shape == (B, n)
            and ((first >= 0) & (first < cfg.vocab_size)).all())
        checks["decode_vs_prefill"] = all(c["ok"] for c in serve_checks)
        checks["mesh_serve_identical"] = line["mesh_serve"]["ok"]
        if drops:
            line["dropped_share"] = drops
        line.update(
            batch=B, prompt_len=P, tokens=n,
            prefill_seconds=[t[0] for t in times],
            decode_seconds=[t[1] for t in times],
            prefill_tok_per_s=B * P / prefill_s,
            decode_tok_per_s=B * (n - 1) / decode_s,
            max_memory_allocated=torch.cuda.max_memory_allocated()
            if on_card else None,
            cache_tol=cache_tol, logit_tol=logit_tol,
            decode_vs_prefill=serve_checks,
            first_tokens=first[:, :8].tolist(), checks=checks,
            ok=all(checks.values()))
        lines.append(line)
        del model, check_model, params, first
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return lines


def dense_configs_phase(sizes: Sizes, device, fused_engine, sync,
                        card: str = "") -> list[dict]:
    """``configs_phase`` over ``DENSE_CONFIGS``."""
    return configs_phase("dense_configs", DENSE_CONFIGS, sizes, device,
                         fused_engine, sync, card)


def moe_mla_configs_phase(sizes: Sizes, device, fused_engine, sync,
                          card: str = "") -> list[dict]:
    """``configs_phase`` over ``MOE_MLA_CONFIGS``."""
    return configs_phase("moe_mla_configs", MOE_MLA_CONFIGS, sizes, device,
                         fused_engine, sync, card)


def ssm_encdec_configs_phase(sizes: Sizes, device, fused_engine, sync,
                             card: str = "") -> list[dict]:
    """``configs_phase`` over ``SSM_ENCDEC_CONFIGS``."""
    return configs_phase("ssm_encdec_configs", SSM_ENCDEC_CONFIGS, sizes,
                         device, fused_engine, sync, card)


def live_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """Query-key pairs the masks leave live (queries the last S of T)."""
    import numpy as np
    qp = np.arange(T - S, T, dtype=np.int64)
    hi = qp if causal else np.full(S, T - 1)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros(S)
    return int(np.maximum(hi - lo + 1, 0).sum())


def round_up_1sd(x: float) -> float:
    """x rounded up to one significant digit (0.00196 -> 0.002)."""
    if x <= 0:
        return 0.0
    e = math.floor(math.log10(x))
    return math.ceil(round(x / 10.0 ** e, 9)) * 10.0 ** e


def ptxas_by_entry(log: str) -> dict:
    """Registers and spill bytes of every kernel in the ``ptxas -v`` build
    log: {mangled entry name: {"registers", "spill_stores",
    "spill_loads"}}."""
    out: dict = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def ptxas_usage(log: str) -> dict:
    """K6's kernels from ``ptxas_by_entry``: {"bf16" | "fp32": {hd: {...}}}."""
    kinds = {"flash_wgmma_kernel": "bf16", "flash_fma_kernel": "fp32"}
    out: dict = {}
    for fn, use in ptxas_by_entry(log).items():
        k = re.search(r"(flash_[a-z0-9]+_kernel)ILi(\d+)E", fn)
        if k and k.group(1) in kinds:
            out.setdefault(kinds[k.group(1)], {})[k.group(2)] = use
    return out


def exp_peak(device) -> float:
    """ex2 a second: MUFU_PER_SM_CLOCK x SMs x the maximum SM clock
    (``int_peak``'s; the data sheet's without a card)."""
    p = int_peak(device)
    return MUFU_PER_SM_CLOCK * p["sms"] * p["max_sm_mhz"] * 1e6


def flash_terms(q, k, v, causal: bool, window: int,
                exp_per_s: float) -> dict:
    """K6's bound terms in ms: ``bytes``, each input read once and the
    output written once at HBM's rate; ``products``, 4 hd operations a
    live pair at the peak of q's dtype (bf16: the tensor cores; fp32: the
    CUDA cores); ``exp``, one ex2 a live pair at ``exp_per_s``."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    size = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * size
    pairs = float(B * H * live_pairs(S, T, causal, window))
    peak = PEAK_BF16_TC_PER_S if size == 2 else PEAK_OPS_PER_S
    return {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
            "products": 4.0 * hd * pairs / peak * 1e3,
            "exp": pairs / exp_per_s * 1e3}


def flash_phase(sizes: Sizes, device, layer0, reps: int
                ) -> tuple[dict, list[dict]]:
    """K6 against its plain version and the model's attention at every
    shape, the bf16 kernel under the output-scaled gate, the fp32 kernel
    at 2e-5; timed at the long shape (bf16 and fp32), at layer 0's, and
    at the other configs' layers and hd 32's long shape.  Returns the
    line and the K6 rows (bf16, fp32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.launches import KERNELS, reset_kernels
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cuda = device.type == "cuda"
    exp_per_s = exp_peak(device)

    def rand(rng, B, S, T, H, KV, hd, dtype):
        return tuple(torch.from_numpy(rng.standard_normal(
            shp, dtype=np.float32)).to(device, dtype)
            for shp in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))

    def cast(qkv, dtype):
        return tuple(x.to(dtype) for x in qkv)

    # (name, (q, k, v), causal, window, seed): every bf16 shape on each
    # of FLASH_SEEDS (layer 0's on its one prompt), the fp32 copies once
    Ls = sizes.long_seq
    Bs, Ps = sizes.serve_batch, sizes.prompt_len
    cases = [("serve_layer0", layer0, True, 0, 0)]
    fp32_cases = [("serve_layer0_fp32", cast(layer0, f32), True, 0, 0)]
    for seed in FLASH_SEEDS:
        rng = np.random.default_rng(seed)
        long = rand(rng, 1, Ls, Ls, 32, 8, 64, bf16)
        small = [("window", rand(rng, 1, 512, 512, 32, 8, 64, f32), True,
                  128),
                 ("non_causal", rand(rng, 1, 256, 256, 32, 8, 64, f32),
                  False, 0),
                 ("hd128", rand(rng, 1, 300, 300, 4, 2, 128, f32), True, 0)]
        cases.append(("long", long, True, 0, seed))
        cases += [(f"{nm}_bf16", cast(x, bf16), c, w, seed)
                  for nm, x, c, w in small]
        hd256 = rand(rng, 2, 256, 768, 8, 1, 256, bf16)
        cases.append(("hd256", hd256, True, 0, seed))
        # more configs' attention at the serve batch and prompt
        layers = {name: (rand(rng, Bs, Ps + extra, Ps + extra, H, KV, hd,
                              bf16), window)
                  for name, H, KV, hd, window, extra in LAYER_SHAPES}
        cases += [(name, qkv, True, window, seed)
                  for name, (qkv, window) in layers.items()]
        # the reference's hd-32 shapes, a routed hd, hd 32 at the long
        # shape's layout
        hds = [(nm, rand(rng, B, S, T, H, KV, hd, f32), c, w)
               for nm, B, S, T, H, KV, hd, c, w in HD_SHAPES]
        long32 = rand(rng, 1, Ls, Ls, 32, 8, 32, bf16)
        cases += [(f"{nm}_bf16", cast(x, bf16), c, w, seed)
                  for nm, x, c, w in hds]
        cases.append(("long_hd32", long32, True, 0, seed))
        if seed == FLASH_SEEDS[0]:
            layers0 = layers
            long0, long32_0 = long, long32
            fp32_cases.append(("long_fp32", cast(long, f32), True, 0, seed))
            fp32_cases += [(nm, x, c, w, seed) for nm, x, c, w in small]
            fp32_cases.append(("hd256_fp32", cast(hd256, f32), True, 0,
                               seed))
            fp32_cases += [(nm, x, c, w, seed) for nm, x, c, w in hds]
            fp32_cases.append(("phi3_vision_layer_fp32", cast(
                layers["phi3_vision_layer"][0], f32), True, 0, seed))
            fp32_cases.append(("long_hd32_fp32", cast(long32, f32), True,
                               0, seed))
    # the fp32 kernel's other head dims, timed: by-shape key -> case
    fp32_named = {c[0]: c[1] for c in fp32_cases}
    fp32_timed = {"serve_layer0_fp32": fp32_named["serve_layer0_fp32"],
                  "hd128": fp32_named["hd128"],
                  "hd256": fp32_named["hd256_fp32"],
                  "phi3_vision_layer_fp32":
                      fp32_named["phi3_vision_layer_fp32"],
                  "long_hd32_fp32": fp32_named["long_hd32_fp32"]}
    cases += fp32_cases
    # the shifted-mask control runs at these shapes (both dtypes)
    controlled = {"serve_layer0", "long", "phi3_vision_layer",
                  "phi3_vision_layer_fp32", "long_hd32", "long_hd32_fp32"}
    controlled |= {f"{nm}_bf16" for nm, *_ in HD_SHAPES}
    controlled |= {nm for nm, *_ in HD_SHAPES}

    reset_kernels()
    shapes, failed = [], []
    for name, (q, k, v), causal, window, seed in cases:
        B, S, H, hd = q.shape
        T = k.shape[1]
        dtype = str(q.dtype).split(".")[1]
        kernel = "flash_attn" if q.dtype == bf16 else "flash_attn_fp32"
        before = dict(KERNELS)
        with torch.no_grad():
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            launched = {n: KERNELS[n] - before[n]
                        for n in ("flash_attn", "flash_attn_fp32")}
            plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window)
            model = L.attention(q, k, v, q_pos=torch.arange(T - S, T,
                                                            device=device),
                                kv_pos=torch.arange(T, device=device),
                                window=window, causal=causal)
        row = {"name": name, "seed": seed, "shape": [B, S, T, H, k.shape[2],
                                                     hd],
               "dtype": dtype, "causal": causal, "window": window,
               "launched": launched, "model_path": "direct" if S * T
               <= L.ATTN_DIRECT_LIMIT else "blockwise"}
        if cuda and (launched[kernel] < 1
                     or sum(launched.values()) != launched[kernel]):
            failed.append(f"{name}: launched {launched}, not {kernel}")
        if not bool(torch.isfinite(got).all()):
            failed.append(f"{name}: not finite")
        d = (got.float() - plain.float()).abs()
        row["max_abs_err_plain"] = float(d.max())
        if q.dtype == bf16:
            # |got - plain| <= c 2^-8 |plain| + a, element by element
            pa = plain.float().abs()
            gate = FLASH_BF16_C * 2.0 ** -8 * pa + FLASH_BF16_A
            small = pa < FLASH_GATE_SPLIT
            row["a_read"] = float(d[small].max()) if small.any() else 0.0
            row["c_read"] = (float((d[~small] / (2.0 ** -8 * pa[~small]))
                                   .max()) if (~small).any() else 0.0)
            row["gate_use"] = float((d / gate).max())
            row["within_gate_plain"] = row["gate_use"] <= 1.0
            if not row["within_gate_plain"]:
                failed.append(f"{name} (seed {seed}) vs plain")
        else:
            tol = FLASH_TOL[dtype]
            gate = tol + tol * plain.float().abs()
            row["gate_use"] = float((d / gate).max())
            row["within_tol_plain"] = bool((d <= gate).all())
            if not row["within_tol_plain"]:
                failed.append(f"{name} vs plain")
        if name in controlled:
            # the control: the mask one key off (keys and values shifted
            # by one slot; without a mask or a window, where attention
            # over every key is blind to their order, the keys alone: each
            # key paired with the next value) must read above the gate
            masked = causal or window > 0
            with torch.no_grad():
                off = ref.flash_attention_ref(
                    q, k.roll(-1, 1), v.roll(-1, 1) if masked else v,
                    causal=causal, window=window)
            row["control_gate_use"] = float(
                ((off.float() - plain.float()).abs() / gate).max())
            if row["control_gate_use"] <= 1.0:
                failed.append(f"{name}: the shifted-mask control passes "
                              f"the gate")
            del off
        # against the model's attention: the reference's tolerances
        tol = FLASH_TOL[dtype]
        dm = (got.float() - model.float()).abs()
        row["max_abs_err_model"] = float(dm.max())
        row["within_tol_model"] = bool(
            (dm <= tol + tol * model.float().abs()).all())
        if not row["within_tol_model"]:
            failed.append(f"{name} (seed {seed}) vs model")
        shapes.append(row)
        del got, plain, model, d, dm
    launches = {n: KERNELS[n] for n in ("flash_attn", "flash_attn_fp32")}
    if failed:
        raise AssertionError(f"flash kernel outside its gate: {failed}")
    bf16_rows = [r for r in shapes if r["dtype"] == "bfloat16"]
    c_read = max(r["c_read"] for r in bf16_rows)
    a_read = max(r["a_read"] for r in bf16_rows)
    readings = {"c_read": c_read, "a_read": a_read,
                "c_by_rule": round_up_1sd(2 * c_read),
                "a_by_rule": round_up_1sd(2 * a_read)}

    # time K6 beside SDPA (the library's call, never the port's) at the
    # long shape in bf16 and fp32, and at layer 0's shape
    run = timer(device)

    def sdpa(q, k, v, window: int = 0) -> tuple[float, float | None]:
        """SDPA's per-call and device-only milliseconds (causal; with a
        window, the causal window as a boolean mask)."""
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        S, T = q.shape[1], k.shape[1]
        kw = {"is_causal": True} if not window else {
            "attn_mask": L._mask(torch.arange(T - S, T, device=device),
                                 torch.arange(T, device=device), window,
                                 True)}

        def call():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **kw)
        return run(call, reps), device_time([call], device)

    (q, k, v) = long0
    B, S, H, hd = q.shape
    T = k.shape[1]
    q32, k32, v32 = cast(long0, f32)
    with torch.no_grad():
        ms = run(lambda: ops.flash_attention(q, k, v), reps)
        plain_ms = run(lambda: ref.flash_attention_ref(q, k, v), 3, 1)
        model_ms = run(lambda: L.attention(
            q, k, v, q_pos=torch.arange(T - S, T, device=device),
            kv_pos=torch.arange(T, device=device)), 3, 1)
        fp32_ms = run(lambda: ops.flash_attention(q32, k32, v32), reps)
        fp32_plain_ms = run(lambda: ref.flash_attention_ref(q32, k32, v32),
                            3, 1)
        dev_ms = device_time([lambda: ops.flash_attention(q, k, v)], device)
        fp32_dev_ms = device_time([lambda: ops.flash_attention(q32, k32,
                                                               v32)], device)
        lib = fp32_lib = (None, None)
        if cuda:
            lib = sdpa(q, k, v)
            fp32_lib = sdpa(q32, k32, v32)

        # layer 0's shape, the other configs' layers and hd 32's long
        # shape: per call and on the device alone, beside the plain
        # version and SDPA; each with its bound and the bound's term
        def timed(qkv, window: int = 0) -> dict:
            def call():
                return ops.flash_attention(*qkv, window=window)
            terms = flash_terms(*qkv, True, window, exp_per_s)
            term = max(terms, key=terms.get)
            t_lib = sdpa(*qkv, window=window) if cuda else (None, None)
            return {"ms": run(call, reps),
                    "device_ms": device_time([call], device),
                    "plain_ms": run(lambda: ref.flash_attention_ref(
                        *qkv, window=window), 3, 1),
                    "library_ms": t_lib[0], "library_device_ms": t_lib[1],
                    "bound_ms": terms[term], "bound_term": term}
        by_shape = {"serve_layer0": timed(layer0)}
        for name, (qkv, window) in layers0.items():
            by_shape[name] = timed(qkv, window)
        by_shape["long_hd32"] = timed(long32_0)
        fp32_by_shape = {name: timed(qkv)
                         for name, qkv in fp32_timed.items()}
    del q32, k32, v32, layers0, long32_0, fp32_named, fp32_timed
    pairs = live_pairs(S, T, True, 0)
    ops_n = 4.0 * B * H * hd * pairs
    usage = ptxas_usage(_build.BUILD_INFO["log"])
    long_row = next(r for r in shapes if r["name"] == "long")
    long32_row = next(r for r in shapes if r["name"] == "long_fp32")
    rows = []
    for name, dtype_bytes, peak, row, t_ms, t_dev, t_plain, t_lib in (
            ("flash_attn", 2, PEAK_BF16_TC_PER_S, long_row, ms, dev_ms,
             plain_ms, lib),
            ("flash_attn_fp32", 4, PEAK_OPS_PER_S, long32_row, fp32_ms,
             fp32_dev_ms, fp32_plain_ms, fp32_lib)):
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * dtype_bytes
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        # products or the exponent, whichever is larger (the products at
        # hd 64 in both dtypes)
        t_ops = max(ops_n / peak, B * H * pairs / exp_per_s) * 1e3
        bms = max(t_bytes, t_ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:37",
            "launches": launches[name], "max_abs_err": row[
                "max_abs_err_plain"],
            "ms": t_ms, "device_ms": t_dev, "plain_ms": t_plain,
            "bound_ms": bms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t_lib[0], "library_device_ms": t_lib[1],
            "tflop_per_s": ops_n / t_ms / 1e9,
            "share_of_bound": bms / t_ms,
            "ptxas": usage.get("bf16" if name == "flash_attn" else "fp32"),
            "shape": row["shape"], "bytes": nbytes, "ops": ops_n})
    rows[0].update(
        fp32_ms=fp32_ms, model_attention_ms=model_ms,
        tol={"c": FLASH_BF16_C, "a": FLASH_BF16_A},
        shape_by_name={name: [Bs, Ps + extra, Ps + extra, H, KV, hd, window]
                       for name, H, KV, hd, window, extra in LAYER_SHAPES})
    rows[1].update(tol=FLASH_TOL["float32"])
    for row, timings in ((rows[0], by_shape), (rows[1], fp32_by_shape)):
        for key in BY_SHAPE_KEYS:
            row[f"{key}_by_shape"] = {name: t[key]
                                      for name, t in timings.items()}
    line = {"phase": "flash", "launches": launches, "shapes": shapes,
            "bf16_gate": {"c": FLASH_BF16_C, "a": FLASH_BF16_A,
                          "split": FLASH_GATE_SPLIT},
            "bf16_readings": readings,
            "long_ms": ms, "long_device_ms": dev_ms,
            "long_library_ms": lib[0], "long_library_device_ms": lib[1],
            "long_tflop_per_s": ops_n / ms / 1e9,
            "long_fp32_ms": fp32_ms, "long_fp32_library_ms": fp32_lib[0],
            "serve_layer0_ms": by_shape["serve_layer0"]["ms"],
            "serve_layer0_device_ms": by_shape["serve_layer0"]["device_ms"],
            "serve_layer0_library_ms": by_shape["serve_layer0"]["library_ms"],
            "serve_layer0_library_device_ms":
                by_shape["serve_layer0"]["library_device_ms"],
            "long_plain_ms": plain_ms, "long_model_attention_ms": model_ms,
            "ptxas": usage}
    return line, rows


# ------------------------------------------------------------------ run --
def served_configs(sizes: Sizes) -> list[tuple[str, object]]:
    """(arch, config) of every served config, in the order the phases
    served them: llama3.2-1b (``serve``), then ``DENSE_CONFIGS``,
    ``MOE_MLA_CONFIGS`` and ``SSM_ENCDEC_CONFIGS`` with their depth cuts
    (reduced configs in a rehearsal)."""
    from repro_torch.configs.base import get_config
    out = []
    for arch, depth in (("llama32_1b", SERVE_LAYERS),) + DENSE_CONFIGS \
            + MOE_MLA_CONFIGS + SSM_ENCDEC_CONFIGS:
        cfg = get_config(arch)
        if sizes.reduced:
            cfg = cfg.reduced()
        elif depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        out.append((arch, cfg))
    return out


def roofline_phase(sizes: Sizes, device, serve_line: dict,
                   train_line: dict, config_lines: list[dict], sync,
                   card: str = "") -> list[dict]:
    """The roofline of every step the earlier phases timed: the train
    step, and each served config's prefill (the serve batch and prompt,
    plus its patches or frames) and one decode step at the cache length
    the serve reaches.  Each is counted by ``analysis.analyze_step`` on
    fake tensors of ``device`` at exactly the shapes the phase ran (off
    any timed window) and set beside the time the phase measured (the
    train step's median; a config's median prefill over the seeds, its
    median decode over the seeds per step; llama3.2-1b's seed-0 serve).
    The compute term may not exceed the measured time by over 5%
    (``ROOFLINE_COMPUTE_SLACK``): a step faster than its dots at the
    card's peak means the counter or the peak is wrong.  And llama3.2-1b's
    prefill, run once for real on ``device`` (weights from seed 0) under
    the counter, must count exactly the fake trace's FLOPs.  Returns one
    line per step, then a line with the checks."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import prefix_len, prompts
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import build_train_step
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    B, P, n = sizes.serve_batch, sizes.prompt_len, sizes.gen_tokens

    def fake(specs):
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device=device), specs)

    def line(step, cfg, kind, batch, seq, stats, measured, trace_s):
        roof = analysis.Roofline(
            stats.flops, stats.bytes_traffic, None, 1, analysis.model_flops(
                cfg, ShapeConfig(step, seq, batch, kind)))
        return {"phase": "roofline", "card": card, "step": step,
                "arch": cfg.name, "kind": kind, "layers": cfg.n_layers,
                "batch": batch, "seq": seq, "flops": stats.flops,
                "bytes": stats.bytes_traffic,
                "model_flops": roof.model_flops,
                "t_compute_s": roof.t_compute, "t_memory_s": roof.t_memory,
                "bottleneck": roof.bottleneck, "measured_s": measured,
                "bound_share": roof.t_bound / measured,
                "compute_share": roof.t_compute / measured,
                "mfu": roof.model_flops / (measured * analysis.PEAK_FLOPS),
                "trace_s": trace_s}

    # the train step, as the train phase built it
    cfg, step_cfg = train_config(sizes)
    Bt, St = sizes.train_batch, sizes.train_seq
    step = build_train_step(cfg, MeshRules(make_host_mesh(device.type)),
                            step_cfg)[0]
    t0 = time.perf_counter()
    with FakeTensorMode():
        shapes = step.model.param_shapes()
        stats = analysis.analyze_step(
            step, fake(shapes), fake(opt.state_shapes(shapes,
                                                      step_cfg.adamw)),
            {"tokens": torch.empty((Bt, St), dtype=torch.int32,
                                   device=device)})
    lines = [line(f"{cfg.name} train", cfg, "train", Bt, St, stats,
                  train_line["step_seconds_median"],
                  time.perf_counter() - t0)]

    # each served config: the serve's prefill, then its last decode step
    timed = [serve_line] + config_lines
    for (arch, cfg), timed_line in zip(served_configs(sizes), timed):
        model = api.get_model(cfg)
        prefill_s = statistics.median(
            numbers(timed_line["prefill_seconds"]))
        decode_s = statistics.median(
            numbers(timed_line["decode_seconds"])) / (n - 1)
        out = {}
        t0 = time.perf_counter()
        with FakeTensorMode(), torch.no_grad():
            params = fake(model.param_shapes())
            batch = prompts(cfg, B, P, 0, device)
            Pf = prefix_len(batch)
            pre = analysis.analyze_step(lambda: out.setdefault(
                "r", model.prefill(params, batch, cache_len=Pf + n)))
            logits, cache = out.pop("r")
            tok = torch.argmax(logits, -1)[:, None]
            dec = analysis.analyze_step(model.decode_step, params, cache,
                                        tok, Pf + n - 2)
        trace_s = time.perf_counter() - t0
        lines.append(line(f"{cfg.name} prefill", cfg, "prefill", B, Pf, pre,
                          prefill_s, trace_s))
        lines.append(line(f"{cfg.name} decode", cfg, "decode", B, Pf + n,
                          dec, decode_s, None))
        if arch == "llama32_1b":
            fake_prefill_flops = pre.flops
            real_cfg, real_batch = cfg, batch
        del params, batch, cache, logits, tok

    # llama3.2-1b's prefill once more, for real on the device
    model = api.get_model(real_cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    batch = prompts(real_cfg, B, P, 0, device)
    with torch.no_grad():
        real = analysis.analyze_step(model.prefill, params, batch,
                                     cache_len=prefix_len(batch) + n)
    sync()
    del model, params, batch, real_batch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = {
        "steps_counted": len(lines) == 1 + 2 * len(timed),
        "real_prefill_flops_equal_fake": real.flops == fake_prefill_flops,
        "compute_term_within_measured": all(
            r["compute_share"] <= ROOFLINE_COMPUTE_SLACK for r in lines)}
    lines.append({"phase": "roofline", "card": card, "steps": len(lines),
                  "real_prefill_flops": real.flops,
                  "fake_prefill_flops": fake_prefill_flops,
                  "real_prefill_bytes": real.bytes_traffic,
                  "max_compute_share": max(r["compute_share"]
                                           for r in lines),
                  "peak_flops": analysis.PEAK_FLOPS,
                  "hbm_bytes_per_s": analysis.HBM_BW,
                  "seconds": time.perf_counter() - t_phase,
                  "checks": checks, "ok": all(checks.values())})
    return lines


def numbers(x) -> list:
    """A measured time or a list of them, as a list."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def start_dryrun(device, out_dir: str) -> list:
    """The dry-run cells of the ``dryrun`` phase, started as subprocesses
    of ``python -m repro_torch.launch.dryrun`` (its fake 512-rank process
    group cannot share this process with the mesh phases' one-rank
    group): llama3.2-1b at ``train_4k``, and every arch at
    ``decode_32k``, each on both meshes, on fake ``device`` tensors.
    Returns [(name, Popen, start time)]."""
    from repro_torch.configs.base import ARCH_IDS
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for name, arch, shape in DRYRUN_RUNS:
        arch = ",".join(ARCH_IDS) if arch == "*" else arch
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--both-meshes",
               "--device", device.type, "--out",
               str(pathlib.Path(out_dir) / f"{name}.json")]
        procs.append((name, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), time.perf_counter()))
    return procs


def dryrun_phase(procs: list, out_dir: str, card: str = "") -> dict:
    """Wait for ``start_dryrun``'s subprocesses; one line with each cell's
    resident GB per chip, roofline terms and trace seconds.  ``ok`` is
    false if a subprocess failed or a cell is missing."""
    from repro_torch.configs.base import ARCH_IDS
    t0 = time.perf_counter()
    runs, cells = {}, []
    for name, proc, started in procs:
        try:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        runs[name] = {"returncode": proc.returncode,
                      "seconds": time.perf_counter() - started,
                      "last_line": out.strip().splitlines()[-1:],
                      "stderr_tail": err[-2000:] if proc.returncode else ""}
        path = pathlib.Path(out_dir) / f"{name}.json"
        if path.exists():
            cells += json.loads(path.read_text())["results"]
    keys = ("arch", "shape", "mesh", "chips", "resident_gb_per_chip",
            "flops", "bytes", "model_flops", "flops_per_chip",
            "bytes_per_chip", "coll_bytes", "coll_bytes_per_chip",
            "collectives", "n_collectives", "t_compute_s", "t_memory_s",
            "t_collective_s", "bottleneck", "useful_flops_ratio",
            "roofline_fraction", "trace_s", "lower_s")
    want = 2 * sum(len(ARCH_IDS) if arch == "*" else 1
                   for _, arch, _ in DRYRUN_RUNS)
    checks = {"exit_codes_0": all(r["returncode"] == 0
                                  for r in runs.values()),
              "cells": len(cells) == want,
              # one rank's sharded step: its collectives, in every cell
              "collective_term_known": all(
                  c["t_collective_s"] is not None and c["n_collectives"] > 0
                  for c in cells)}
    return {"phase": "dryrun", "card": card, "runs": runs,
            "cells": [{k: c[k] for k in keys} for c in cells],
            "wait_seconds": time.perf_counter() - t0, "checks": checks,
            "ok": all(checks.values())}


# ------------------------------------------------------------ mesh_ranks --
def mesh_config(arch: str, depth, sizes: Sizes):
    """A ``MESH_RANK_CONFIGS`` config at ``depth`` layers (all where
    None), or reduced."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if sizes.reduced:
        return cfg.reduced()
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def whole(t):
    """A DTensor as the whole tensor on every rank, through one
    all-reduce of this rank's shard placed into zeros: the gloo group of
    two ranks on one card has no working all-gather of CUDA tensors
    (``full_tensor`` calls one).  Where the tensor is replicated over a
    mesh dim, only that dim's first rank adds its shard."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    mesh, local = t.device_mesh, t.to_local()
    coord = mesh.get_coordinate()
    idx, add = [slice(None)] * t.ndim, True
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            start = coord[i] * -(-t.shape[p.dim] // mesh.size(i))
            idx[p.dim] = slice(start, start + local.shape[p.dim])
        elif coord[i]:
            add = False
    buf = torch.zeros(t.shape, dtype=local.dtype, device=local.device)
    if add:
        buf[tuple(idx)] = local
    dist.all_reduce(buf)
    return buf


def counted(fn, *args):
    """``fn(*args)`` and its collectives (``analysis.analyze_step``):
    operand bytes by kind, and their number."""
    from repro_torch.launch import analysis
    res = []
    st = analysis.analyze_step(lambda: res.append(fn(*args)))
    return res[0], {"bytes_by_kind": {k: b for k, b in st.coll_by_kind.items()
                                      if b},
                    "n": st.n_collectives, "bytes": st.coll_bytes}


def rank_params(model, psh, device, shared: bool = False):
    """This rank's seed-0 weights of ``model``, leaf by leaf: each leaf
    drawn whole by the reference's rule (with ``shared``, the routed
    experts once a group, ``shared_expert_leaf``) in the
    mesh of one's order, so the bits are its; only this rank's shard is
    kept (a routed-expert leaf drawn once a group stays one draw,
    expanded), as a DTensor on its placements of ``psh``.  A config with
    TP head padding (whisper-tiny) is drawn whole and laid out by
    ``shard_tree`` (its pad slots are zeroed across leaves)."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models import layers as L
    from repro_torch.tree import at, map_with_path

    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(0)
    if cfg.n_heads and L.head_mask(cfg) is not None:
        return shard_tree(model.init(gen), psh)
    leaf_init = shared_expert_leaf(cfg.n_experts) if shared \
        else L.init_leaf

    def one(path, spec):
        sh = at(psh, path)
        coord = sh.mesh.get_coordinate()

        def cut(t):  # this rank's shard of a whole leaf: a view
            for i, p in enumerate(sh.placements):
                if isinstance(p, Shard):
                    n = t.shape[p.dim]
                    step = -(-n // sh.mesh.size(i))
                    start = min(coord[i] * step, n)
                    t = t.narrow(p.dim, start, min(start + step, n) - start)
            return t
        t = leaf_init(gen, path, spec)
        if t.dim() > 1 and t.stride(1) == 0:  # one draw, expanded
            local = cut(t[:, :1]).clone().expand(cut(t).shape)
        else:
            local = cut(t).clone()
        del t
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False)
    return map_with_path(one, model.param_shapes())


@contextlib.contextmanager
def rank_replay(served: list | None):
    """Within the block, route a rank's MoE layers as the mesh of one
    routed them: the k-th call of ``layers.route_groups`` (a prefill's
    MoE layers, then each decode step's) takes the top-k sets of
    ``served[k]`` (the mesh of one's log entry, (B, S, K) in global
    token order) for the rows of its groups, from their first token's
    global index (the pad rows of a group keep their own).  Yields a
    dict: ``flips``, the (token, MoE layer) pairs of the rows this rank
    routed whose own top-k set was another, with the router margins
    there (``margins``); ``calls``, set to 0 to replay from the first
    entry again.  Without a log (no MoE) it does nothing."""
    from repro_torch.models import layers as L

    state = {"calls": 0, "flips": 0, "margins": []}
    if served is None:
        yield state
        return
    route = L.route_groups

    def replay(logits, cfg, idx=None, first=0):
        r = route(logits, cfg)
        want = served[state["calls"]].to(logits.device)
        state["calls"] += 1
        K = want.shape[-1]
        want = want.reshape(-1, K)
        rows = min(r.idx.shape[0] * r.idx.shape[1], want.shape[0] - first)
        own = r.idx.reshape(-1, K)
        full = own.clone()
        full[:rows] = want[first:first + rows]
        differ = (own[:rows].sort(-1).values
                  != full[:rows].sort(-1).values).any(-1)
        state["flips"] += int(differ.sum())
        state["margins"] += r.margin.reshape(-1)[:rows][differ].tolist()
        return route(logits, cfg, idx=full.reshape(r.idx.shape))

    L.route_groups = replay
    try:
        yield state
    finally:
        L.route_groups = route


def mesh_rank_serve(arch: str, depth, shape, sizes: Sizes, mesh, device,
                    workdir: pathlib.Path, sync) -> dict:
    """One rank's serve of a ``MESH_RANK_CONFIGS`` config on ``mesh`` (of
    ``shape``) through the step builders: seed-0 weights drawn leaf by
    leaf, the two ranks in turn, each keeping its shards
    (``rank_params``), the prompts of seed 0, prefill, then decode fed
    the mesh of one's greedy tokens (each step's own argmax kept), the
    MoE layers routed as the mesh of one routed them (``rank_replay``);
    the whole last logits and cache, the times (the first decode step,
    counted, untimed), the collectives of a prefill and a decode step,
    and the routing flips each rank counted."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import MeshRules, shard_tree
    from repro_torch.launch.serve import prefix_len, prompts
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.tree import tree_map

    cfg = mesh_config(arch, depth, sizes)
    B, P, n = sizes.serve_batch, sizes.prompt_len, sizes.gen_tokens
    rules = MeshRules(mesh)
    sc = ShapeConfig("mesh_ranks", P + n, B, "decode")
    prefill, (psh, bsh), _, _ = build_prefill_step(cfg, rules, sc)
    decode, in_sh, _, _ = build_decode_step(cfg, rules, sc)
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            dparams = rank_params(prefill.model, psh, device,
                                  arch in SHARED_EXPERT_DRAW)
            sync()
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    batch = prompts(cfg, B, P, 0, device)
    Pt = prefix_len(batch)
    fed = torch.load(workdir / f"{arch}.tokens.pt").to(device)
    routing = workdir / f"{arch}.routing.pt"
    served = torch.load(routing) if routing.exists() else None
    dbatch = shard_tree(batch, bsh)
    with rank_replay(served) as replay:
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(dparams, dbatch)
        own = [whole(logits).argmax(-1)]
        sync()
        prefill_s = time.perf_counter() - t0
        decode_s = 0.0
        for i in range(n - 1):
            tok = shard_tree(fed[:, i:i + 1], in_sh[2])
            if i == 0:
                (logits, cache), decode_coll = counted(
                    decode, dparams, cache, tok, Pt)
                own.append(whole(logits).argmax(-1))
                continue
            t0 = time.perf_counter()
            logits, cache = decode(dparams, cache, tok, Pt + i)
            own.append(whole(logits).argmax(-1))
            sync()
            decode_s += time.perf_counter() - t0
        flips = {"flips": replay["flips"],
                 "smallest_margin": min(replay["margins"], default=None)}
        out = {"tokens": torch.stack(own, dim=1).cpu(),
               "logits": whole(logits).cpu(),
               "cache": tree_map(lambda t: whole(t).cpu(), cache),
               "cache_placements": {k: [str(p) for p in t.placements]
                                    for k, t in cache.items()},
               "prefill_seconds": prefill_s, "decode_seconds": decode_s,
               "decode_steps_timed": n - 2,
               "decode_collectives": decode_coll}
        del cache
        replay["calls"] = 0
        _, out["prefill_collectives"] = counted(prefill, dparams, dbatch)
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, flips)
    out["routing_flips_by_rank"] = by_rank if served is not None else None
    del dparams
    return out


def mesh_rank_train(arch: str, shape, sizes: Sizes, device) -> dict:
    """One rank of ``MESH_RANK_TRAIN_STEPS`` train steps of ``arch``
    (``train_config``) through ``Trainer(mesh=)`` on a mesh of
    ``shape``: (loss, grad norm) a step, the steps' seconds (the first,
    counted, apart) and the first step's collectives."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.manager import SEARSCheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg, tcfg = train_config(sizes, arch)
    mesh = init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=("data", "model"))
    tr = Trainer(cfg, DataConfig(seq_len=sizes.train_seq,
                                 global_batch=sizes.train_batch,
                                 vocab_size=cfg.vocab_size),
                 TrainerConfig(total_steps=MESH_RANK_TRAIN_STEPS,
                               ckpt_every=1 << 30, seed=0, step_cfg=tcfg),
                 mesh=mesh, manager=SEARSCheckpointManager(
                     node_capacity=1 << 28, engine="numpy"))
    first, step = [], tr.sharded_step

    def run(*args):
        if first:
            return step(*args)
        res, coll = counted(step, *args)
        first.append(coll)
        return res
    tr.sharded_step = run
    recs = [m for m in tr.run() if "loss" in m]
    walls = [m["wall_s"] for m in recs]
    return {"arch": cfg.name, "layers": cfg.n_layers, "mesh": list(shape),
            "metrics": [(m["loss"], m["grad_norm"]) for m in recs],
            "step_seconds": [b - a for a, b in zip(walls, walls[1:])],
            "collectives": first[0]}


def mesh_rank(rank: int, port: int, workdir: str) -> None:
    """A rank of the ``mesh_ranks`` phase (``chip_smoke.py --mesh-rank
    RANK PORT DIR``): joins the two ranks' gloo group on localhost, serves
    every ``MESH_RANK_CONFIGS`` config on its mesh, trains each
    ``MESH_RANK_TRAIN`` arch on its mesh; rank 0 writes the results."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    workdir = pathlib.Path(workdir)
    spec = json.loads((workdir / "spec.json").read_text())
    sizes, device = Sizes(**spec["sizes"]), torch.device(spec["device"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    if device.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        meshes = {}
        out = {"configs": {}, "train": {}}
        with torch.no_grad():
            for arch, depth, shape in MESH_RANK_CONFIGS:
                if shape not in meshes:
                    meshes[shape] = init_device_mesh(
                        device.type, shape, mesh_dim_names=("data", "model"))
                out["configs"][arch, shape] = mesh_rank_serve(
                    arch, depth, shape, sizes, meshes[shape], device,
                    workdir, sync)
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        for arch, shape in MESH_RANK_TRAIN:
            out["train"][arch, shape] = mesh_rank_train(arch, shape, sizes,
                                                        device)
            gc.collect()
        if rank == 0:
            torch.save(out, workdir / "rank0.pt")
    finally:
        dist.destroy_process_group()


def mesh_one(arch: str, depth, sizes: Sizes, device, workdir, sync
             ) -> dict:
    """The mesh of one's serve of a ``MESH_RANK_CONFIGS`` config (the
    plain model, which the mesh-of-one builders equal bit for bit:
    ``mesh_serve``; a ``SHARED_EXPERT_DRAW`` config's routed experts
    drawn once a group): greedy tokens and, for an MoE config, every MoE
    layer's routing (written for the ranks to feed and replay), the top
    two logits and the largest |logit| of every step, the last logits
    and the cache, on the host."""
    import torch
    from repro_torch.launch.serve import prefix_len, prompts
    from repro_torch.models import api
    from repro_torch.tree import map_with_path, tree_map

    cfg = mesh_config(arch, depth, sizes)
    B, P, n = sizes.serve_batch, sizes.prompt_len, sizes.gen_tokens
    model = api.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model._zero_pads(map_with_path(functools.partial(
        shared_expert_leaf(cfg.n_experts), gen), model.param_shapes())) \
        if arch in SHARED_EXPERT_DRAW else model.init(gen)
    batch = prompts(cfg, B, P, 0, device)
    Pt = prefix_len(batch)
    toks, tops, scales = [], [], []
    model.moe_log = [] if cfg.n_experts else None
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, cache_len=P + n)
        for i in range(n):
            f = logits.float()
            tops.append(f.topk(2, dim=-1).values.cpu())
            scales.append(float(f.abs().max()))
            toks.append(f.argmax(-1))
            if i < n - 1:
                logits, cache = model.decode_step(params, cache,
                                                  toks[-1][:, None], Pt + i)
    sync()
    serve_s = time.perf_counter() - t0
    tokens = torch.stack(toks, dim=1)
    torch.save(tokens.cpu(), pathlib.Path(workdir) / f"{arch}.tokens.pt")
    if model.moe_log is not None:
        torch.save([idx.cpu() for idx, _, _ in model.moe_log],
                   pathlib.Path(workdir) / f"{arch}.routing.pt")
    out = {"cfg": cfg, "Pt": Pt, "tokens": tokens.cpu(),
           "tops": torch.stack(tops), "scales": scales,
           "logits": logits.cpu(), "serve_seconds": serve_s,
           "cache": tree_map(lambda t: t.cpu(), cache)}
    model.moe_log = None
    del params, cache, model
    return out


def mesh_one_train(arch: str, sizes: Sizes, device) -> list:
    """(loss, grad norm) of ``MESH_RANK_TRAIN_STEPS`` steps of ``arch``
    (``train_config``) on the host mesh of one device."""
    from repro_torch.checkpoint.manager import SEARSCheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, tcfg = train_config(sizes, arch)
    tr = Trainer(cfg, DataConfig(seq_len=sizes.train_seq,
                                 global_batch=sizes.train_batch,
                                 vocab_size=cfg.vocab_size),
                 TrainerConfig(total_steps=MESH_RANK_TRAIN_STEPS,
                               ckpt_every=1 << 30, seed=0, step_cfg=tcfg),
                 mesh=make_host_mesh(device.type),
                 manager=SEARSCheckpointManager(node_capacity=1 << 28,
                                                engine="numpy"))
    return [(m["loss"], m["grad_norm"]) for m in tr.run() if "loss" in m]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_ranks_phase(sizes: Sizes, device, sync, card: str = "") -> dict:
    """``mesh_ranks``: the mesh of one's serve of each
    ``MESH_RANK_CONFIGS`` arch and the train steps of each
    ``MESH_RANK_TRAIN`` arch here (their weights freed before the ranks
    start), then two rank subprocesses (``mesh_rank``) over gloo on
    localhost: each config's serve on its mesh, decode fed the mesh of
    one's greedy tokens and the MoE layers routed as the mesh of one
    routed them (each rank's count of the pairs it would have routed
    otherwise printed), held by the serve gates (``SERVE_GATES``, else
    the base ones): the last logits and every cache leaf per layer (slot
    caches over the slots written) within the cache and logit gates of
    their largest |value|, and each step's argmax equal to the mesh of
    one's token where its top two logits lie further apart than the
    logit gate; and the train steps on each ``MESH_RANK_TRAIN`` mesh,
    loss and grad norm within ``MESH_TRAIN_LOSS_TOL`` /
    ``MESH_TRAIN_GNORM_TOL`` of the mesh of one's, relative.  A rank
    that fails fails the phase.  The times and collectives are
    ``MESH_RANKS_LABEL``."""
    import torch
    t_start = time.perf_counter()
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    one_seconds = {}
    try:
        one = {}
        for arch, depth, _ in MESH_RANK_CONFIGS:
            if arch not in one:
                t0 = time.perf_counter()
                one[arch] = mesh_one(arch, depth, sizes, device, workdir,
                                     sync)
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                one_seconds[arch] = time.perf_counter() - t0
        one_train = {}
        for arch, _ in MESH_RANK_TRAIN:
            if arch not in one_train:
                one_train[arch] = mesh_one_train(arch, sizes, device)
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        (workdir / "spec.json").write_text(json.dumps(
            {"sizes": dataclasses.asdict(sizes), "device": device.type}))
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(SRC), GLOO_SOCKET_IFNAME="lo")
        t_ranks = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
             str(r), str(port), str(workdir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in (0, 1)]
        errs = []
        try:
            for r, proc in enumerate(procs):
                try:
                    _, err = proc.communicate(timeout=MESH_RANKS_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    _, err = proc.communicate()
                if proc.returncode != 0:
                    errs.append(f"rank {r} exited {proc.returncode}: "
                                f"{err[-3000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        if errs:
            raise AssertionError("mesh_ranks: " + " | ".join(errs))
        ranks_s = time.perf_counter() - t_ranks
        ranks = torch.load(workdir / "rank0.pt", weights_only=False)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    configs, checks = [], {}
    for arch, _, shape in MESH_RANK_CONFIGS:
        o, r = one[arch], ranks["configs"][arch, shape]
        cfg = o["cfg"]
        name = f"{arch}_{shape[0]}x{shape[1]}"
        cache_tol, logit_tol = (SERVE_CACHE_TOL, SERVE_LOGIT_TOL) \
            if sizes.reduced else SERVE_GATES.get(
                arch, (SERVE_CACHE_TOL, SERVE_LOGIT_TOL))
        want = o["logits"].float()
        logit_err = float((r["logits"].float() - want).abs().max()
                          / want.abs().max())
        decided = (o["tops"][..., 0] - o["tops"][..., 1]) > logit_tol \
            * torch.tensor(o["scales"])[:, None]  # (steps, B)
        agree = r["tokens"].T == o["tokens"].T
        written = o["Pt"] + sizes.gen_tokens - 1
        cache_err = {}
        for leaf, w in o["cache"].items():
            g = r["cache"][leaf]
            if leaf in SLOT_CACHES:
                g, w = g[:, :, :written], w[:, :, :written]
            cache_err[leaf] = max(layer_rel_err(
                g.float().flatten(0, -4) if leaf in STATE_CACHES
                else g.float(), w.float().flatten(0, -4)
                if leaf in STATE_CACHES else w.float()))
        line = {"arch": cfg.name, "layers": cfg.n_layers,
                "mesh": list(shape), "batch": sizes.serve_batch,
                "prompt_len": sizes.prompt_len, "tokens": sizes.gen_tokens,
                "kv_heads_stored": cfg.kv_store if cfg.n_heads else None,
                "cache_placements": r["cache_placements"],
                "vocab_sharded": cfg.vocab_size % shape[1] == 0
                and shape[1] > 1,
                "cache_tol": cache_tol, "logit_tol": logit_tol,
                "logit_rel_err": logit_err, "cache_rel_err": cache_err,
                "argmax_decided": int(decided.sum()),
                "argmax_decided_agree": bool(agree[decided].all()),
                "argmax_agree_all": bool(agree.all()),
                "mesh_of_one_serve_seconds": one_seconds[arch],
                "prefill_seconds": r["prefill_seconds"],
                "decode_seconds": r["decode_seconds"],
                "decode_tok_per_s": sizes.serve_batch
                * r["decode_steps_timed"] / max(r["decode_seconds"], 1e-9),
                "prefill_collectives": r["prefill_collectives"],
                "decode_step_collectives": r["decode_collectives"]}
        if cfg.n_experts:
            line.update(capacity_factor=cfg.capacity_factor,
                        expert_layout=moe_layout(cfg, shape),
                        routing_replayed=True,
                        routing_flips_by_rank=r["routing_flips_by_rank"])
        line["ok"] = (logit_err <= logit_tol
                      and all(e <= cache_tol for e in cache_err.values())
                      and line["argmax_decided_agree"]
                      and bool(torch.isfinite(r["logits"]).all()))
        checks[f"{name}_serve"] = line["ok"]
        configs.append(line)
    train = []
    for (arch, shape), t in ranks["train"].items():
        want = one_train[arch]
        loss_err = [abs(g[0] - w[0]) / abs(w[0])
                    for g, w in zip(t["metrics"], want, strict=True)]
        gnorm_err = [abs(g[1] - w[1]) / abs(w[1])
                     for g, w in zip(t["metrics"], want, strict=True)]
        ok = max(loss_err) <= MESH_TRAIN_LOSS_TOL \
            and max(gnorm_err) <= MESH_TRAIN_GNORM_TOL
        checks[f"train_{arch}_{shape[0]}x{shape[1]}"] = ok
        train.append(dict(t, mesh_of_one=want, loss_rel_err=loss_err,
                          grad_norm_rel_err=gnorm_err, ok=ok))
    seconds = time.perf_counter() - t_start
    if not sizes.reduced:
        checks["within_budget"] = seconds <= MESH_RANKS_BUDGET_S
    return {"phase": "mesh_ranks", "card": card, "label": MESH_RANKS_LABEL,
            "configs": configs, "train": train,
            "train_loss_tol": MESH_TRAIN_LOSS_TOL,
            "train_grad_norm_tol": MESH_TRAIN_GNORM_TOL,
            "ranks_seconds": ranks_s, "seconds": seconds,
            "budget_seconds": MESH_RANKS_BUDGET_S, "checks": checks,
            "ok": all(checks.values())}


def moe_layout(cfg, shape) -> str:
    """Where an MoE config's routed experts lie on a mesh of ``shape``
    (``MeshRules.param_spec``: E over ``model``, or over the data plane
    with F over ``model``)."""
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.models import api
    from repro_torch.tree import flatten_with_path
    mesh = type("Mesh", (), dict(mesh_dim_names=("data", "model"),
                                 shape=tuple(shape)))()
    rules = MeshRules(mesh)
    for path, spec in flatten_with_path(api.get_model(cfg).param_shapes()):
        if path[-1] == "wg" and rules.moe_leaf(path, spec.shape):
            e, _, f = tuple(rules.param_spec(path, spec.shape))[-3:]
            return f"E over {e}" + (f", F over {f}" if f else "")
    return ""


def examples_phase(device, card: str = "") -> dict:
    """``examples/torch_*.py`` (``EXAMPLES``) as subprocesses on
    ``device``, all started together; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    extra = ["--device", "cpu"] if device.type == "cpu" else []
    t0 = time.perf_counter()
    procs = {name: (subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *argv,
         *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter())
        for name, argv in EXAMPLES}
    runs = {}
    try:
        for name, (proc, started) in procs.items():
            try:
                out, err = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            runs[name] = {"returncode": proc.returncode,
                          "seconds": time.perf_counter() - started,
                          "last_lines": out.strip().splitlines()[-2:],
                          "stderr_tail": err[-2000:] if proc.returncode
                          else ""}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    checks = {f"{name}_exit_0": r["returncode"] == 0
              for name, r in runs.items()}
    return {"phase": "examples", "card": card, "device": str(device),
            "runs": runs, "seconds": time.perf_counter() - t0,
            "checks": checks, "ok": all(checks.values())}


def run(sizes: Sizes, device, engine, fused_engine, card: str = "",
        log_dir=None) -> list[dict]:
    """Every phase; raises on the first failure.  Returns the kernel
    entries.  ``engine`` and ``fused_engine`` are the staged and the
    fused engine (specs or instances)."""
    import torch
    from repro_torch.kernels import _build

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    lines = []
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.library()
    build_s = time.perf_counter() - t0
    if log_dir is not None:
        pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
        (pathlib.Path(log_dir) / "chip_smoke_build.log").write_text(
            _build.BUILD_INFO["log"])
    lines.append({"phase": "env", "card": card, "torch": torch.__version__,
                  "cuda": torch.version.cuda, "device": str(device),
                  "build_seconds": build_s,
                  "built_now": _build.BUILD_INFO["built"],
                  "int_peak": int_peak(device)})
    for line in lines:
        emit(line)
    path_lines, counts, put_art = main_path(sizes, engine, sync)
    for line in path_lines:
        emit(line)
    # the fused path: same window, the store's artifacts must be equal
    fused_lines, fused_counts, fused_art = main_path(
        sizes, fused_engine, sync, prefix="fused_")
    for key in ("nodes", "records", "listings", "stats"):
        if fused_art[key] != put_art[key]:
            raise AssertionError(f"fused put: {key} differ from the kernel "
                                 f"store's")
    fused_lines[0]["identical_to_kernel_put"] = True
    del put_art, fused_art
    for line in fused_lines:
        emit(line)
    if device.type == "cuda":
        missing = [k for k in ("gf_matmul", "gear_fire", "sha1")
                   if counts[k] < 1]
        missing += [f"fused path: {k}" for k in
                    ("fused_ingest", "gear_fire", "gf_matmul")
                    if fused_counts[k] < 1]
        if missing:
            raise AssertionError(f"main paths never launched {missing}")
    counts = dict(counts, fused_ingest=fused_counts["fused_ingest"])
    kern = kernels(sizes, device, counts)
    emit({"phase": "kernels", "kernels": [
        {k: e[k] for k in ("name", "launches", "max_abs_err", "ms",
                           "device_ms", "plain_ms", "staged_ms",
                           "staged_device_ms", "bytes", "ops", "bound_ms",
                           "bound_by") if k in e}
        for e in kern]})
    bad = [e["name"] for e in kern if e["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: "
                             f"{bad}")
    emit(differential(sizes, engine))
    emit({"phase": "fused_paths", "paths": fused_paths(sizes, fused_engine)})
    emit(profile_put(sizes, engine, device, log_dir))
    emit(profile_put(sizes, fused_engine, device, log_dir,
                     phase="profile_fused_put"))
    # the model: weights through SEARS, served, and K6 on its attention
    ckpt_line, model, params = checkpoint_phase(sizes, device, fused_engine,
                                                sync)
    emit(ckpt_line)
    serve_line, layer0 = serve_phase(sizes, device, model, params, sync)
    emit(serve_line)
    del params, model
    gc.collect()
    flash_line, flash_rows = flash_phase(sizes, device, layer0, sizes.reps)
    del layer0
    emit(flash_line)
    if not serve_line["ok"]:
        raise AssertionError("serve: decode and the extended prefill "
                             "disagree (see the serve line)")
    if device.type == "cuda" and min(r["launches"] for r in flash_rows) < 1:
        raise AssertionError("the flash phase never launched K6's bf16 or "
                             "fp32 kernel")
    train_line = train_phase(sizes, device, sync, card)
    emit(train_line)
    if not train_line["ok"]:
        raise AssertionError(f"train: checks failed: "
                             f"{train_line['checks']}")
    config_lines = []
    for phase in (dense_configs_phase, moe_mla_configs_phase,
                  ssm_encdec_configs_phase):
        lines = phase(sizes, device, fused_engine, sync, card)
        for line in lines:
            emit(line)
        bad = [(line["arch"], line["checks"]) for line in lines
               if not line["ok"]]
        if bad:
            raise AssertionError(f"{lines[0]['phase']}: checks failed: "
                                 f"{bad}")
        config_lines += lines
    # the step roofline, the examples and the dry run (its subprocesses
    # trace on the host's CPU while the other two run)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry_procs = start_dryrun(device, out_dir)
    try:
        roof_lines = roofline_phase(sizes, device, serve_line, train_line,
                                    config_lines, sync, card)
        for line in roof_lines:
            emit(line)
        examples_line = examples_phase(device, card)
        emit(examples_line)
        mesh_line = mesh_ranks_phase(sizes, device, sync, card)
        emit(mesh_line)
        dryrun_line = dryrun_phase(dry_procs, out_dir, card)
        emit(dryrun_line)
    finally:
        for _, proc, _ in dry_procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    bad = [(line["phase"], line["checks"]) for line in
           (roof_lines[-1], examples_line, mesh_line, dryrun_line)
           if not line["ok"]]
    if bad:
        raise AssertionError(f"checks failed: {bad}")
    # each kernel's launches in the model phases' checkpoints
    ckpts = [("train", train_line)] + [
        (line["arch"], line) for line in config_lines if "save_kernels"
        in line]
    for e in kern + flash_rows:
        e["checkpoint_launches"] = {
            name: {"save": line["save_kernels"].get(e["name"], 0),
                   "restore": line["restore_kernels"].get(e["name"], 0)}
            for name, line in ckpts}
    return kern + flash_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-dir", default=None,
                    help="write the kernel build log and the profile "
                         "table to this directory")
    ap.add_argument("--mesh-rank", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)  # a rank of mesh_ranks
    args = ap.parse_args(argv)
    if args.mesh_rank:
        sys.path.insert(0, str(SRC))
        rank, port, workdir = args.mesh_rank
        mesh_rank(int(rank), int(port), workdir)
        return 0
    t0 = time.perf_counter()
    # cuBLAS reads this when it makes its first handle: the train phase's
    # deterministic steps need it (torch refuses them without it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch sources under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    card = nvidia_smi()
    try:
        kern = run(Sizes(), torch.device("cuda"), "kernel", "fused", card,
                   args.log_dir)
    finally:  # the one-rank group the mesh phases made
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    # the main path's kernel launch counts count toward 'launches'; the
    # comparison launches above them do not (main_path read them first)
    emit({"kernels": [{k: e[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library_device_ms", "staged_ms", "staged_device_ms",
        "max_abs_err_by_shape", "device_ms_by_shape",
        "library_device_ms_by_shape", "bound_ms_by_shape",
        "ms_by_shape", "plain_ms_by_shape", "library_ms_by_shape",
        "bound_term_by_shape", "shape_by_name",
        "staged_device_ms_by_shape", "longest_chain_rounds_by_shape",
        "longest_chain_rounds", "device_ms_all_8k",
        "device_ms_one_8k", "tflop_per_s",
        "share_of_bound", "fp32_ms", "ptxas", "tol",
        "checkpoint_launches") if k in e}
        for e in kern]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

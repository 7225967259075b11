#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, and the script exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 is switched off for matmuls and cuDNN.
2. build: nvcc builds the three kernel sources from ops/csrc
   (grouped_attention.cu, whose entries serve all four attention kernels,
   cluster_counts.cu and layer_norm.cu), one process per source, all
   started together.
3. kernel: the grouped attention kernel (K1, bf16 on the Hopper loop after
   the rope_qk pre-pass) against the plain PyTorch version on the card, in
   every mode the slices use and at every head dim, and both timed at the
   ESM2-650M headline shape.
4. slice: ``score --model esm --checkpoint esm2_t33_650M`` (seeded random
   bf16 weights, full width and depth) on a synthetic L=250 assay with all
   4,750 single mutants, through the port's CLI; the launch counter must
   show 33 launches of the heads-mid entry (K4) per chunk forward; the
   whole log-prob table is recomputed with the plain attention and
   compared.
5. windowed: ``esm2_t6_8M`` on an L=1100 assay, through the CLI, so every
   row takes the optimal-window path at T=1024.
6. cluster counts (K5, the int8 tensor-core Gram with the count fused
   in): the sequence-weight kernel against its plain version, counts equal
   exactly, on ragged alignments with all-gap and duplicated rows, then on
   seeded synthetic MSAs at N=16,384, L=300 (the ``kernels`` line's
   shape), N=65,536, L=300 and N=8,192, L=1,000: each held exactly, timed
   beside its plain version, with its bound (int8, and bf16 beside it),
   the TOP/s reached and the call's peak device memory; the compiler's
   registers, shared memory and spills of the kernel; at N=16,384 cuBLAS's
   int8 Gram of the full square on the same one-hot (``torch._int_mm``),
   a reading aid that is not K5's function.
7. long-context attention (K2, the Hopper loop in bf16 and the scalar
   kernel in float32): against the plain version (causal + mask at T=2048
   and 4352, ALiBi + causal, ragged T, fully masked rows); K1 at PoET's
   self-tier shape (segmented + causal + RoPE, T=4352), at B1 and at B8
   with each row's own cuts (the timed call, held on live rows); K2 at
   PoET's row shape B8 H16 T4352 with each row's own valid length and one
   row whose first keys are masked, both timed calls (the loop alone and
   the call with the pre-pass) held against the plain version on every
   row; K2 and K1 timed there, each beside the PyTorch call that computes
   the same function (scaled_dot_product_attention with a dense boolean
   mask) and its bound, and SDPA's fused causal kernel on K2's q/k/v.
8. PoET slice: ``weights`` then ``score --model poet --checkpoint
   poet_200m`` (seeded random bf16 weights, full width and depth) through
   the port's CLI, on a synthetic L=250 assay (128 single mutants) with a
   16,384-sequence MSA: the weights file is written by K5 and reused, each
   forward launches K1 and K2 12 times each and their pre-pass 24 times,
   two queries' per-token log-probs are recomputed with the plain
   attention and compared.
9. K3 and K4: the extent-sparse segmented kernel (the Hopper loop in bf16)
   and the heads-mid entry against their plain versions in bf16 and
   float32 (live query rows); K3 checked and timed at B8 H20 T4096 with 16
   segments of ~250 tokens, each row its own cuts, and the key mask as its
   own operand (the call with RoPE timed as ``ms``, the loop alone on
   pre-rotated q/k as ``loop_ms``), K4 at the headline shape and at the packed path's window bucket (B32 H20 T1024),
   and the rope_qk pre-pass at the latter (equal to its plain version bit
   for bit); each beside scaled_dot_product_attention on the same
   pre-rotated q/k and its bound.
10. packed: ``score --model esm --checkpoint esm2_t33_650M --packed``
   through the CLI on synthetic assays of lengths 72, 118, 250, 448, 709
   and 1500 with all single mutants, twice (the second run is timed): 33
   K4 launches per forward; the L=250 scores equal phase 4's per-assay
   scores.
11. segment-packed: ``score_assays_packed(..., seg_apply_fn=...,
   row_len=4096)`` with ESM2-650M on the assays up to L=709, twice: 33 K3
   and 33 rope_qk launches per forward and no other; scores equal phase
   10's; two packed rows' log-probs recomputed with the plain attention.
12. the benchmark flow, ESM2-650M: (a) ``score --extra
   scoring_strategy=wt-marginals`` on phase 4's L=250 assay and on an
   L=3000 assay (five overlapping windows in one forward), 33 K4 launches
   each, tables against the plain attention; (b) ``pseudo-ppl`` on 16
   mutants of the L=250 assay, 33 x 17 x 16 K4 launches, the WT's and one
   mutant's masked tables against the plain attention; (c) ``merge`` then
   ``evaluate --device cuda`` of the three ESM score files; (d) ``merge``
   and ``evaluate`` of 217 synthetic assays x 2,000 mutants x 10 models,
   bootstrap 10,000, on the card and on the CPU: every CSV equal at 1e-9,
   the ranking in noise order, Spearman and AUC on the card against scipy;
   (e) ``evaluate-clinical --device cuda``.
13. MSA Transformer: ``score --model msa_transformer --checkpoint
   esm_msa1b_t12_100M`` (seeded random bf16 weights, full width and depth)
   through the CLI on a synthetic L=250 assay whose 16,384-sequence
   alignment covers residues 1-240, 384 sampled rows, 1 seed of
   ProteinGym's 5: K5 once (no weights file beforehand), then exactly 12
   K1 launches per forward (the column attention, B*C = 4 x 241, T=384)
   and no other; 128 finite scores, the 8 mutants past the alignment
   empty, WT 0; the warm k=1 table and the k=8 table timed; the first and
   last masked columns against the plain attention; K1 at B964 H12 T384
   held against the plain version and timed beside SDPA and its bound.
14. Tranception and TranceptEVE: seeded random Tranception-L (bf16, 36
   layers, width 1280, 20 heads of 64) and an EVE file at EVE's default
   architecture over the 240 focus columns, written by the script in the
   reference layout. (a) ``score --model trancepteve --checkpoint Large
   --extra retrieval_type=TranceptEVE eve_checkpoints=<file>`` through the
   CLI on phase 13's L=250 target and alignment with all 4,750 singles: K5
   once, 36 K1 launches per forward and no other kernel, 2 x 149 forwards
   of 32 x 256 tokens, the JAX table's columns, finite scores; the CLI
   wall, the prior's and the AR scoring's seconds and the peak memory. (b)
   ``score --model tranception --checkpoint Large`` on an L=1,500 target
   with 32 singles: optimal 1,022-residue windows, T=1024. (c) ``score
   --model eve --checkpoint <file>`` on the L=250 singles and a WT row at
   2,000 draws: the 190 mutants past the alignment empty, WT 0. (d) two
   rows of (a) and two windows of (b), both directions, per-token
   log-probs against the plain attention. (e) K1 at B32 H20 T256 and
   B32 H20 T1024 with Tranception's slopes and each row's own pad tail,
   held on live rows and timed beside SDPA (a dense bf16 mask of bias,
   causal and key mask) and its bound. (f) ``merge`` of the three score
   files.
15. the indel track and the alignment baselines: the port's Gotoh aligner
   built with g++, then on an L=400 target with 2,000 unique indel
   variants and the WT, its 16,384-sequence alignment over residues 1-380:
   (a) ``score --model trancepteve --indel-mode`` (Tranception-L and EVE
   at full width, 20,000 prior draws): K5 once and 36 K1 launches per
   forward and no other kernel, 2 x 63 forwards of 32 x 416 tokens, every
   variant finite and the WT 0, the aligner's, the realignment's, the EVE
   prior's and the AR scoring's seconds, the two prior stacks' bytes, the
   peak memory; then ``tranception`` with MSA retrieval under
   torch.profiler for the idle share; 8 indel rows' per-token log-probs
   against the plain attention; K1 at B32 H20 T416 with each row's pad
   tail of 1-31 held on live rows and timed beside SDPA and its bound.
   (b) ``score --model hmm``, --indel-mode on that assay and without it on
   phase 14's L=250 assay: finite scores, WT 0, build and forward seconds,
   launches per residue step, 64 rows' log-probs against the CPU. (c)
   ``site_independent`` and ``potts`` (300 Adam steps, float32 without
   TF32) on phase 14's L=250 target and alignment with its 4,750 singles:
   the loss falls, the scores are finite and differ, the achieved TFLOP/s,
   the first 3 steps against float64 on the CPU; the trained model written with
   ``write_plmc_model`` and scored through --checkpoint gives the same
   scores. (d) ``merge`` and ``evaluate --mutation-type indels`` of (a)
   and (b): the Spearman summary names the three models.
16. the trainers from the alignment, through the port's CLI, on phase
   14's L=250 target and 16,384-row alignment and phase 15's indel assay,
   with no weights file, so K5 runs once on every alignment load and
   nothing else launches a kernel of the port except TranceptEVE's K1: (a)
   ``train --model eve --steps 500`` at EVE's default architecture (55M
   parameters, batch 256, float32 without TF32): the reference EVE file,
   steps/s, the loss of the first and last 100 steps, peak memory, then
   ``eve.train`` for 200 steps under torch.profiler (idle share, device
   time by kind of kernel, launches per step) and the decoder KL timed
   alone; (b)
   ``score --model deepsequence`` without --checkpoint (500 steps, 2,000
   draws): finite evol indices under the JAX column, the 190 mutants past
   the alignment empty; (c) ``score --model trancepteve --extra
   retrieval_type=TranceptEVE eve_checkpoints=<(a)'s file>`` on the first
   512 singles: 36 K1 launches per forward at B32 H20 T256, the EVE
   prior's seconds and mutants/s; (d) ``train --model potts --steps 300``:
   the ``.model`` file read back equals the trained h and J; (e) ``score
   --model wavenet --extra steps=200`` on the indel assay and on the
   singles: training seconds, mutants/s, the idle share of
   ``wavenet.train`` for 50 steps and of the scoring; (f) EVE's and
   WaveNet's first 3 Adam steps on the card against the same steps on the
   CPU, every draw made once on the CPU: the losses, and each parameter
   tensor, within the stated tolerances.
17. the rest of the alignment baselines through the port's CLI, each at
   its defaults, on phase 14's L=250 target, 16,384-row alignment and
   4,750 singles (with a synonymous WT row) and on phase 15's indel
   assay, with no weights file, so K5 runs once per CLI run and nothing
   else of the port's kernels: (a) ``gemme`` (3 NJ trees of 512 rows);
   (b) ``escott --structure-dir`` with a synthetic helix of the target,
   and with one of the wrong length, which prints the fallback message;
   (c) ``siterm`` (GTR: 1,024 rows, 100 Adam epochs): the NJ seconds, ms
   an epoch, launches an epoch and idle share of the epochs under
   torch.profiler; (d) ``siterm --extra method=f81``; (e) ``rsalor`` with
   and without the structure; (f) ``provean`` on the singles and on the
   indel assay: the supporting set, pairs, DP cells and cells/s,
   launches per query row, idle share. Each part: the column, the finite
   count, WT 0, the CLI wall split into fit and scoring seconds, peak
   memory. The card is held against the CPU at these sizes: PROVEAN's
   scores equal, GEMME's tables within 1e-9, SiteRM's GTR rate matrices
   and scores and F81 rates within stated bounds.
18. the AR zoo through the port's CLI, each family at its preset's full
   width and depth with seeded random weights, on phase 14's L=250 target
   and singles: (a) ``progen2 --checkpoint progen2-xlarge`` (32 x 4096, 16
   heads of 256) on the first 512 singles, (b) ``rita --checkpoint
   RITA_xl`` on the first 512 and on every 2nd row of phase 15's indel
   assay (1,001 rows, T=416), (c) ``protgpt2`` at its defaults (36 x 1280, 20 heads of 64,
   byte-level tokens) on the first 512, (d) ``progen3 --checkpoint
   progen3-3b`` (28 x 2304, 24 heads of 96, 8 experts, top-2, float32
   products) on the first 256, (e) ``unirep`` (hidden 1,900) on all singles
   and again with ``--extra evotune_steps=20`` on phase 14's alignment (K5
   once): each run's
   column, forwards, K1 launches a forward, mutants/s, peak memory and the
   idle share of two forwards of its first scoring pass; (f) each transformer family's
   mean log-likelihoods of 8 rows against the plain attention; (g) the
   float32 K1 (the 3xTF32 tensor-core kernel) at the zoo's five shapes
   against its plain version, timed beside SDPA ``is_causal`` and its
   bound.
19. the masked LMs through the port's CLI, each at its preset's full
   width and depth with seeded random weights, on phase 14's L=250 target
   (4,750 singles and a synonymous WT row, which must score 0): (a)
   ``esmc --checkpoint esmc_600m`` (36 x 1152, bf16), masked then WT
   marginals, 36 K1 and 36 rope_qk launches a forward; (b) ``esm3
   --checkpoint esm3_open_small`` (48 x 1536, float32) with
   ``--structure-dir`` (a helix of the target with seeded noise on every
   CA) and ``--extra structure_checkpoint=esm3_structure_encoder`` (the
   full encoder), 48 float32 K1 launches a forward, the structure tokens'
   and the scoring pass's seconds, then sequence-only (scores must move);
   (c) ``esm3`` sequence-only on phase 5's L=1,100 target, 16 singles at
   --batch-size 4 (T=1,102: 48 K2 launches a forward, float32); (d)
   ``xtrimopglm --checkpoint xtrimopglm_1b`` (MLM) and ``xtrimopglm_3b
   --extra mode=ar`` on all singles (149 forwards of 32 x 251, bf16 causal
   K1 at head dim 128); (e) ``carp --checkpoint carp_640M``, both
   strategies, no kernel of the port. Each run: the column, the finite
   count, the CLI wall, forwards, launches a forward, mutants/s, peak
   memory and the idle share of two forwards. (f) 8 masked rows per
   transformer (for the AR one, 8 rows' mean log-likelihoods, as phase
   18 holds them) against the plain attention; ESM3's structure codes on the card against the CPU (tokens
   equal where the best code beats the second by more than TOKEN_MARGIN,
   the flips counted); one CARP-640M forward in float32 against the CPU.
   (g) K1 at the four new shapes (ESM-C B32 H18 T256 D64 bf16 pad mask,
   xTrimoPGLM-1B B32 H16 T252 D128, 3B AR T251 causal, ESM3 B32 H24 T252
   D64 float32) against its plain version, timed beside SDPA and its
   bound.
20. the backbone-conditioned scorers through the port's CLI at full
   width with seeded random weights, on phase 14's L=250 target and its
   helix with seeded noise on every CA (``--structure-dir``): (a)
   ``esm_if1 --checkpoint esm_if1`` (8 + 8 layers, width 512, float32) on
   all 4,750 singles: one encoder pass (8 float32 K1 launches) and 149
   decoder forwards of 32 x 250 (8 causal float32 K1 launches each, cross
   attention in plain products); (b) ``esm_if1 --extra
   complex_chains=A,B`` on a two-helix complex (encoder T=382, 10 NaN
   spacers as padding) on the first 1,024 singles; (c) ``protein_mpnn
   --checkpoint v_48_020`` with 10 decoding orders on the first 2,048
   singles (pairs in memory-budget chunks, no kernel of the port); (d)
   ``saprot --checkpoint saprot_650M`` on all singles (3Di letters from
   the helix; 33 K4 and 33 rope_qk launches a forward). Each run: the
   CLI wall and mutants/s, forwards and launches, peak memory, two
   forwards under the profiler. (e) 8 ESM-IF1 rows' per-token log-probs
   against the plain attention, two planted faults (the causal mask off,
   each row's next key visible) that must fail that check; K1 at the
   encoder's two shapes; the card against the CPU at full size: ESM-IF1's
   per-token log-probs, ProteinMPNN's per-position log-probs of 4
   (sequence, order) pairs (neighbours equal), SaProt-650M's of 2 masked
   rows in float32. (f) the float32 K1 at the decoder shape (B32 H8 T250
   D64, causal + PAD mask) beside its plain version, SDPA and its 3xTF32
   bound, as ``grouped_attention:f32_esm_if1`` on the ``kernels`` line;
   (g) K4 at SaProt-650M's rows (B32 H20 T252 D64 bf16, mask + RoPE): the
   call, the loop alone, plain, SDPA and bound, as
   ``grouped_attention_bthd:saprot_650m``.
21. the structure-conditioned PLMs through the port's CLI at full width
   with seeded random weights, on phase 14's L=250 target, its singles and
   phase 20's helix: (a) ``prosst --checkpoint prosst_2048`` (12 x 768,
   float32) with the 3Di k-means states, one forward and no kernel of the
   port; (b) the same with ``--extra quantizer_dir=`` holding a seeded
   ``AE.pt`` at the published size and 2,048 seeded centroids (the
   quantizer's nodes, edges and seconds); (c) ``venusrem --checkpoint
   prosst_2048`` with a 16,384-row alignment of the whole target (K5 once)
   and ``struc_seq_aln_dir=``; (d) ``mulan --checkpoint mulan_small`` on
   all singles (149 forwards of 32 x 252: 12 float32 K4 and 1 float32 K1
   each); (e) ``mif`` and ``mif_st``; (f) each legacy method (``prosst`` and
   ``mulan --extra method=additive``, ``venusrem --extra method=esm``;
   ESM2-8M in bf16, 6 K4 and 6 rope_qk a forward) on the first 320
   singles. Each run: the CLI wall and mutants/s, forwards and launches,
   peak memory, two forwards under the profiler. (g) MULAN-small's
   per-token log-probs of 8 rows, kernels against the plain attention, the
   adapter's last key tile skipped shown to fail that check; the card
   against the CPU at full size: ProSST-2048's log-probs, VenusREM's
   scores, MULAN-small's scores of 32 singles, MIF's and MIF-ST's logits in
   float32, the quantizer's embeddings and tokens on 32 anchors. (h) the
   float32 K4 at MULAN-small's trunk rows (B32 T252 H20 D24, pad mask +
   RoPE) and the float32 K1 at its adapter's (B32 H20 T252 D24, key mask),
   each beside plain, SDPA and its 3xTF32 bound, as
   ``grouped_attention_bthd:f32_mulan`` and
   ``grouped_attention:f32_mulan_adapter``.
22. structure slice C through the port's CLI at full width with seeded
   random weights, on phase 14's L=250 target, its singles and phase 20's
   helix in a PDB with B-factors 90 but 50 on 40 residues: (a) ``protssn``
   over ESM2-650M (``esm_checkpoint=esm2_t33_650M``) with the nine
   ``protssn_k{10,20,30}_h{512,768,1280}`` members and seeded statistics
   (one ESM forward: 33 K4 + 33 rope_qk; each member's edges, host graph
   seconds and device ms); (b) ``s2f --checkpoint s2f``, ``s3f --checkpoint
   s3f`` with a seeded 3,000-point surface, ``s3f_msa --checkpoint s3f``
   with phase 21's 16,384-row alignment (K5 once); (c) ``aido`` on the
   target with the alignment (8 forwards of 32 x 252) and on an L=1,000
   target (48 forwards of 32 x 770), 8 K1 + 8 rope_qk a forward. Each run:
   the CLI wall and mutants/s, forwards and launches, peak memory, two
   forwards under the profiler. (d) AIDO's per-token log-probs of 8 rows,
   K1 against the plain attention, the last key tile skipped shown to fail
   that check; the card against the CPU at full size: ProtSSN k20_h512's
   logits, S3F's node logits with its surface and S2F's scores (one
   edge dropped on the card shown to fail each), AIDO's bf16 table rows of
   one chunk within a gate set from the run's own bf16 noise. (e) K1 at
   AIDO's two shapes (B32 H8 T252 and T770 D64 bf16, every key live)
   beside plain, SDPA and the bound, as ``grouped_attention:aido_T252`` and
   ``grouped_attention:aido_T770``.
23. the supervised track and the VESPA family at full width with seeded
   weights, on phase 14's L=250 target (4,750 singles; every 4th, 1,024,
   for ProteinNPT and Kermut) and phase 20's helix: (a) ``vespa``
   (``vespa_mode=full``) through the scorer's library call with a
   ProtT5-XL T5ForConditionalGeneration state dict in ``extra["params"]``
   (24 + 24 layers), a ``prott5cons`` ConsCNN file and DEFAULT_BLEND: the
   masked log-odds table's seconds, 4 rows card vs CPU, T5's absent softmax
   scale put in shown to fail; (b) ``score --model vespag --checkpoint
   state_dict_v2.pt --extra esm_checkpoint=esm2_t36_3B`` (36 K4 + 36
   rope_qk), the landscape card vs CPU on the same embeddings, K4 at B1
   H40 T252 D64 beside plain, SDPA and the bound as
   ``grouped_attention_bthd:esm2_3b``; (c) ``ohe_ridge`` and
   ``embeddings_ridge --checkpoint esm2_t33_650M`` over all singles and
   three schemes (149 forwards of 33 K4 + 33 rope_qk), features of 8 rows
   and the ridges' out-of-fold predictions card vs CPU; (d) ``proteinnpt
   --extra npt_steps=50``: ms a step, the idle share, 5 steps card vs CPU
   on the same draws; (e) ``kermut --structure-dir`` (50 steps a fold): the
   last fold's hyperparameters and predictions card vs CPU, the distance
   term dropped shown to fail; (f) ``supervised-score`` ->
   ``merge-supervised`` -> ``evaluate-supervised`` over (c)-(e)'s files.
24. the last slice: (a) ESM2-650M masked-LM training (``esm_train``: bf16
   compute on float32 masters, AdamW with optax's defaults, the plain
   attention) for 20 steps on a repeated batch of 8 x 252 tokens (ms a
   step, tokens/s, peak memory, the loss falling), one bf16 step's update
   against the same step in float32 on the card, the loss over the
   unmasked positions shown to fail; (b) ProtSSN's ``train_denoising`` at
   ProtssnConfig's defaults on phase 20's helix with ESM2-650M embeddings
   (33 K4 + 33 rope_qk), 100 steps (ms a step, idle share, final loss), 3
   steps card vs CPU on the same draws, other draws shown to fail; (c)
   ``score --mesh data=1,model=1`` through the CLI over a one-rank NCCL
   group (Megatron's row-parallel layers), the scores against phase 4's
   to ``MESH_SCORES_ATOL`` (K4 under ``esm_mesh``), a
   doubled all-reduce shown to fail; (d) ring attention on that group at
   B1 H20 T4096 D64 against the plain attention, the key mask dropped shown
   to fail; (e) the expert-parallel ProGen3 forward at progen3-3b's widths,
   8 of its 28 layers (depth cut for time), against ``ProGen3.forward``
   (the float32 K1 under ``progen3_expert``), experts at the wrong indices
   shown to fail; (f) ``score --profile-dir`` with ESM2-8M: the trace names
   K4's loop, the plain attention shown to fail. K4 at the mesh run's chunk
   and the float32 K1 at (e)'s rows join the ``kernels`` line as
   ``grouped_attention_bthd:esm_mesh`` and
   ``grouped_attention:f32_progen3_expert``.
25. the layer norm (``ops/layer_norm.py``, no TPU counterpart): the kernel
   against its plain version (the sum bit for bit, the norm within one
   bf16 ulp), timed at ESM2-650M's packed rows, 32,768 x 1,280, plain and
   with the residual add, and at ProGen2-xlarge's, 4,096 x 4,096, beside
   the plain chain (float32 copy, ``F.layer_norm``, cast, and the add)
   and the bytes bound (no one PyTorch call takes bf16 rows with float32
   weight and bias); the host's seconds a call, kernel and plain chain.
   It joins the ``kernels`` line as ``layer_norm``, with the launches of
   the paths (``ops/layer_norm.LAUNCHES`` is zeroed and read with the
   attention counters around each); the ESM paths must launch it
   2 x layers + 2 times a forward (68 for ESM2-650M), ProGen2-xlarge 33.

Every phase holds the port to its rule: no module of the JAX package
(``proteingym_tpu``) may be loaded. It prints one JSON line describing the
kernels (time, plain version, the PyTorch call for the same function where
there is one, the bound: the larger of bytes over 3.35 TB/s and operations
over 989 TFLOP/s in bf16, 495 TFLOP/s in TF32 three times over for the
float32 K1's 3xTF32 products, or 1,979 TOP/s in int8 for K5, the H100
SXM's peaks), then, as its last line,
``{"ok": true, "device": {...}}``. With no CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
AA = "ACDEFGHIKLMNPQRSTVWY"
KERNELS = {  # launch counter -> (source, the TPU kernel it replaces)
    # the four attention wrappers launch the entries of one source: its
    # float32 kernel, or for bf16 its pre-pass and the Hopper loop
    "grouped_attention": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                          "proteingym_tpu/ops/flash_attention.py:181"),
    "flash_attention": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                        "proteingym_tpu/ops/flash_attention.py:48"),
    "seg_block_attention": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                            "proteingym_tpu/ops/flash_attention.py:656"),
    "grouped_attention_bthd": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                               "proteingym_tpu/ops/flash_attention.py:440"),
    # the pre-pass of the Hopper loop: the rotation the TPU kernels apply on
    # load, and the scale of q
    "rope_qk": ("proteingym_tpu_torch/ops/csrc/grouped_attention.cu",
                "proteingym_tpu/ops/flash_attention.py:156"),
    "cluster_counts": ("proteingym_tpu_torch/ops/csrc/cluster_counts.cu",
                       "proteingym_tpu/msa/weights.py:152"),
}
LAYER_NORM_SOURCE = "proteingym_tpu_torch/ops/csrc/layer_norm.cu"  # replaces no TPU kernel
SOURCES = sorted({Path(src).stem for src, _ in KERNELS.values()}
                 | {Path(LAYER_NORM_SOURCE).stem})  # one nvcc each

# bf16 kernel vs a float32 plain version of the same bf16 inputs: the kernel
# rounds the scaled and rotated q/k to bf16 (2^-9 relative each) and its
# output to bf16 (2^-9 relative, |out| <= ~4 for unit-normal v), so errors
# reach ~1e-2; a masking or softmax bug is O(0.1-1).
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# float32 kernel vs float32 plain version: only the summation order differs
F32_ATOL, F32_RTOL = 1e-4, 1e-4
# log-prob table rows, kernel vs plain attention through 33 bf16 layers: each
# attention output differs by ~1 bf16 ulp; the residual stream carries that
# to ~1e-2 in the log-probs. A wrong mask or position shifts them by O(1).
TABLE_ATOL = 1e-1
# PoET per-token log-probs, kernels vs plain attention through 12 bf16
# layers (24 attention calls) at T ~ 4,350: the same ~1 bf16 ulp per call,
# carried by the residual stream. A wrong mask, segment or rotation shifts
# them by O(1).
POET_LOGP_ATOL = 1e-1
# MSA Transformer log-probs, kernel vs plain attention through 12 bf16
# layers (12 column-attention calls over 384 rows): the same ~1 bf16 ulp per
# call, carried by the residual stream, as TABLE_ATOL allows for 33 layers.
# A wrong mask, layout or scale shifts them by O(1).
MSA_TABLE_ATOL = 1e-1
# Tranception-L per-token log-probs, kernel vs plain attention through 36
# bf16 layers: ~1 bf16 ulp per attention call carried by the residual
# stream, as TABLE_ATOL allows for 33 layers. A wrong mask, causal extent,
# ALiBi slope or pad tail shifts them by O(1).
TRANCEPTION_LOGP_ATOL = 1e-1
GAP_AA = "-" + AA

# H100 SXM peaks (dense bf16 and int8 tensor cores, HBM3) for the bounds
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES_PER_S = 989e12, 1979e12, 3.35e12

# the shapes of phase 25: (rows, width, residual add) of the layer norm,
# the first the kernels line's: ESM2-650M's packed rows (32 x 1,024 tokens)
# with the add before its second norm, alone, and ProGen2-xlarge's rows
LN_TIMED = ((32768, 1280, True), (32768, 1280, False), (4096, 4096, False))

# the shapes of phases 6-8
# (N, L) of the timed synthetic MSAs; the first is the kernels line's shape
K5_TIMED = ((16384, 300), (65536, 300), (8192, 1000))
POET_ROW = (8, 16, 4352)  # (B, H, T) of PoET's attention calls at batch 8
POET_SLICE = dict(preset="poet_200m", length=250, n_seqs=16384, n_mut=128,
                  batch=8, n_samples=2, max_context_tokens=4096)
# the shapes of phases 9-11
K3_TIMED = (8, 20, 4096, 16, 250)  # (B, H, T, segments, segment length)
K4_TIMED = ((16, 20, 256), (32, 20, 1024))  # (B, H, T): the L=250 table, the window bucket
PACKED_MIX = (72, 118, 250, 448, 709, 1500)  # the JAX bench's production mix
PACKED_BATCH = 32  # rows per forward of the bucketed packed path
SEG_ROW_LEN, SEG_CHUNK = 4096, 8  # segment-packed rows and rows per forward
SEG_MIX = PACKED_MIX[:-1]  # L=1500's 1,024-token windows would add ~1.5M tokens
# the shapes of phase 12
WT_LONG = 3000  # five overlapping 1,024-token windows: [0, 1978, 511, 1467, 989]
PPPL_MUTANTS = 16  # pseudo-ppl: one masked table per mutant and one for the WT
# (assays, mutants per assay, model noise levels): ProteinGym's 217
# substitution assays, cut from ~2.5M mutants and 97 models
EVAL_SCALE = (217, 2000, tuple(0.2 * (j + 1) for j in range(10)))
# the shapes of phase 13: an L=250 target, its alignment over residues
# 1-240, 128 mappable and 8 unmappable singles, ProteinGym's 384 sampled
# rows, the CLI's default batch (4 grids per forward), k=8 timed beside k=1
MSA_SLICE = dict(preset="esm_msa1b_t12_100M", length=250, covered=240, n_seqs=16384,
                 n_in=128, n_out=8, rows=384, batch=32, k_cols=8)
# the shapes of phase 14: phase 13's L=250 target and alignment with all
# 4,750 singles (TranceptEVE and EVE) and an L=1,500 target with 32 singles
# spread over it (Tranception alone, optimal windows of 1,022 residues);
# EVE at its default architecture over the 240 focus columns; K1 at both
# Tranception shapes
TRANCEPTION_SLICE = dict(checkpoint="Large", length=250, covered=240, n_seqs=16384, batch=32,
                         long_length=1500, long_mutants=32, eve_num_samples=20_000,
                         eve_scoring_samples=2000)
K1_TRANCEPTION = ((32, 20, 256), (32, 20, 1024))  # (B, H, T): the L=250 rows, the windows
# the shapes of phase 15: an L=400 target, its alignment over residues
# 1-380, 2,000 unique indel variants (700 deletions and 700 insertions of
# 1-3 residues, 400 substitution-plus-indel doubles, 200 with two indels)
# and the WT; Tranception-L with EVE at its default architecture over the
# 380 focus columns and the default 20,000 prior draws; the HMM on it and
# on phase 14's L=250 assay, and the Potts models there at the scorer's
# default 300 steps
INDEL_SLICE = dict(checkpoint="Large", length=400, covered=380, n_seqs=16384, batch=32,
                   variants=(700, 700, 400, 200), eve_num_samples=20_000, logp_rows=8,
                   plm_steps=300)
K1_INDEL = (32, 20, 416)  # (B, H, T): whole indel rows of 394-406 residues, one bucket
# Potts scores from the model written with write_plmc_model and read back
# must equal the trained model's exactly: the file holds float32, and the
# trained h and J are float32 values (Adam updates P from zero with a
# symmetric gradient, so symmetrising it in float64 changes nothing)
POTTS_FILE_ATOL = 0.0
# Card against CPU at phase 15's own sizes, where cuBLAS picks its own
# algorithms: the HMM's float32 log-probs of HMM_CPU_ROWS rows spread over
# each assay (the WT among them) against the same forward on the CPU; the
# Potts trainer's first POTTS_CPU_STEPS Adam steps on all N rows against
# the same steps in float64 on the CPU: each step's loss (relative) and
# h and J (relative Frobenius norm; Adam's first steps are near +-lr
# wherever a gradient is not 0, so an entry whose gradient is within
# float32 noise of 0 may take the other sign, and a max-abs bound would
# be lr). Readings on an H100 at 700 W: HMM max |diff| 0; Potts losses
# 1.1e-5, h 1.6e-4, J 4.2e-4 (J max |diff| 0.055); TF32 in the product
# would flip far more entries
HMM_CPU_ROWS, HMM_CPU_ATOL = 64, 1e-4
POTTS_CPU_STEPS, POTTS_LOSS_RTOL, POTTS_HJ_RTOL = 3, 1e-4, 2e-3
# float32 H100 SXM peak without TF32 (the Potts trainer's product), and
# TF32's on the tensor cores: a 3xTF32 product takes three TF32 passes
PEAK_F32_FLOPS, PEAK_TF32_FLOPS = 67e12, 495e12
# the shapes of phase 16: phase 14's L=250 target and alignment and phase
# 15's indel assay; EVE at its default architecture for 500 steps (cut
# for time from train's default of 400,000 and the scorer's 10,000; 5,000
# before phase 21 came, 2,000 before phase 23, 1,000 before phase 24),
# DeepSequence for 500 (cut: time; 2,000 before phase 23, 1,000 before
# phase 24), TranceptEVE on the first 512 of the
# 4,750 singles (cut: time), Potts at the scorer's 300 steps, WaveNet for
# 200 steps (cut: time; its default of 400 before phase 24)
TRAINER_SLICE = dict(checkpoint="Large", batch=32, eve_steps=500, profiled_steps=200,
                     deepsequence_steps=500, deepsequence_samples=2000, trancepteve_mutants=512,
                     eve_num_samples=20_000, potts_steps=300, wavenet_steps=200,
                     wavenet_profiled_steps=50)
# Card against CPU at phase 16's own sizes: the first TRAINER_CPU_STEPS
# Adam steps of EVE (lr 1e-4, batch 256 of 16,384 rows) and WaveNet (lr
# 1e-3, batch 32), every draw made on the CPU and handed to both sides. The
# losses agree to float32 sums in other orders (relative). A parameter
# moves by about lr a step, and float32 noise in its gradient moves that by
# ~lr * 1e-3, far below *_ATOL; but an entry whose gradient is within
# noise of 0 may step the other way (2 lr a step). So each parameter
# tensor is held on its own: the share of its entries beyond *_ATOL, its
# largest difference (2 lr a step), and the Frobenius norm of card - CPU
# over that of the CPU's update, which a wrong update of any tensor,
# however small, puts near 1
TRAINER_CPU_STEPS, TRAINER_CPU_SHARE, TRAINER_CPU_REL_UPDATE = 3, 1e-3, 1e-2
EVE_CPU_LOSS_RTOL, EVE_CPU_ATOL, EVE_CPU_MAX = 1e-5, 1e-6, 6e-4
WAVENET_CPU_LOSS_RTOL, WAVENET_CPU_ATOL, WAVENET_CPU_MAX = 1e-5, 1e-5, 6e-3
# the shapes of phase 17: phase 14's L=250 target, alignment and 4,750
# singles with a synonymous WT row, and phase 15's indel assay; every
# scorer at its defaults (GEMME 3 NJ trees of 512 rows; SiteRM GTR on
# 1,024 rows, 100 epochs, 20 rate categories, 129 taus; F81 on 2,048 rows,
# 200 steps; PROVEAN 200 candidates, up to 30 clusters of 5); ESCOTT also
# with a structure of the wrong length; PROVEAN's card against CPU on a
# spread of variants (the CPU's DP at full size takes minutes)
BASELINE_SLICE = dict(short_structure=240, provean_cpu_variants=24)
# Card against CPU at phase 17's own sizes. PROVEAN: every DP cell holds a
# small integer, so the scores are equal. GEMME: float64 tables whose
# weighted column sums and carrier minima run in another order. SiteRM
# GTR: float32 eigenvectors from cuSOLVER and LAPACK differ by rounding,
# and 100 Adam epochs carry that forward, as they carry float64 against
# float32 in the JAX package's own fit (tests/test_torch_siterm.py). F81:
# 200 float32 Adam steps on each side
PROVEAN_CPU_ATOL = 0.0
GEMME_CPU_ATOL = 1e-9
SITERM_Q_REL, SITERM_SCORE_ATOL, SITERM_SPEARMAN = 2e-2, 0.1, 0.999
F81_MU_RTOL = 1e-4


# the shapes of phase 18: phase 14's L=250 target, alignment and 4,750
# singles and every 2nd row of phase 15's 2,001-row indel assay (1,001
# with the WT; cut: time, all of them before phase 24); each AR family at its
# preset's full width and depth with seeded random weights; ProGen2-xlarge,
# RITA_xl and ProtGPT2 on the first 512 singles (cut: time; RITA_xl and
# ProtGPT2 on all 4,750 before phase 24, then all three on 1,024) and
# ProGen3-3b on the first 256 (cut: time);
# UniRep evotuned for 20 steps (100 before phase 24: each step is ~0.3 s of
# host work); 8 rows (4 sequences, both directions)
# held against the plain attention per transformer family
ZOO_SLICE = dict(batch=32, progen2_singles=512, progen3_singles=256, indel_stride=2,
                 evotune_steps=20,
                 logp_rows=4)
# (label, B, H, T, D) of the float32 K1 on the zoo's paths: the L=250 rows
# of ProGen2-xlarge, RITA_xl, ProtGPT2 and ProGen3-3b, and RITA_xl's indel
# bucket (rows of 394-406 residues)
K1_ZOO = (("progen2_xlarge", 32, 16, 256, 256), ("rita_xl", 32, 16, 256, 128),
          ("protgpt2", 32, 20, 256, 64), ("progen3_3b", 32, 24, 256, 96),
          ("rita_xl_indel", 32, 16, 416, 128))
# per-row mean log-likelihoods (the scores' scale), float32 K1 against the
# plain attention inside bf16 models: the two differ by float32 summation
# order (~1e-6 relative), which flips the bf16 rounding of a few attention
# outputs by one ulp (2^-8 relative); the residual stream carries that
# through up to 36 layers to ~1e-2 per token, as TABLE_ATOL allows for
# ESM's 33. A wrong mask, causal extent, head layout or rotation shifts
# them by O(1)
ZOO_LL_ATOL = 1e-1
# the shapes of phase 19: phase 14's L=250 target and 4,750 singles plus a
# synonymous WT row, and phase 5's L=1,100 target (16 singles); each model
# at its preset's full width and depth with seeded random weights; the
# helix of the target with seeded noise on every CA (an ideal helix ties
# the CA-CA distances of i - d and i + d, and the kNN cut falls inside a
# tied pair); 8 rows per transformer held against the plain attention
MLM_SLICE = dict(batch=32, long_length=1100, long_singles=16, long_batch=4, logp_rows=8,
                 ca_noise=0.01)
# (label, B, H, T, D, dtype, mode) of K1 on phase 19's paths: ESM-C-600M's
# rows bucketed to 256 tokens (252 live), xTrimoPGLM-1B's masked rows (252
# tokens, the window, no padding), xTrimoPGLM-3B's AR rows (251 tokens:
# [CLS] + 250 residues, the EOS dropped) and ESM3's (252, float32)
K1_MLM = (("esmc_600m", 32, 18, 256, 64, "bf16", "mask"),
          ("xtrimopglm_1b", 32, 16, 252, 128, "bf16", "mask"),
          ("xtrimopglm_3b_ar", 32, 20, 251, 128, "bf16", "causal"),
          ("esm3", 32, 24, 252, 64, "f32", "none"))
# masked log-prob rows, kernel vs plain attention: bf16 models as
# ZOO_LL_ATOL; ESM3 is float32 end to end, where the 3xTF32 kernel and the
# plain version differ by summation order (~1e-6 relative) through 48
# layers. A wrong mask or rotation shifts them by O(0.1-1)
MLM_BF16_ATOL, ESM3_LOGP_ATOL = 1e-1, 2e-3
# xTrimoPGLM-3B's AR rows, per-token target log-probs: the kernel and the
# plain attention round attention outputs to bf16 in different places, and
# 30 layers carry that to 0.137 per token at most over 8 x 250 tokens (a
# chip run of this script); each sits as far from a float32 copy of the
# model. So each token is held to XTRIMO_AR_TOKEN_ATOL, and the kernel's
# RMS error against float32 to XTRIMO_AR_F32_FACTOR times the plain
# version's. Averaged over a row, a leaked future key cancels to a few
# hundredths; per token it moves them by O(1)
XTRIMO_AR_TOKEN_ATOL, XTRIMO_AR_F32_FACTOR = 0.5, 2.0
# the structure codes' squared distances, card against CPU (both float32
# without TF32; |d2| ~ 1e2): summation order only. A token may flip only
# where its best code beats the second by less than TOKEN_MARGIN
TOKEN_D2_RTOL, TOKEN_MARGIN = 1e-4, 1e-2
# one CARP-640M forward in float32, card against CPU: summation order
# through 56 blocks (the convolution in cuDNN without TF32)
CARP_CPU_ATOL = 1e-3

# the shapes of phase 20: phase 14's L=250 target and 4,750 singles on its
# helix with seeded CA noise (as phase 19's); ESM-IF1 (8 + 8 layers, width
# 512, float32) on all singles and, on a two-helix complex (the target and
# a 120-residue helix 12 A off, 10 NaN spacers between them in the
# encoder), on the first 1,024 (cut: time); ProteinMPNN v_48_020 with 10
# orders on the first 2,048 singles (cut: time); SaProt-650M on all
# singles; 8 ESM-IF1 rows per token against the plain attention; the card
# against the CPU at full size on 4 ESM-IF1 rows, 4 ProteinMPNN (sequence,
# order) pairs and 2 masked SaProt-650M rows in float32
STRUCTURE_SLICE = dict(batch=32, ca_noise=0.01, partner_length=120, complex_singles=1024,
                       mpnn_singles=2048, mpnn_orders=10, logp_rows=8, cpu_rows=4,
                       saprot_cpu_rows=2)
# (label, B, H, T, D) of the float32 K1 on ESM-IF1's decoder rows: 250
# residues + <cath>, the last token dropped; causal with the PAD mask
K1_IF1 = ("esm_if1", 32, 8, 250, 64)
# (label, B, H, T, D) of K4 on SaProt-650M's rows: [CLS] + 250 + [EOS]
K4_SAPROT = ("saprot_650m", 32, 20, 252, 64)
# ESM-IF1's per-token log-probs, float32 K1 against the plain attention
# through 8 encoder and 8 decoder layers: summation order only, 2.4e-6 at
# most over 8 x 250 tokens on an H100 at 700 W (a chip run of this
# phase); a leaked next key or the causal mask left off moves them by 1.28
IF1_LOGP_ATOL = 1e-4
# card against CPU at full size, per element (float32 without TF32 on
# both; index_add_'s sums in another order on the card): ESM-IF1's and
# ProteinMPNN's log-probs, SaProt-650M's in a float32 copy; the same run
# read 3.3e-6, 3.8e-6 and 5.7e-6
IF1_CPU_ATOL, MPNN_CPU_ATOL, SAPROT_CPU_ATOL = 1e-4, 1e-4, 1e-4

# the shapes of phase 21: phase 14's L=250 target and 4,750 singles on phase
# 20's helix; ProSST-2048 (12 x 768, float32) with the 3Di k-means states
# and with its quantizer at the published size (node (256, 32), edge (64,
# 2), 6 layers; a seeded AE.pt and 2,048 seeded centroids); VenusREM over
# ProSST-2048 with a 16,384-row alignment of phase 14's generator over all
# 250 residues (its focus rows as long as the target, so the residue blend
# runs) and a 64-row structure alignment; MULAN-small (ESM2-35M, float32)
# on all singles; MIF and MIF-ST; each legacy method (ESM2-8M, bf16) on
# the first 320 singles (cut: time); MULAN-small per token on 8 rows; the
# card against the CPU on MULAN-small's first two batches and its ragged
# last one (4,750 = 148 x 32 + 14) and the quantizer's first 32 anchors
# (cuts: the CPU's time)
PLM_SLICE = dict(batch=32, n_seqs=16384, struct_aln_rows=64, legacy_singles=320, logp_rows=8,
                 mulan_cpu_batches=(0, 1, -1), quantizer_cpu_anchors=32)
# (label, B, H, T, D) of the float32 K4 on MULAN-small's trunk rows ([CLS] +
# 250 + [EOS], 20 heads of 24, pad mask + RoPE) and of the float32 K1 on its
# adapter's (the same rows, key mask, no positions)
K4_MULAN = ("f32_mulan", 32, 20, 252, 24)
K1_MULAN = ("f32_mulan_adapter", 32, 20, 252, 24)
# MULAN-small's per-token log-probs, float32 kernels against the plain
# attention through the adapter and 12 layers: summation order only, 1.7e-6
# at most over 8 x 252 tokens on an H100 at 700 W (a chip run of this
# phase); the adapter's last key tile skipped moves them by 3.6e-3
MULAN_LOGP_ATOL = 1e-4
# card against CPU at full size, per element, float32 without TF32 on
# both: ProSST-2048's log-probs, VenusREM's and MULAN-small's scores, MIF's
# and MIF-ST's logits (the same run read 2.9e-6, 4.8e-7, 2.0e-6, 7.5e-6 and
# 1.2e-5); the quantizer's pooled embeddings of unit norm (1.0e-7), and the
# margin under which two nearest centroids count as tied
PLM_CPU_ATOL, QUANT_EMB_ATOL, QUANT_MARGIN = 1e-4, 1e-5, 1e-4
# MIF's and MIF-ST's scores as the CLI gives them (bf16 feed-forwards)
# against the same bf16 module on the CPU: their bf16 products round apart,
# so the limit is this factor times the bf16 noise read in the same run,
# the CPU's bf16 scores' largest distance from those of a float32 copy
MIF_BF16_FACTOR = 2.0

# the shapes of phase 22: phase 14's L=250 target and its 4,750 singles on
# phase 20's helix, the PDB's B-factors 90 but 50 on residues 101-140 (both
# pLDDT branches of S2F / S3F run); ProtSSN's nine published (k, h) members
# over ESM2-650M with seeded statistics, one file per k; S2F and S3F at
# their published widths over ESM2-650M, S3F's surface 3,000 seeded points
# 2-4 A off the helix's CA atoms with 42 seeded features each; S3F-MSA and
# AIDO on phase 21's 16,384-row alignment of the whole target (K5 once, for
# S3F-MSA; AIDO reads its weights file); AIDO also on a seeded L=1,000
# target with all its singles (windows at 0 and 232: T=770); AIDO's
# per-token log-probs on 8 rows; the card against the CPU on ProtSSN
# k20_h512, S3F's node logits with its surface, S2F's scores and AIDO's
# table rows of one chunk
SLICE_C = dict(batch=32, n_seqs=16384, low_plddt=(100, 140), surface_points=3000,
               surface_features=42, long_length=1000, logp_rows=8,
               protssn_cpu="protssn_k20_h512")
# (label, B, H, T, D) of AIDO's bf16 K1: [CLS] + 250 + [EOS], and a
# 768-residue window; every key live, the default scale through the pre-pass
K1_AIDO = (("aido_T252", 32, 8, 252, 64), ("aido_T770", 32, 8, 770, 64))
# AIDO's per-token log-probs, bf16 K1 against the plain attention through 8
# layers, the kernel run's expert routing replayed in the others: a router
# near-tie, which one bf16 ulp flips, moves a token by up to 0.275 (the
# GPU test's 2 layers; 0.066 here), as much as a planted fault, so the
# check compares the attention alone. With the replay the bf16 rounding
# of the outputs remains: 1.13e-2 on an H100 at 700 W (a chip run of this
# phase), the last key tile skipped 0.186
AIDO_LOGP_ATOL = 5e-2
# card against CPU at full size, per element, float32 without TF32 on both
# (index_add_'s sums in another order on the card): S3F's node logits with
# its surface, S2F's scores (a chip run of this phase read 3.2e-6 and
# 4.3e-6; one edge out of residue 60 dropped moved S3F's logits by 2.4e-2
# and S2F's scores by 5.1e-2)
SLICE_C_CPU_ATOL = 1e-4
# ProtSSN k20_h512's logits, card against CPU, per element within this
# share of their largest magnitude: on seeded random weights the features
# grow through the six residual layers (messages summed over ~20 edges), so
# log(softmax + 1e-9) saturates at 0 and log(1e-9) and hides any fault;
# the logits are held instead (the same run: 3.6e-2 of 1.38e4, one edge
# dropped 516)
PROTSSN_CPU_RTOL = 1e-5
# AIDO's table rows (bf16) against the same bf16 module on the CPU, the
# card's routing replayed: this factor times the bf16 noise read in the same
# run (the CPU's bf16 rows' largest distance from a float32 copy's)
AIDO_BF16_FACTOR = 2.0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check_close(name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    max_err = float(err.max())
    bad = err > atol + rtol * want.abs()
    status = "ok" if not bool(bad.any()) else "MISMATCH"
    print(f"  {name:<44s} max_abs_err={max_err:.3e} "
          f"(atol={atol:g}, rtol={rtol:g}) {status}")
    if status != "ok":
        fail(f"{name}: {int(bad.sum())} elements outside tolerance")
    return max_err


def time_ms(torch, fn, reps, inner=10):
    """Device milliseconds per call (CUDA events around ``inner`` queued
    calls, so the host's launch overhead hides behind the device work),
    one entry per sample."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return out


def check_launches(what, launches, want):
    """Fail unless a run launched exactly ``want`` ({counter: n}) and no
    other kernel; the layer norm's count is held only where ``want`` names
    it (every bf16 model on the card launches it)."""
    full = {name: want.get(name, launches[name] if name == "layer_norm" else 0)
            for name in launches}
    if launches != full:
        fail(f"{what}: launch counts {launches}, expected {full}")


def esm_norms(config):
    """Layer-norm launches of one bf16 ESM forward on the card: two a layer,
    the final norm and the LM head's."""
    return 2 * config.num_layers + 2


def saved_launches(*counters):
    """The launch counters ``counters`` with copies of their counts, for
    ``restore_launches``."""
    return [(counts, dict(counts)) for counts in counters]


def restore_launches(saved):
    """Set the counters of ``saved_launches`` back: the launches since were
    a check's, not the path's."""
    for counts, kept in saved:
        counts.update(kept)


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time the card could take for work of ``flops`` operations
    at ``peak`` per second (bf16 unless given) and ``nbytes`` of memory
    traffic, and which side sets it."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sdpa(torch, q, k, v, mask):
    """One PyTorch call computing the attention function of the kernels on
    pre-rotated, pre-scaled (B, H, T, D) q/k/v with a boolean mask
    (True = attend): the yardstick, timed here and never used by the port."""
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                    scale=1.0)


def sdpa_backend(torch, fn):
    """The backend SDPA's default dispatch took, read from the names of the
    kernels one call launches (torch.profiler): math when they are products
    and a softmax, else the name of the costliest."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                         key=lambda e: -e.device_time_total)
    except Exception as e:  # the profiler is a reading aid here, not a check
        return f"not read ({type(e).__name__})"
    if not kernels:
        return "not read (no kernel events)"
    text = " ".join(e.key for e in kernels).lower()
    for key, label in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                       ("efficient", "efficient"), ("softmax", "math"),
                       ("cutlass", "efficient")):
        if key in text:
            return label
    return f"kernel {kernels[0].key[:48]}"


def synth_assay(seq_len: int, seed: int):
    rs = np.random.RandomState(seed)
    seq = "".join(AA[i] for i in rs.randint(0, 20, seq_len))
    mutants = [f"{seq[p]}{p + 1}{m}" for p in range(seq_len) for m in AA
               if m != seq[p]]
    return seq, mutants


def write_assays(root: Path, assays, msa_columns=None):
    """A reference CSV plus one DMS CSV per (DMS_id, seq, mutants);
    ``msa_columns`` ({column: value}) adds the alignment columns."""
    msa_columns = msa_columns or {}
    dms_dir = root / "dms"
    dms_dir.mkdir()
    ref = root / "reference.csv"
    with open(ref, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    *msa_columns])
        for dms_id, seq, _ in assays:
            w.writerow([dms_id, f"{dms_id}.csv", "SYNTH", seq, len(seq),
                        *msa_columns.values()])
    rs = np.random.RandomState(0)
    for dms_id, _, mutants in assays:
        with open(dms_dir / f"{dms_id}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["mutant", "DMS_score"])
            for m in mutants:
                w.writerow([m, f"{rs.randn():.6f}"])
    return ref, dms_dir


def run_cli(cli, ref, dms_dir, out_dir, checkpoint, batch_size):
    rc = cli.main([
        "score", "--model", "esm", "--checkpoint", checkpoint,
        "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
        "--output-dir", str(out_dir), "--batch-size", str(batch_size),
        "--device", "cuda", "--quiet", "--fail-fast",
    ])
    if rc != 0:
        fail(f"CLI exited {rc} for {checkpoint}")


def read_scores(path: Path, column: str, n_expected: int) -> np.ndarray:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != n_expected:
        fail(f"{path.name}: {len(rows)} rows, expected {n_expected}")
    if any(not row.get(column) for row in rows):
        fail(f"{path.name}: column {column} missing or empty")
    scores = np.asarray([float(row[column]) for row in rows])
    if not np.isfinite(scores).all():
        fail(f"{path.name}: non-finite scores")
    return scores


def synth_family(focus: np.ndarray, n: int, seed: int) -> np.ndarray:
    """(n, L) int8 codes (0 = gap, 1..20 = amino acid) of a seeded
    synthetic family of ``focus``: cluster centres at 20-60% substitution,
    members at 0-15% from their centre, up to three gap runs of up to 30
    columns per row, so that neighbour counts vary. Row 0 is ``focus``."""
    rs = np.random.RandomState(seed)
    length = len(focus)
    n_centres = max(1, n // 16)
    centres = np.tile(focus, (n_centres, 1))
    sub = rs.rand(n_centres, length) < rs.uniform(0.2, 0.6, (n_centres, 1))
    centres[sub] = rs.randint(1, 21, sub.sum())
    rows = centres[rs.randint(0, n_centres, n)]
    sub = rs.rand(n, length) < rs.uniform(0.0, 0.15, (n, 1))
    rows[sub] = rs.randint(1, 21, sub.sum())
    cols = np.arange(length)[None, :]
    for _ in range(3):
        start = rs.randint(0, length, (n, 1))
        rows[(cols >= start) & (cols < start + rs.randint(0, 31, (n, 1)))] = 0
    rows[0] = focus
    return rows.astype(np.int8)


def write_a2m(path: Path, name: str, codes: np.ndarray) -> None:
    lut = np.frombuffer(GAP_AA.encode(), dtype=np.uint8)
    length = codes.shape[1]
    with open(path, "w") as f:
        for i, row in enumerate(codes):
            head = f">{name}/1-{length}" if i == 0 else f">{name}_hom{i}/1-{length}"
            f.write(f"{head}\n{bytes(lut[row.astype(np.int64)]).decode()}\n")


def median_pair(torch, fns, reps, inner, rounds=2):
    """Medians of ``time_ms`` samples for each named call, taken in turns
    (a, b, ..., b, a) ``rounds`` times so drift hits all alike."""
    for fn in fns.values():  # warm up
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]) * rounds:
        for which in order:
            times[which] += time_ms(torch, fns[which], reps, inner)
    return {k: statistics.median(v) for k, v in times.items()}


def n_chunk_forwards(seq_len, chunk, pad_to_multiple=64):
    """Forwards masked_marginal_table runs for L residues (L+2 tokens), on
    the short and the windowed path alike: rows bucketed to the pad
    multiple, then cut into chunks."""
    total = seq_len + 2
    rows = -(-total // pad_to_multiple) * pad_to_multiple
    return -(-rows // chunk)


def phase_cluster_counts(torch, dev, card):
    """6. K5 against its plain version, counts equal exactly, on ragged
    alignments and at the three timed shapes; each timed shape beside its
    plain version, bounds, TOP/s and peak memory."""
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import _build

    print("[cluster_counts] K5 vs plain num_cluster_members on the card (exact)")
    for line in _build.build_log("cluster_counts").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas cluster_counts:", line.strip())
    rs = np.random.RandomState(0)
    for n, length, seed in ((1000, 123, 1), (4099, 300, 2), (77, 9, 3)):
        codes = synth_family(rs.randint(1, 21, length), n, seed)
        codes[3] = 0  # an all-gap row
        codes[7] = codes[8]  # duplicated rows
        codes[9, :5] = 21  # indeterminate codes: never match, count as non-gap
        m = torch.from_numpy(codes).to(dev)
        got = W.num_cluster_members_cuda(m, 0.8)
        same = torch.equal(got, W.num_cluster_members(m, 0.8)) and torch.equal(
            got.cpu(), W.num_cluster_members(torch.from_numpy(codes), 0.8))
        print(f"  N={n:<5d} L={length:<3d} counts {int(got.min())}..{int(got.max())}: "
              f"{'equal to the plain version (card bf16 and CPU float32)' if same else 'MISMATCH'}")
        if not same:
            fail(f"cluster counts differ from the plain version at N={n}, L={length}")

    shapes = []
    for idx, (n, length) in enumerate(K5_TIMED):
        codes = synth_family(np.random.RandomState(5 + idx).randint(1, 21, length), n, 6 + idx)
        m = torch.from_numpy(codes).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        got = W.num_cluster_members_cuda(m, 0.8)
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
        if not torch.equal(got, W.num_cluster_members(m, 0.8)):
            fail(f"cluster counts differ from the plain version at N={n}, L={length}")
        counts = got.cpu().numpy()
        neff = float(np.sum(1.0 / counts[counts > 0]))
        reps, inner, rounds = (3, 3, 2) if n <= 16384 else (2, 2, 1)
        t = median_pair(torch, {
            "kernel": lambda: W.num_cluster_members_cuda(m, 0.8),
            "plain": lambda: W.num_cluster_members(m, 0.8),
        }, reps=reps, inner=inner, rounds=rounds)
        # the upper-triangle one-hot Gram (20 L per pair, 2 operations per
        # multiply-add) on the int8 tensor cores, and in bf16 beside it;
        # the bytes: the codes read once, the counts written once
        ops = n * (n + 1) / 2 * 20 * length * 2
        b = bound(ops, nbytes(m) + 4 * n, PEAK_INT8_OPS)
        bf16_ms = bound(ops, nbytes(m) + 4 * n)["bound_ms"]
        tops = ops / t["kernel"] / 1e9
        samples = 2 * rounds * reps
        print(f"  N={n} L={length}: counts {int(counts.min())}..{int(counts.max())}, "
              f"Neff {neff:.1f}, equal to the plain version; kernel {t['kernel']:.4f} ms "
              f"({tops:.1f} TOP/s, {tops / PEAK_INT8_OPS * 1e12:.1%} of the int8 peak), "
              f"plain {t['plain']:.4f} ms, bound {b['bound_ms']:.4f} ms int8 "
              f"({b['bound_by']}), {bf16_ms:.4f} ms bf16; peak device memory of the call "
              f"{peak_mib:.1f} MiB (medians of {samples} samples of {inner} queued calls, "
              f"{card})")
        shapes.append({"shape": f"N={n} L={length}", "ms": t["kernel"], "plain_ms": t["plain"],
                       **b, "peak_mib": peak_mib})
        if idx == 0:  # cuBLAS's int8 Gram of the full square, on the kernel's one-hot
            onehot = W.one_hot_nogap(m.to(torch.int32))
            try:
                int_mm = median_pair(torch, {"int_mm": lambda: torch._int_mm(onehot, onehot.t())},
                                     reps=3, inner=3)["int_mm"]
                print(f"  reading aid, not K5's function: torch._int_mm(onehot, onehot.T), the "
                      f"full {n} x {n} int32 Gram, {int_mm:.4f} ms "
                      f"({2 * n * n * onehot.shape[1] / int_mm / 1e9:.1f} TOP/s on "
                      f"K_pad={onehot.shape[1]}; {card})")
            except RuntimeError as e:  # a reading aid, not a check
                int_mm = None
                print(f"  torch._int_mm not run: {e}")
            del onehot
            torch.cuda.empty_cache()
        del m, got
    first = shapes[0]
    return {"ms": first["ms"], "plain_ms": first["plain_ms"], "library_ms": None,
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "peak_mib": first["peak_mib"], "int_mm_full_square_ms": int_mm,
            "other_shapes": shapes[1:]}


def phase_layer_norm(torch, dev, card):
    """25. The layer-norm kernel against its plain version at the timed
    shapes (the sum bit for bit, the norm within one bf16 ulp, or 2^-16
    where the affine cancels), then each timed beside the plain chain and
    the bytes bound; the host's microseconds a call."""
    from proteingym_tpu_torch.ops import _build
    from proteingym_tpu_torch.ops import layer_norm as ln

    print("[layer_norm] the bf16 layer norm (+ residual add) vs its plain version on the card")
    for line in _build.build_log("layer_norm").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas layer_norm:", line.strip())
    gen = torch.Generator(device=dev).manual_seed(25)
    max_err = 0.0
    shapes = []
    for rows, d, add in LN_TIMED:
        x = (torch.randn(rows, d, generator=gen, device=dev)
             + torch.randn(rows, 1, generator=gen, device=dev) * 4).to(torch.bfloat16)
        delta = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
        w = 1 + 0.5 * torch.randn(d, generator=gen, device=dev)
        b = 0.5 * torch.randn(d, generator=gen, device=dev)
        if add:
            kernel = lambda: ln.add_layer_norm(x, delta, w, b)
            plain = lambda: ln.plain_add_layer_norm(x, delta, w, b)
            s, y = kernel()
            want_s, want = plain()
            if not torch.equal(s, want_s):
                fail(f"layer_norm {rows} x {d}: the fused sum is not the bf16 add")
        else:
            kernel = lambda: ln.layer_norm(x, w, b)
            plain = lambda: ln.plain_layer_norm(x, w, b)
            y, want = kernel(), plain()
        g, wf = y.float(), want.float()
        big = torch.maximum(g.abs(), wf.abs()).clamp(min=2.0 ** -100)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7).clamp(min=2.0 ** -16)
        off = int(((g - wf).abs() > ulp).sum())
        differ = float((g != wf).float().mean())
        max_err = max(max_err, float((g - wf).abs().max()))
        if off:
            fail(f"layer_norm {rows} x {d}: {off} elements beyond one bf16 ulp of the plain version")
        t = median_pair(torch, {"kernel": kernel, "plain": plain}, reps=5, inner=20, rounds=2)
        per_elem = 8 if add else 4  # bf16 in and out: x (+ delta), y (+ the sum)
        moved = rows * d * per_elem + 2 * 4 * d
        bd = bound(0, moved)
        tb_s = moved / t["kernel"] / 1e9
        print(f"  {rows} x {d}{' + add' if add else ''}: kernel {t['kernel']:.4f} ms "
              f"({tb_s:.3f} TB/s, {tb_s / (PEAK_BYTES_PER_S / 1e12):.1%} of 3.35), plain chain "
              f"{t['plain']:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({moved / 1e6:.1f} MB); {differ:.2e} of the outputs one ulp off the plain "
              f"version (medians of 20 samples of 20 queued calls, {card})")
        shapes.append({"shape": f"{rows} x {d}{' + add' if add else ''}", "ms": t["kernel"],
                       "plain_ms": t["plain"], "library_ms": None, **bd,
                       "share_of_bytes_peak": tb_s / (PEAK_BYTES_PER_S / 1e12),
                       "ulp_off_share": differ})
        del x, delta, y, want

    # the host's side: calls queued on rows the device finishes in a moment
    x = torch.randn(256, 1280, generator=gen, device=dev).to(torch.bfloat16)
    w, b = torch.ones(1280, device=dev), torch.zeros(1280, device=dev)
    host = {}
    for name, fn in (("kernel", lambda: ln.layer_norm(x, w, b)),
                     ("kernel + add", lambda: ln.add_layer_norm(x, x, w, b)),
                     ("plain", lambda: ln.plain_layer_norm(x, w, b)),
                     ("plain + add", lambda: ln.plain_add_layer_norm(x, x, w, b))):
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            samples.append((time.perf_counter() - t0) / 200 * 1e6)
        host[name] = statistics.median(samples)
    print("  host us a call (256 x 1,280, median of 5 x 200): "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()) + f" ({card})")
    first = shapes[0]
    return {"max_abs_err": max_err, **{k: first[k] for k in first if k != "shape"},
            "shape": first["shape"], "other_shapes": shapes[1:], "host_us": host}


def phase_long_attention(torch, dev, card, fa, qkv, lengths_mask, check_close):
    """7. K2 against the plain version; K1 at PoET's self-tier shape; both
    checked and timed at PoET's row shape."""
    print("[flash_attention] K2 (Hopper loop in bf16, 3xTF32 kernel in float32) vs plain "
          "reference_mha on the card")

    def compare(name, q, k, v, atol, rtol, **kw):
        got = fa.flash_mha(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.reference_mha(q.float(), k.float(), v.float(), **kw)
        return check_close(name, got, want, atol, rtol)

    errs = []
    for dtype, atol, rtol, tag in ((torch.bfloat16, BF16_ATOL, BF16_RTOL, "bf16"),
                                   (torch.float32, F32_ATOL, F32_RTOL, "f32")):
        for t, lengths in ((2048, [2048, 1711]), (4352, [4352, 4100])):
            q, k, v = qkv(2, 4, t, 64, dtype)
            errs.append(compare(f"{tag} causal + mask T={t}", q, k, v, atol, rtol,
                                key_mask=lengths_mask(2, t, lengths), causal=True))
        q, k, v = qkv(1, 8, 1536, 64, dtype)
        slopes = 2.0 ** (-8.0 * torch.arange(1, 9, device=dev) / 8)
        alibi = slopes[:, None] * torch.arange(1536, device=dev)[None, :]
        errs.append(compare(f"{tag} ALiBi bias + causal T=1536", q, k, v, atol, rtol,
                            bias=alibi, causal=True))
        q, k, v = qkv(2, 4, 1100, 32, dtype)
        errs.append(compare(f"{tag} T=1100 (not a multiple of 64) D=32 mask", q, k, v,
                            atol, rtol, key_mask=lengths_mask(2, 1100, [1100, 901])))
        q, k, v = qkv(2, 4, 1037, 128, dtype)
        dead = torch.ones(2, 1037, dtype=torch.bool, device=dev)
        dead[1] = False  # every key of batch row 1 masked
        dead[0, :7] = False  # the first 7 queries of row 0 see no live key
        errs.append(compare(f"{tag} fully masked rows, causal T=1037 D=128", q, k, v,
                            atol, rtol, key_mask=dead, causal=True))
    max_abs_err = max(errs)

    print("[grouped_attention] K1 at PoET's self-tier shape: segmented + causal + RoPE")
    b, h, t = POET_ROW

    def segments(b):
        # 16 segments of ragged lengths per row, then 40 padding tokens
        seg = torch.zeros(b, t, dtype=torch.int32, device=dev)
        rs = np.random.RandomState(b)
        for i in range(b):
            cuts = np.sort(rs.choice(np.arange(100, t - 140), 15, replace=False))
            for s_id, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, t - 40]), start=1):
                seg[i, lo:hi] = s_id
        return seg

    q, k, v = qkv(1, 8, t, 64)
    self_kw = dict(segment_ids=segments(1), causal=True, rope_base=10000.0)
    got = fa.grouped_mha(q, k, v, **self_kw)
    torch.cuda.synchronize()
    want = fa.plain_mha(q.float(), k.float(), v.float(), **self_kw)
    live = self_kw["segment_ids"] > 0  # padding rows are never consumed
    k1_self_err = check_close(f"bf16 B1 H8 T{t}, 16 segments (live rows)",
                              got.transpose(1, 2)[live], want.transpose(1, 2)[live],
                              BF16_ATOL, BF16_RTOL)

    d = 64
    q, k, v = qkv(b, h, t, d)
    # PoET's multi tier: each row its own valid length; row 5's first 300
    # keys masked too, so its first rows see no live key (K2's rule)
    mask = lengths_mask(b, t, [t - 7 * i for i in range(b)])
    mask[5, :300] = False
    tiles = fa.KeyTiles(key_mask=mask, causal=True)  # PoET's forward shares one
    k2_kw = dict(key_mask=mask, causal=True, key_tiles=tiles)
    # the timed calls, held against the plain version on every row, one batch
    # row at a time: the loop alone (q pre-scaled, no pre-pass) and PoET's
    # call (default scale: the pre-pass scales q)
    for name, scale in (("loop, sm_scale 1", 1.0), ("call, pre-pass scales q", None)):
        got = fa.flash_mha(q, k, v, sm_scale=scale, **k2_kw).float()
        torch.cuda.synchronize()
        want = torch.cat([fa.reference_mha(*(x[i:i + 1].float() for x in (q, k, v)),
                                           key_mask=mask[i:i + 1], causal=True, sm_scale=scale)
                          for i in range(b)])
        max_abs_err = max(max_abs_err, check_close(
            f"bf16 B{b} H{h} T{t} per-row lengths, {name}", got, want, BF16_ATOL, BF16_RTOL))
        del got, want
    causal_mask = mask[:, None, None, :] & torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    # a row with no live key averages v over all T keys: SDPA gets all T
    # keys there (the same work; its weights are the softmax's, not uniform)
    causal_mask |= ~causal_mask.any(dim=-1, keepdim=True)
    k2t = median_pair(torch, {
        "kernel": lambda: fa.flash_mha(q, k, v, sm_scale=1.0, **k2_kw),
        "plain": lambda: fa.reference_mha(q, k, v, key_mask=mask, causal=True, sm_scale=1.0),
        "sdpa": sdpa(torch, q, k, v, causal_mask),
        "call": lambda: fa.flash_mha(q, k, v, **k2_kw),
    }, reps=2, inner=3)
    # SDPA's fused causal kernel on the same q/k/v: K2's function on live
    # rows without padding keys, not on padded or dead rows; a reading aid
    causal_fn = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=1.0)
    sdpa_causal = median_pair(torch, {"sdpa_causal": causal_fn}, reps=2, inner=3)["sdpa_causal"]
    # pairs a row attends: the live keys at or before it, or all T keys for
    # a row that has none
    pairs = float(causal_mask.sum()) * h
    k2b = bound(4 * d * pairs, nbytes(q, k, v, q, mask))
    print(f"  K2 at B{b} H{h} T{t} D64, causal + per-row mask: Hopper loop {k2t['kernel']:.4f} "
          f"ms, plain {k2t['plain']:.4f} ms, SDPA {k2t['sdpa']:.4f} ms "
          f"({sdpa_backend(torch, sdpa(torch, q, k, v, causal_mask))}), bound "
          f"{k2b['bound_ms']:.4f} ms ({k2b['bound_by']}); the call with the pre-pass "
          f"{k2t['call']:.4f} ms (medians of 8 samples of 3 queued calls, {card})")
    print(f"  SDPA is_causal=True on the same q/k/v (no key mask: not K2's function on padded "
          f"rows) {sdpa_causal:.4f} ms ({sdpa_backend(torch, causal_fn)}, {card})")
    del causal_mask
    seg = segments(b)
    # one KeyTiles for every call, as PoET's forward shares one by its layers
    tiles = fa.KeyTiles(seg, causal=True)
    self_kw = dict(segment_ids=seg, causal=True, rope_base=10000.0, key_tiles=tiles)
    # the loop alone on q/k the pre-pass rotated and scaled, as SDPA gets them
    qr, kr = fa.rope_qk(q, k, 1.0 / d ** 0.5, 10000.0)
    loop_kw = dict(segment_ids=seg, causal=True, sm_scale=1.0, key_tiles=tiles)
    self_mask = ((seg[:, :, None] == seg[:, None, :])[:, None]
                 & torch.ones(t, t, dtype=torch.bool, device=dev).tril())
    k1t = median_pair(torch, {
        "kernel": lambda: fa.grouped_mha(qr, kr, v, **loop_kw),
        "plain": lambda: fa.plain_mha(qr, kr, v, **loop_kw),
        "sdpa": sdpa(torch, qr, kr, v, self_mask),
        "call": lambda: fa.grouped_mha(q, k, v, **self_kw),
    }, reps=2, inner=3)
    # the timed call, held against the plain version on live rows, one batch
    # row at a time: each row has its own cuts and so its own extents
    got = fa.grouped_mha(q, k, v, **self_kw).float()
    torch.cuda.synchronize()
    want = torch.cat([fa.plain_mha(*(x[i:i + 1].float() for x in (q, k, v)),
                                   segment_ids=seg[i:i + 1], causal=True, rope_base=10000.0)
                      for i in range(b)])
    live = seg > 0
    k1_self_err = max(k1_self_err, check_close(
        f"bf16 B{b} H{h} T{t}, own 16 segments per row (live rows)",
        got.transpose(1, 2)[live], want.transpose(1, 2)[live], BF16_ATOL, BF16_RTOL))
    del got, want
    lo, hi = tiles.extents(b, t, dev)
    runs = torch.unique_consecutive(seg[seg > 0].view(-1), return_counts=True)[1].double()
    k1b = bound(4 * d * h * float((runs * (runs + 1) / 2).sum()), nbytes(q, k, v, q, seg))
    print(f"  K1 at B{b} H{h} T{t} D64, 16 segments + causal: Hopper loop {k1t['kernel']:.4f} ms "
          f"({(hi - lo).float().mean().item():.2f} of {-(-t // fa.KERNEL_TILE)} key tiles per "
          f"128-query tile), plain {k1t['plain']:.4f} ms, SDPA {k1t['sdpa']:.4f} ms "
          f"({sdpa_backend(torch, sdpa(torch, qr, kr, v, self_mask))}), bound "
          f"{k1b['bound_ms']:.4f} ms ({k1b['bound_by']}); the call with RoPE (pre-pass + loop) "
          f"{k1t['call']:.4f} ms ({card})")
    del q, k, v, qr, kr, self_mask
    torch.cuda.empty_cache()
    return {"max_abs_err": max_abs_err, "ms": k2t["kernel"], "plain_ms": k2t["plain"],
            "library_ms": k2t["sdpa"], **k2b, "call_ms": k2t["call"],
            "sdpa_causal_ms": sdpa_causal, "k1_self_err": k1_self_err,
            "k1": {"ms": k1t["kernel"], "plain_ms": k1t["plain"], "library_ms": k1t["sdpa"],
                   "call_ms": k1t["call"], **k1b}}


def phase_poet(torch, dev, card, fa, check_close):
    """8. The PoET slice through the port's CLI: weights on K5, then
    scoring with K1 (self tier) and K2 (multi tier) in every layer."""
    from proteingym_tpu_torch.models import poet
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.msa.parser import load_msa
    from proteingym_tpu_torch.pipeline import cli

    preset = POET_SLICE["preset"]
    config = poet.POET_PRESETS[preset]
    length, n_seqs, n_mut, batch, n_samples, max_tokens = (POET_SLICE[k] for k in (
        "length", "n_seqs", "n_mut", "batch", "n_samples", "max_context_tokens"))
    print(f"[poet] weights, then score --model poet --checkpoint {preset}: L={length}, "
          f"{n_mut} single mutants, MSA N={n_seqs}")
    rs = np.random.RandomState(7)
    focus = rs.randint(1, 21, length)
    seq = "".join(GAP_AA[c] for c in focus)
    mutants, mutated = [], []
    for p in sorted(rs.choice(length, n_mut, replace=False)):
        aa = rs.choice([a for a in AA if a != seq[p]])
        mutants.append(f"{seq[p]}{p + 1}{aa}")
        mutated.append(seq[:p] + aa + seq[p + 1:])

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        msa_dir, weights_dir, out_dir = root / "msa", root / "weights", root / "out"
        msa_dir.mkdir()
        write_a2m(msa_dir / "SYNTH.a2m", "SYNTH", synth_family(focus, n_seqs, 8))
        ref, dms_dir = write_assays(root, [("SYNTH_POET", seq, mutants)], {
            "MSA_filename": "SYNTH.a2m", "MSA_start": 1, "MSA_end": length,
            "MSA_theta": 0.2, "weight_file_name": "SYNTH.npy",
        })
        wfile = weights_dir / "SYNTH.npy"

        for counts in (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES):
            for name in counts:
                counts[name] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(["weights", "--msa", str(msa_dir / "SYNTH.a2m"), "--theta", "0.2",
                       "--output", str(wfile), "--device", "cuda"])
        weights_s = time.perf_counter() - t0
        if rc != 0 or not wfile.exists():
            fail(f"weights CLI exited {rc}, file written: {wfile.exists()}")
        k5_launches, stamp = W.LAUNCHES["cluster_counts"], wfile.stat().st_mtime_ns
        t0 = time.perf_counter()
        rc = cli.main([
            "score", "--model", "poet", "--checkpoint", preset,
            "--msa-dir", str(msa_dir), "--weights-dir", str(weights_dir),
            "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
            "--output-dir", str(out_dir), "--batch-size", str(batch),
            "--device", "cuda", "--quiet", "--fail-fast",
            "--extra", f"max_context_tokens={max_tokens}", f"n_context_samples={n_samples}",
        ])
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if rc != 0:
            fail(f"poet score CLI exited {rc}")
        if W.LAUNCHES["cluster_counts"] != k5_launches or wfile.stat().st_mtime_ns != stamp:
            fail("the score run recomputed the weights instead of reusing the file")
        scores = read_scores(out_dir / "SYNTH_POET.csv", "PoET_score", n_mut)
        msa = load_msa(msa_dir / "SYNTH.a2m")
        weights = np.load(wfile)

    n_fwd = n_samples * -(-n_mut // batch)
    expected = config.num_layers * n_fwd
    print(f"  weights CLI {weights_s:.2f} s (parse + K5); score CLI wall {wall:.2f} s incl. "
          f"weight init and MSA load; peak device memory {peak_gib:.2f} GiB")
    print(f"  launches {launches} (expected {config.num_layers} layers x {n_fwd} forwards "
          f"= {expected} each for K1 and K2, twice that of their rope_qk pre-pass, >= 1 "
          f"cluster_counts)")
    if (launches["flash_attention"] != expected or launches["grouped_attention"] != expected
            or launches["rope_qk"] != 2 * expected or launches["cluster_counts"] < 1
            or launches["seg_block_attention"] or launches["grouped_attention_bthd"]):
        fail(f"launch counts {launches} do not match the slice")

    model = poet.init_random(config, seed=0, device=dev)
    msa_seqs = msa.sequences()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rescored = poet.score_assay_poet(model, mutated, msa_seqs, weights,
                                     max_context_tokens=max_tokens, n_context_samples=n_samples,
                                     batch_size=batch)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if not np.allclose(rescored, scores, atol=1e-4):
        fail("PoET scores recomputed outside the CLI differ from the CLI's")
    ctx = poet.sample_context(msa_seqs, weights, max_tokens, 0)
    tok, seg, pos, val, _ = (torch.from_numpy(a).to(dev)
                             for a in poet.build_rows(ctx, mutated[:2]))
    print(f"  scoring {score_s:.3f} s -> {n_mut / score_s:.2f} mutants/s; rows of "
          f"T={tok.shape[1]} tokens ({len(ctx)} context sequences + the query), "
          f"N={len(weights)} Neff={weights.sum():.1f} ({card})")
    got = poet.token_logprobs(model, tok, seg, pos, val)
    with mock.patch.object(poet, "mha", fa.plain_mha):
        want = poet.token_logprobs(model, tok, seg, pos, val)
    live = val[:, 1:].bool()
    check_close(f"2 queries' per-token log-probs, T={tok.shape[1]}, kernels vs plain",
                got[live], want[live], POET_LOGP_ATOL, 0.0)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "mutants_per_s": n_mut / score_s}


def segment_runs(torch, dev, b, t, bounds):
    """(b, t) int32 segment ids: segment i + 1 on [bounds[i], bounds[i+1])."""
    seg = torch.zeros(b, t, dtype=torch.int32, device=dev)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, lo:hi] = i + 1
    return seg


def phase_k3_k4(torch, dev, card, fa, qkv, lengths_mask, check_close):
    """9. K3 and K4 against their plain versions (live query rows) in bf16
    and float32; K3 timed at the packed-row shape, K4 at the headline."""
    print("[seg_block_attention] K3 (Hopper loop in bf16, 3xTF32 kernel in float32) vs plain "
          "seg_block_mha on the card (live rows)")
    k3_errs = []
    for dtype, atol, rtol, tag in ((torch.bfloat16, BF16_ATOL, BF16_RTOL, "bf16"),
                                   (torch.float32, F32_ATOL, F32_RTOL, "f32")):
        cases = [  # name, (B, H, T, D), segment bounds, keyword arguments
            ("segments across tiles + padded tail", (2, 4, 512, 64), [0, 200, 310, 470], {}),
            ("one segment spanning the row, RoPE", (2, 4, 512, 64), [0, 512],
             {"rope_base": 10000.0}),
            ("T=1100 (ragged tile) D=32, RoPE", (2, 4, 1100, 32), [0, 90, 91, 500, 1037],
             {"rope_base": 10000.0}),
            ("T=4096, 16 x 250 + tail, RoPE", (1, 4, 4096, 64), list(range(0, 4001, 250)),
             {"rope_base": 10000.0}),
        ]
        for name, (b, h, t, d), bounds, kw in cases:
            q, k, v = qkv(b, h, t, d, dtype)
            seg = segment_runs(torch, dev, b, t, bounds)
            got = fa.seg_block_mha(q, k, v, seg, **kw)
            torch.cuda.synchronize()
            want = fa.plain_seg_block_mha(q.float(), k.float(), v.float(), seg, **kw)
            live = seg > 0
            k3_errs.append(check_close(f"{tag} {name}", got.transpose(1, 2)[live],
                                       want.transpose(1, 2)[live], atol, rtol))
        # mha (T > 1024, not causal) hands the key mask over as its own operand
        q, k, v = qkv(2, 4, 1152, 64, dtype)
        seg = segment_runs(torch, dev, 2, 1152, [0, 300, 700, 1100])
        mask = seg > 0
        mask[1, 650:700] = False
        before = fa.LAUNCHES["seg_block_attention"]
        got = fa.mha(q, k, v, key_mask=mask, segment_ids=seg, rope_base=10000.0)
        torch.cuda.synchronize()
        if fa.LAUNCHES["seg_block_attention"] != before + 1:
            fail("mha did not route the segmented T=1152 call to K3")
        want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask, segment_ids=seg,
                            rope_base=10000.0)
        k3_errs.append(check_close(f"{tag} mha T=1152, segments + key mask",
                                   got.transpose(1, 2)[mask], want.transpose(1, 2)[mask],
                                   atol, rtol))

    print("[grouped_attention_bthd] K4 vs plain grouped_mha_bthd on the card")

    def bthd(b, h, t, d, dtype=torch.bfloat16):
        return tuple(x.transpose(1, 2) for x in qkv(b, h, t, d, dtype))

    k4_errs = []
    dead = torch.ones(2, 100, dtype=torch.bool, device=dev)
    dead[1] = False  # every key of batch row 1 masked
    seg = segment_runs(torch, dev, 2, 300, [0, 90, 200, 290])
    for dtype, atol, rtol, tag in ((torch.bfloat16, BF16_ATOL, BF16_RTOL, "bf16"),
                                   (torch.float32, F32_ATOL, F32_RTOL, "f32")):
        cases = [
            ("headline B16 H20 T256 D64 mask+rope", (16, 20, 256, 64),
             {"key_mask": lengths_mask(16, 256, [252 - 3 * i for i in range(16)]),
              "rope_base": 10000.0}),
            ("segments + mask + rope", (2, 4, 300, 64),
             {"segment_ids": seg, "key_mask": seg > 0, "rope_base": 10000.0}),
            ("causal", (2, 8, 200, 64), {"causal": True}),
            ("fully masked row, ragged T=100", (2, 4, 100, 32), {"key_mask": dead}),
        ]
        if dtype == torch.bfloat16:  # the window bucket (the float32 presets stay short)
            cases.append(("window bucket B32 H20 T1024 D64 mask+rope", (32, 20, 1024, 64),
                          {"key_mask": lengths_mask(32, 1024, [1024 - 9 * i for i in range(32)]),
                           "rope_base": 10000.0}))
        for name, shape, kw in cases:
            q, k, v = bthd(*shape, dtype)
            got = fa.grouped_mha_bthd(q, k, v, **kw)
            torch.cuda.synchronize()
            want = fa.plain_mha_bthd(q.float(), k.float(), v.float(), **kw)
            if "segment_ids" in kw:
                live = kw["segment_ids"] > 0
                got, want = got[live], want[live]
            k4_errs.append(check_close(f"{tag} {name}", got, want, atol, rtol))

    b, h, t, n_seg, seg_len = K3_TIMED
    d = 64
    q, k, v = qkv(b, h, t, d)
    q = q * d ** -0.5  # ESM pre-scales q and passes sm_scale=1
    # ESM's segment-packed rows: n_seg segments of about seg_len tokens, each
    # row its own cuts, then padding; the key mask as its own operand
    rs = np.random.RandomState(t)
    seg = torch.cat([segment_runs(torch, dev, 1, t, [0, *np.cumsum(
        seg_len + rs.randint(-20, 6, n_seg)).tolist()]) for _ in range(b)])
    mask = seg > 0
    tiles = fa.KeyTiles(seg, mask)  # the forward shares one by its 33 layers
    call_kw = dict(key_mask=mask, sm_scale=1.0, rope_base=10000.0, key_tiles=tiles)
    got = fa.seg_block_mha(q, k, v, seg, **call_kw).float()
    torch.cuda.synchronize()
    want = torch.cat([fa.plain_seg_block_mha(*(x[i:i + 1].float() for x in (q, k, v)),
                                             seg[i:i + 1], key_mask=mask[i:i + 1],
                                             sm_scale=1.0, rope_base=10000.0)
                      for i in range(b)])
    live = seg > 0
    k3_errs.append(check_close(f"bf16 B{b} H{h} T{t}, own {n_seg} x ~{seg_len} per row "
                               f"(live rows)", got.transpose(1, 2)[live],
                               want.transpose(1, 2)[live], BF16_ATOL, BF16_RTOL))
    del got, want
    lo, hi = tiles.extents(b, t, dev)
    per_block = (hi - lo).float().mean().item()
    qr, kr = fa.rope_qk(q, k, 1.0, 10000.0)  # the loop's and SDPA's operands: pre-rotated
    loop_kw = dict(key_mask=mask, sm_scale=1.0, key_tiles=tiles)
    # padding rows attend the padding keys (the kernel gives them finite output)
    seg_mask = ((seg[:, :, None] == seg[:, None, :])
                & (mask[:, None, :] | ~mask[:, :, None]))[:, None]
    k3t = median_pair(torch, {
        "kernel": lambda: fa.seg_block_mha(qr, kr, v, seg, **loop_kw),
        "plain": lambda: fa.plain_seg_block_mha(q, k, v, seg, key_mask=mask, sm_scale=1.0,
                                                rope_base=10000.0),
        "sdpa": sdpa(torch, qr, kr, v, seg_mask),
        "call": lambda: fa.seg_block_mha(q, k, v, seg, **call_kw),
    }, reps=2, inner=3)
    # live rows attend the live keys of their own segment; the call also
    # reads the RoPE tables
    counts = torch.stack([torch.bincount(seg[i][mask[i]].long(), minlength=n_seg + 1)
                          for i in range(b)]).double()
    k3b = bound(4 * d * h * float((counts ** 2).sum()),
                nbytes(q, k, v, q, seg, mask) + 2 * 4 * t * d)
    print(f"  K3 at B{b} H{h} T{t} D64, {n_seg} segments of ~{seg_len} per row + padding, key "
          f"mask ({per_block:.2f} of {-(-t // fa.KERNEL_TILE)} key tiles per 128-query block, "
          f"computed on the host from the extents): the call with RoPE (pre-pass + loop) "
          f"{k3t['call']:.4f} ms, plain {k3t['plain']:.4f} ms, bound {k3b['bound_ms']:.4f} ms "
          f"({k3b['bound_by']}); the Hopper loop alone on pre-rotated q/k {k3t['kernel']:.4f} ms, "
          f"SDPA on them {k3t['sdpa']:.4f} ms "
          f"({sdpa_backend(torch, sdpa(torch, qr, kr, v, seg_mask))}) (medians of 8 samples of "
          f"3 queued calls, {card})")
    del q, k, v, qr, kr, seg_mask
    torch.cuda.empty_cache()

    k4 = {}
    for b, h, t in K4_TIMED:
        q, k, v = bthd(b, h, t, d)
        mask = lengths_mask(b, t, [t - 4 - 3 * i for i in range(b)])
        call = dict(key_mask=mask, sm_scale=1.0, rope_base=10000.0)  # ESM's call
        tr = lambda x: x.transpose(1, 2)
        qr, kr = (tr(x) for x in fa.rope_qk(tr(q), tr(k), 1.0, 10000.0))
        sdpa_mask = mask[:, None, None, :]
        k4t = median_pair(torch, {
            "plain": lambda: fa.plain_mha_bthd(qr, kr, v, key_mask=mask, sm_scale=1.0),
            "kernel": lambda: fa.grouped_mha_bthd(qr, kr, v, key_mask=mask, sm_scale=1.0),
            "sdpa": sdpa(torch, tr(qr), tr(kr), tr(v), sdpa_mask),
            "call": lambda: fa.grouped_mha_bthd(q, k, v, **call),
        }, reps=5, inner=10, rounds=3)
        live = mask.sum().item()  # every query row attends the live keys of its row
        k4b = bound(4 * d * h * t * live, nbytes(q, k, v, q, mask))
        print(f"  K4 at B{b} H{h} T{t} D64 mask: Hopper loop {k4t['kernel']:.4f} ms, plain "
              f"{k4t['plain']:.4f} ms, SDPA {k4t['sdpa']:.4f} ms "
              f"({sdpa_backend(torch, sdpa(torch, tr(qr), tr(kr), tr(v), sdpa_mask))}), bound "
              f"{k4b['bound_ms']:.4f} ms ({k4b['bound_by']}); the call with RoPE (pre-pass + "
              f"loop) {k4t['call']:.4f} ms (medians of 30 samples of 10 queued calls, {card})")
        k4[(b, h, t)] = {"shape": f"B{b} H{h} T{t} D{d}", "ms": k4t["kernel"],
                         "plain_ms": k4t["plain"], "library_ms": k4t["sdpa"],
                         "call_ms": k4t["call"], **k4b}
        if t == 1024:  # the pre-pass at the window bucket
            rt = median_pair(torch, {
                "plain": lambda: fa.plain_rope_qk(tr(q), tr(k), 1.0, 10000.0),
                "kernel": lambda: fa.rope_qk(tr(q), tr(k), 1.0, 10000.0),
            }, reps=5, inner=10)
            got, want = fa.rope_qk(tr(q), tr(k), 1.0, 10000.0), fa.plain_rope_qk(
                tr(q), tr(k), 1.0, 10000.0)
            rope_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            # q and k read, q' and k' written, the float32 cos/sin tables read
            rb = bound(0, 2 * nbytes(q, k) + 2 * 4 * t * d)
            print(f"  rope_qk at B{b} H{h} T{t} D64: kernel {rt['kernel']:.4f} ms, plain "
                  f"{rt['plain']:.4f} ms, bound {rb['bound_ms']:.4f} ms ({rb['bound_by']}); "
                  f"max abs err {rope_err:.3e} ({card})")
            if rope_err != 0.0:  # the plain version's rounding steps, bit for bit
                fail(f"rope_qk differs from its plain version by {rope_err:.3e}")
            rope = {"max_abs_err": rope_err, "ms": rt["kernel"], "plain_ms": rt["plain"],
                    "library_ms": None, **rb}
        del q, k, v, qr, kr
        torch.cuda.empty_cache()
    main, other = k4[K4_TIMED[1]], k4[K4_TIMED[0]]
    return {
        # ms is the call with RoPE, as in earlier runs; loop_ms the loop alone
        "seg_block_attention": dict(max_abs_err=max(k3_errs), ms=k3t["call"],
                                    plain_ms=k3t["plain"], library_ms=k3t["sdpa"], **k3b,
                                    loop_ms=k3t["kernel"]),
        "grouped_attention_bthd": dict(max_abs_err=max(k4_errs), **main, other_shapes=[other]),
        "rope_qk": rope,
    }


def packed_forwards(lengths, chunk, window=1024, pad_to_multiple=32):
    """Forwards the bucketed packed path runs: L+2 rows per assay, grouped
    by row bucket (a multiple of the pad, at most the window), each group
    cut into chunks."""
    rows = {}
    for length in lengths:
        total = length + 2
        bucket = min(-(-total // pad_to_multiple) * pad_to_multiple, window)
        rows[bucket] = rows.get(bucket, 0) + total
    return sum(-(-n // chunk) for n in rows.values())


def phase_packed(torch, card, fa, cli, esm2, scores_250):
    """10. ``score --packed`` through the CLI on the production mix, twice;
    the second run is timed and counted."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    print(f"[packed] score --model esm --checkpoint esm2_t33_650M --packed, L={PACKED_MIX}")
    assays = [(f"SYNTH_P{length}", *synth_assay(length, 0 if length == 250 else length))
              for length in PACKED_MIX]
    n_mut = sum(len(m) for _, _, m in assays)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, assays)
        args = ["score", "--model", "esm", "--checkpoint", "esm2_t33_650M", "--packed",
                "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
                "--output-dir", str(root / "out"), "--batch-size", str(PACKED_BATCH),
                "--device", "cuda", "--quiet", "--fail-fast", "--overwrite"]
        walls = []
        for _ in range(2):  # warm, then the run that is timed and counted
            for name in fa.LAUNCHES:
                fa.LAUNCHES[name] = 0
            ln.LAUNCHES["layer_norm"] = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if cli.main(args) != 0:
                fail("packed CLI exited non-zero")
            walls.append(time.perf_counter() - t0)
        launches = {**fa.LAUNCHES, **ln.LAUNCHES}
        events = [json.loads(line) for line in (root / "out" / "events.jsonl").open()]
        scores = {length: read_scores(root / "out" / f"{dms_id}.csv", "esm2_t33_650M_score",
                                      len(mutants))
                  for (dms_id, _, mutants), length in zip(assays, PACKED_MIX)}
    thr = [e for e in events if e["event"] == "throughput"][-1]
    n_fwd = packed_forwards(PACKED_MIX, PACKED_BATCH)
    config = esm2.PRESETS["esm2_t33_650M"]
    expected = config.num_layers * n_fwd
    print(f"  {n_mut} finite scores; timed run: score_packed {thr['seconds']:.3f} s incl. "
          f"weight init -> {thr['mutants_per_sec']:.2f} mutants/s; CLI wall {walls[1]:.2f} s "
          f"(warm-up run {walls[0]:.2f} s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    print(f"  launches {launches} (expected 33 layers x {n_fwd} forwards = {expected} of K4 "
          f"and of its rope_qk pre-pass, {esm_norms(config)} x {n_fwd} of the layer norm)")
    check_launches("packed", launches, {"grouped_attention_bthd": expected, "rope_qk": expected,
                                        "layer_norm": esm_norms(config) * n_fwd})
    err = float(np.abs(scores[250] - scores_250).max())
    print(f"  L=250 scores vs the per-assay path (phase 4): max_abs_err={err:.3e} "
          f"(atol={TABLE_ATOL:g}) {'ok' if err <= TABLE_ATOL else 'MISMATCH'}")
    if err > TABLE_ATOL:
        fail("packed L=250 scores differ from the per-assay scores")
    return {"launches": launches, "scores": scores, "mutants_per_s": thr["mutants_per_sec"]}


def packed_rows(torch, dev, esm2, token_list, n_rows, row_len):
    """``n_rows`` rows of ``row_len`` tokens packing the given token vectors
    in turn as segments (one position masked in each), then padding."""
    rs = np.random.RandomState(3)
    tok = torch.full((n_rows, row_len), esm2.ALPHABET.padding_idx, dtype=torch.long)
    seg = torch.zeros(n_rows, row_len, dtype=torch.int32)
    i = 0
    for r in range(n_rows):
        begin, s_id = 0, 1
        while s_id <= esm2.MAX_ROW_SEGMENTS and begin + len(token_list[i]) <= row_len:
            t = torch.from_numpy(token_list[i].astype(np.int64))
            t[rs.randint(1, len(t) - 1)] = esm2.ALPHABET.mask_idx
            tok[r, begin:begin + len(t)] = t
            seg[r, begin:begin + len(t)] = s_id
            begin, s_id, i = begin + len(t), s_id + 1, (i + 1) % len(token_list)
    return tok.to(dev), seg.to(dev)


def phase_segment_packed(torch, dev, card, fa, esm2, check_close, packed_scores):
    """11. The segment-packed path at row_len 4096 (K3 and its pre-pass in
    every layer), twice; the second run is timed and counted."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.models import packed_scoring

    print(f"[segment_packed] score_assays_packed(seg_apply_fn=..., row_len={SEG_ROW_LEN}) "
          f"with esm2_t33_650M, L={SEG_MIX}")
    config = esm2.PRESETS["esm2_t33_650M"]
    model = esm2.init_random(config, seed=0, device=dev)  # the CLI's weights
    assays = [synth_assay(length, 0 if length == 250 else length) for length in SEG_MIX]
    n_mut = sum(len(m) for _, m in assays)
    token_list = [esm2.ALPHABET.tokenize(seq) for seq, _ in assays]
    seg_fn = esm2.make_segmented_apply_fn(model)
    runs = []
    for _ in range(2):  # warm, then the run that is timed and counted
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        ln.LAUNCHES["layer_norm"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = packed_scoring.score_assays_packed(
            None, assays, seg_apply_fn=seg_fn, row_len=SEG_ROW_LEN, seg_chunk=SEG_CHUNK)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    launches = {**fa.LAUNCHES, **ln.LAUNCHES}
    counts = {}
    for toks in token_list:
        counts[len(toks)] = counts.get(len(toks), 0) + len(toks)
    n_rows = len(packed_scoring._plan_rows(counts, SEG_ROW_LEN, esm2.MAX_ROW_SEGMENTS))
    n_fwd = -(-n_rows // SEG_CHUNK)
    expected = config.num_layers * n_fwd
    print(f"  {n_mut} scores in {runs[1]:.3f} s -> {n_mut / runs[1]:.2f} mutants/s "
          f"(warm-up run {runs[0]:.2f} s); {n_rows} rows of {SEG_ROW_LEN} tokens, "
          f"{sum(counts.values())} masked rows packed ({card})")
    print(f"  launches {launches} (expected 33 layers x {n_fwd} forwards = {expected} of K3 "
          f"and of its rope_qk pre-pass)")
    check_launches("segment-packed", launches, {"seg_block_attention": expected,
                                                "rope_qk": expected})
    errs = [float(np.abs(got - packed_scores[length]).max())
            for got, length in zip(scores, SEG_MIX)]
    if not all(np.isfinite(s).all() for s in scores):
        fail("segment-packed scores are not finite")
    print(f"  scores vs the bucketed packed scores (phase 10): max_abs_err={max(errs):.3e} "
          f"(atol={TABLE_ATOL:g}) {'ok' if max(errs) <= TABLE_ATOL else 'MISMATCH'}")
    if max(errs) > TABLE_ATOL:
        fail("segment-packed scores differ from the bucketed packed scores")

    tok, seg = packed_rows(torch, dev, esm2, token_list, 2, SEG_ROW_LEN)
    with torch.no_grad():
        got = torch.log_softmax(seg_fn(tok, seg), dim=-1)
        with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
            want = torch.log_softmax(seg_fn(tok, seg), dim=-1)
    live = seg > 0
    check_close(f"2 packed rows' log-probs, T={SEG_ROW_LEN}, "
                f"{int(seg.max(dim=1).values.sum())} segments, K3 vs plain",
                got[live], want[live], TABLE_ATOL, 0.0)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "mutants_per_s": n_mut / runs[1]}



def score_cli(cli, ref, dms_dir, dms_id, out_dir, chunk, strategy):
    """``score --model esm --checkpoint esm2_t33_650M`` of one assay with a
    scoring strategy."""
    rc = cli.main([
        "score", "--model", "esm", "--checkpoint", "esm2_t33_650M",
        "--dms-reference", str(ref), "--dms-dir", str(dms_dir), "--dms-id", dms_id,
        "--output-dir", str(out_dir), "--batch-size", str(chunk), "--device", "cuda",
        "--quiet", "--fail-fast", "--extra", f"scoring_strategy={strategy}",
    ])
    if rc != 0:
        fail(f"score CLI exited {rc} for {dms_id}, scoring_strategy={strategy}")


def write_csv_rows(path: Path, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def write_reference(path: Path, rows) -> None:
    """A DMS reference CSV with the columns merge and evaluate read."""
    write_csv_rows(path, ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                          "taxon", "coarse_selection_type", "MSA_Neff_L_category",
                          "DMS_total_number_mutants"], rows)


def read_table(path: Path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def phase_wt_pppl(torch, dev, card, fa, cli, esm2, esm_scoring, masked):
    """12a-b. wt-marginals at L=250 and L=3000, then pseudo-ppl at L=250,
    through the CLI with ESM2-650M; K4 launches counted, tables held
    against the plain attention."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.data.mutants import apply_mutant

    seq, mutants, masked_scores, chunk = masked
    config = esm2.PRESETS["esm2_t33_650M"]
    long_seq, long_all = synth_assay(WT_LONG, 2)
    long_mutants = long_all[::19]
    pppl_mutants = mixed_mutants(seq, PPPL_MUTANTS)
    assays = [("SYNTH_L250", seq, mutants), (f"SYNTH_L{WT_LONG}", long_seq, long_mutants)]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, assays)
        print(f"[wt_marginals] score --extra scoring_strategy=wt-marginals, "
              f"esm2_t33_650M, L=250 and L={WT_LONG}")
        wt_launches, cli_scores = {}, {}
        for dms_id, _, muts in assays:
            for name in fa.LAUNCHES:
                fa.LAUNCHES[name] = 0
            ln.LAUNCHES["layer_norm"] = 0
            score_cli(cli, ref, dms_dir, dms_id, root / "wt", chunk, "wt-marginals")
            counts = {**fa.LAUNCHES, **ln.LAUNCHES}
            cli_scores[dms_id] = read_scores(root / "wt" / f"{dms_id}.csv",
                                             "esm2_t33_650M_score", len(muts))
            print(f"  {dms_id}: {len(muts)} finite scores; launches {counts} (expected "
                  f"{config.num_layers} of K4 and of rope_qk and {esm_norms(config)} of the "
                  "layer norm: one forward)")
            check_launches(f"wt-marginals {dms_id}", counts,
                           {"grouped_attention_bthd": config.num_layers,
                            "rope_qk": config.num_layers, "layer_norm": esm_norms(config)})
            for name, c in counts.items():
                wt_launches[name] = wt_launches.get(name, 0) + c
        wt_rows_250 = read_table(root / "wt" / "SYNTH_L250.csv")

        model = esm2.init_random(config, seed=0, device=dev)  # the CLI's weights
        for dms_id, s, muts in assays:
            name = f"L={len(s)}"
            tokens = esm2.ALPHABET.tokenize(s)
            plan = esm_scoring.overlapping_window_plan(len(tokens), config.max_positions)
            table = esm_scoring.wt_marginal_table_overlapping(model, tokens,
                                                              window=config.max_positions)
            rescored = esm_scoring.score_mutants_from_table(table, muts, s)
            if not np.allclose(rescored, cli_scores[dms_id], atol=1e-5):
                fail(f"wt-marginal scores at {name} recomputed outside the CLI differ")
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                esm_scoring.wt_marginal_table_overlapping(model, tokens,
                                                          window=config.max_positions)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
                plain = esm_scoring.wt_marginal_table_overlapping(model, tokens,
                                                                  window=config.max_positions)
            windows = (f"{len(plan)} windows {plan} in one forward"
                       if len(tokens) > config.max_positions else "one forward")
            print(f"  {name} ({len(tokens)} tokens, {windows}): table "
                  f"{statistics.median(runs) * 1e3:.2f} ms median of 3 ({card})")
            check_close(f"wt table {name}, kernel vs plain attention", table, plain,
                        TABLE_ATOL, 0.0)

        print(f"[pseudo_ppl] score --extra scoring_strategy=pseudo-ppl, esm2_t33_650M, "
              f"L=250, {len(pppl_mutants)} mutants (singles and doubles)")
        (root / "p").mkdir()
        ref_p, dms_p = write_assays(root / "p", [("SYNTH_L250", seq, pppl_mutants)])
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        ln.LAUNCHES["layer_norm"] = 0
        t0 = time.perf_counter()
        score_cli(cli, ref_p, dms_p, "SYNTH_L250", root / "pppl", chunk, "pseudo-ppl")
        pppl_wall = time.perf_counter() - t0
        pppl_launches = {**fa.LAUNCHES, **ln.LAUNCHES}
        pppl_scores = read_scores(root / "pppl" / "SYNTH_L250.csv", "esm2_t33_650M_score",
                                  len(pppl_mutants))
        n_tables = len(pppl_mutants) + 1
        expected = config.num_layers * n_tables * n_chunk_forwards(250, chunk)
        print(f"  launches {pppl_launches} (expected {config.num_layers} layers x {n_tables} "
              f"tables x {n_chunk_forwards(250, chunk)} forwards = {expected} of K4 and of "
              f"rope_qk); CLI wall {pppl_wall:.2f} s incl. weight init")
        check_launches("pseudo-ppl", pppl_launches,
                       {"grouped_attention_bthd": expected, "rope_qk": expected})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        esm_scoring.score_assay(model, seq, pppl_mutants, strategy="pseudo-ppl", chunk=chunk,
                                window=config.max_positions)
        torch.cuda.synchronize()
        pppl_s = time.perf_counter() - t0
        print(f"  pseudo-ppl scoring {pppl_s:.3f} s -> {len(pppl_mutants) / pppl_s:.2f} "
              f"mutants/s ({n_tables} masked tables; {card})")
        mut_seq = apply_mutant(seq, pppl_mutants[-1])
        tables = {}
        for name, s in (("WT", seq), (pppl_mutants[-1], mut_seq)):
            tokens = esm2.ALPHABET.tokenize(s)
            kw = dict(chunk=chunk, window=config.max_positions, pad_to_multiple=64)
            got = esm_scoring.masked_marginal_table(model, tokens, **kw)
            with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
                want = esm_scoring.masked_marginal_table(model, tokens, **kw)
            check_close(f"pppl masked table {name}, kernel vs plain", got, want, TABLE_ATOL, 0.0)
            idx = torch.as_tensor(tokens[1:-1], device=dev)
            tables[name] = float(got[torch.arange(1, len(s) + 1, device=dev), idx].sum())
        err = abs((tables[pppl_mutants[-1]] - tables["WT"]) - pppl_scores[-1])
        print(f"  pppl({pppl_mutants[-1]}) - pppl(WT) from the tables vs the CLI: "
              f"abs err {err:.3e} (atol 1e-3)")
        if err > 1e-3:
            fail("pseudo-ppl score recomputed from the tables differs from the CLI's")
        del model
        torch.cuda.empty_cache()

    score_files = {  # location -> the score rows of the L=250 assay
        "masked": [[m, repr(float(v))] for m, v in zip(mutants, masked_scores)],
        "wt": [[r[0], r[-1]] for r in wt_rows_250[1:]],
        "pppl": [[m, repr(float(v))] for m, v in zip(pppl_mutants, pppl_scores)],
    }
    return {"wt_launches": wt_launches, "pppl_launches": pppl_launches,
            "pppl_mutants": pppl_mutants, "score_files": score_files}


def mixed_mutants(seq: str, n: int):
    """``n`` distinct singles and doubles, alternating, at seeded positions."""
    rs = np.random.RandomState(16)
    out = []
    for i in range(n):
        pos = sorted(rs.choice(len(seq), 1 + i % 2, replace=False))
        out.append(":".join(f"{seq[p]}{p + 1}{AA[(AA.index(seq[p]) + 1 + i) % 20]}"
                            for p in pos))
    return out


SUMMARY_COLUMNS = [
    "Model_rank", "Model_name", "Model type", "Average_{m}", "Bootstrap_standard_error_{m}",
    "Function_Activity", "Function_Binding", "Function_Expression",
    "Function_OrganismalFitness", "Function_Stability", "Low_MSA_depth", "Medium_MSA_depth",
    "High_MSA_depth", "Taxa_Human", "Taxa_Other_Eukaryote", "Taxa_Prokaryote", "Taxa_Virus",
    "Depth_1", "Depth_2", "Depth_3", "Depth_4", "Depth_5+", "Model details", "References"]
METRIC_NAMES = ("Spearman", "AUC", "MCC", "NDCG", "Top_recall")


def run_merge_evaluate(cli, root: Path, device: str, bootstrap: int, tag: str):
    """``merge`` (once) then ``evaluate`` through the CLI; returns the
    evaluate event (walls split into I/O, metrics, bootstrap)."""
    if not (root / "merged").exists():
        rc = cli.main(["merge", "--dms-reference", str(root / "reference.csv"),
                       "--dms-dir", str(root / "dms"), "--scores-root", str(root / "scores"),
                       "--config", str(root / "config.json"), "--output-dir", str(root / "merged")])
        if rc != 0:
            fail(f"merge CLI exited {rc} ({tag})")
    out = root / f"bench_{device}"
    rc = cli.main(["evaluate", "--dms-reference", str(root / "reference.csv"),
                   "--merged-dir", str(root / "merged"), "--config", str(root / "config.json"),
                   "--output-dir", str(out), "--device", device, "--no-html",
                   "--bootstrap-samples", str(bootstrap)])
    if rc != 0:
        fail(f"evaluate CLI exited {rc} ({tag}, {device})")
    for m in METRIC_NAMES:
        summary = out / m / f"Summary_performance_DMS_substitutions_{m}.csv"
        if not summary.exists():
            fail(f"{summary} was not written ({tag})")
        header = read_table(summary)[0]
        if header != [c.format(m=m) for c in SUMMARY_COLUMNS]:
            fail(f"{summary.name}: columns {header} are not the JAX package's order")
    return [json.loads(line) for line in (out / "events.jsonl").open()][-1]


def phase_merge_evaluate_real(cli, wt):
    """12c. merge -> evaluate of the three ESM score files of the L=250 assay."""
    print("[evaluate_real] merge -> evaluate --device cuda of the masked, wt-marginal and "
          "pseudo-ppl ESM2-650M scores (L=250)")
    mutants = wt["pppl_mutants"]
    rs = np.random.RandomState(12)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "dms").mkdir()
        y = rs.randn(len(mutants))
        write_csv_rows(root / "dms" / "SYNTH_L250.csv", ["mutant", "DMS_score", "DMS_score_bin"],
                       [[m, repr(float(v)), int(v > 0.5)] for m, v in zip(mutants, y)])
        write_reference(root / "reference.csv", [["SYNTH_L250", "SYNTH_L250.csv", "SYNTH",
                                                  "X" * 250, 250, "Human", "Stability",
                                                  "Medium", len(mutants)]])
        config = {}
        column = "esm2_t33_650M_score"
        for loc, rows in wt["score_files"].items():
            (root / "scores" / loc).mkdir(parents=True)
            write_csv_rows(root / "scores" / loc / "SYNTH_L250.csv", ["mutant", column], rows)
            config[f"ESM2_650M_{loc}"] = {"input_score_name": column, "location": loc,
                                          "directionality": 1, "key": "mutant",
                                          "model_type": "Single sequence"}
        (root / "config.json").write_text(json.dumps(
            {"model_list_zero_shot_substitutions_DMS": config}))
        event = run_merge_evaluate(cli, root, "cuda", 1000, "real scores")
        merged = read_table(root / "merged" / "SYNTH_L250.csv")
        if merged[0][-3:] != list(config) or len(merged) != len(mutants) + 1:
            fail(f"merged columns {merged[0]} / {len(merged) - 1} rows do not hold the three "
                 "models")
        rows = read_table(root / "bench_cuda" / "Spearman" /
                          "Summary_performance_DMS_substitutions_Spearman.csv")[1:]
    print(f"  merged {len(mutants)} mutants x {len(config)} models; Summary rows "
          + ", ".join(f"{r[1]} {r[3]}" for r in rows)
          + f"; evaluate {event['seconds']:.3f} s")


EVAL_SELECTION = ("Activity", "Binding", "Expression", "OrganismalFitness", "Stability")
EVAL_TAXA = ("Human", "Eukaryote", "Prokaryote", "Virus")
EVAL_DEPTHS = ("Low", "Medium", "High")


def build_benchmark_world(root: Path, n_assays: int, n_mutants: int, noises) -> None:
    """Synthetic assays cycling through UniProt IDs, selection types, taxa
    and MSA depths, single to 5+ deep mutants, and one score file per model:
    a noisy copy of DMS_score at the model's noise."""
    rs = np.random.RandomState(2024)
    (root / "dms").mkdir()
    refs, config = [], {}
    for j, noise in enumerate(noises):
        name = f"NOISE{j:02d}"  # no "_1".."_4" ending: that marks a depth column
        (root / "scores" / name).mkdir(parents=True)
        config[name] = {"input_score_name": "score", "location": name, "directionality": 1,
                        "key": "mutant", "model_type": f"noise {noise:g}"}
    depth = 1 + np.arange(n_mutants) % 6
    mutants = [":".join(f"A{7 * k + j + 1}G" for j in range(d)) for k, d in enumerate(depth)]
    for i in range(n_assays):
        dms_id = f"SYNTH_{i:03d}"
        y = rs.randn(n_mutants)
        lines = ["mutant,DMS_score,DMS_score_bin"] + [
            f"{m},{v!r},{int(v > 0.7)}" for m, v in zip(mutants, y.tolist())]
        (root / "dms" / f"{dms_id}.csv").write_text("\n".join(lines) + "\n")
        for j, noise in enumerate(noises):
            s = y + noise * rs.randn(n_mutants)
            (root / "scores" / f"NOISE{j:02d}" / f"{dms_id}.csv").write_text(
                "mutant,score\n" + "\n".join(f"{m},{v!r}" for m, v in zip(mutants, s.tolist()))
                + "\n")
        refs.append([dms_id, f"{dms_id}.csv", f"UP{i % 180:03d}", "X" * 10, 10,
                     EVAL_TAXA[i % 4], EVAL_SELECTION[i % 5], EVAL_DEPTHS[i % 3], n_mutants])
    write_reference(root / "reference.csv", refs)
    (root / "config.json").write_text(json.dumps(
        {"model_list_zero_shot_substitutions_DMS": config}))


def compare_outputs(a: Path, b: Path, atol: float) -> int:
    files = sorted(p.relative_to(a) for p in a.rglob("*.csv"))
    if sorted(p.relative_to(b) for p in b.rglob("*.csv")) != files or not files:
        fail(f"{a.name} and {b.name} hold different CSV files")
    for rel in files:
        ra, rb = read_table(a / rel), read_table(b / rel)
        if ra[0] != rb[0] or len(ra) != len(rb):
            fail(f"{rel}: header or row count differs between {a.name} and {b.name}")
        for x, y in zip(ra[1:], rb[1:]):
            for cx, cy in zip(x, y):
                if cx == cy:
                    continue
                try:
                    fx, fy = float(cx), float(cy)
                except ValueError:
                    fail(f"{rel}: {cx!r} vs {cy!r}")
                if not abs(fx - fy) <= atol:
                    fail(f"{rel}: {cx} vs {cy} (atol {atol:g})")
    return len(files)


def phase_evaluate_scale(torch, dev, card, cli):
    """12d. merge -> evaluate through the CLI at the benchmark's assay
    count, once on the card and once on the CPU; the CSVs agree, the
    ranking follows the noise, and the card's metrics match scipy."""
    from scipy.stats import mannwhitneyu, spearmanr

    from proteingym_tpu_torch.metrics import core

    n_assays, n_mutants, noises = EVAL_SCALE
    print(f"[evaluate_scale] merge -> evaluate of {n_assays} synthetic assays x {n_mutants} "
          f"mutants x {len(noises)} models, bootstrap 10,000, --device cuda and cpu")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        build_benchmark_world(root, n_assays, n_mutants, noises)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        events = {"cuda": run_merge_evaluate(cli, root, "cuda", 10000, "scale")}
        merge_eval_s = time.perf_counter() - t0
        events["cpu"] = run_merge_evaluate(cli, root, "cpu", 10000, "scale")
        n_files = compare_outputs(root / "bench_cuda", root / "bench_cpu", 1e-9)
        rows = read_table(root / "bench_cuda" / "Spearman" /
                          "Summary_performance_DMS_substitutions_Spearman.csv")[1:]
        ranking = [r[1] for r in rows]
        if ranking != [f"NOISE{j:02d}" for j in range(len(noises))]:
            fail(f"Average_Spearman ranking {ranking} does not follow the noise order")
        merged = [read_table(root / "merged" / f"SYNTH_{i:03d}.csv")
                  for i in (0, n_assays // 2, n_assays - 1)]
    errs = []
    for table in merged:
        head = table[0]
        cols = {c: np.asarray([float(r[head.index(c)]) for r in table[1:]])
                for c in head if c.startswith(("DMS_", "NOISE"))}
        y, b = cols["DMS_score"], cols["DMS_score_bin"]
        for j in (0, len(noises) - 1):
            s = cols[f"NOISE{j:02d}"]
            rho = float(core.spearman(y, s, device=dev))
            a = float(core.auc(b, s, device=dev))
            u = mannwhitneyu(s[b == 1], s[b == 0]).statistic / ((b == 1).sum() * (b == 0).sum())
            errs += [abs(rho - spearmanr(y, s)[0]), abs(a - u)]
    print(f"  {n_files} CSVs equal between cuda and cpu at 1e-9; Spearman ranking "
          f"{' > '.join(ranking[:3])} ... {ranking[-1]}; card vs scipy spearmanr / mannwhitneyu "
          f"on 3 assays x 2 models: max abs err {max(errs):.3e}")
    if max(errs) > 1e-12:
        fail("the card's Spearman/AUC differ from scipy")
    for device in ("cuda", "cpu"):
        e = events[device]
        other = e["seconds"] - e["io_seconds"] - e["metrics_seconds"] - e["bootstrap_seconds"]
        print(f"  evaluate --device {device}: wall {e['seconds']:.3f} s = I/O "
              f"{e['io_seconds']:.3f} + metrics {e['metrics_seconds']:.3f} + bootstrap "
              f"{e['bootstrap_seconds']:.3f} + aggregation {other:.3f} s; "
              f"{e['seconds'] / (n_assays * n_mutants / 1e4):.4f} s per 10k rows ({card})")
    print(f"  inputs written in {build_s:.2f} s; merge + evaluate (cuda) CLI wall "
          f"{merge_eval_s:.2f} s")


def phase_clinical(cli):
    """12e. evaluate-clinical --device cuda on a synthetic clinical set."""
    print("[evaluate_clinical] evaluate-clinical --device cuda, 12 proteins x 3 models")
    rs = np.random.RandomState(3)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "merged").mkdir()
        refs = []
        for k in range(12):
            pid = f"NP_{k:06d}.1"
            n = 150 + 10 * k
            labels = rs.randint(0, 2, n)
            cols = {"GOOD": labels + rs.normal(0, 0.7, n), "WEAK": labels + rs.normal(0, 2.5, n),
                    "NOISE": rs.normal(size=n)}
            write_csv_rows(root / "merged" / f"{pid}.csv",
                           ["mutant", "DMS_bin_score", *cols],
                           [[f"A{i + 1}G", int(labels[i]), *(repr(float(c[i]))
                                                            for c in cols.values())]
                            for i in range(n)])
            refs.append([pid, f"{pid}.csv", "A" * n])
        write_csv_rows(root / "clinical.csv", ["protein_id", "DMS_filename", "target_seq"], refs)
        (root / "config.json").write_text(json.dumps({
            "model_list_zero_shot_substitutions_clinical": {
                m: {"input_score_name": m, "location": m, "directionality": 1, "key": "mutant"}
                for m in ("GOOD", "WEAK", "NOISE")}}))
        rc = cli.main(["evaluate-clinical", "--clinical-reference", str(root / "clinical.csv"),
                       "--merged-dir", str(root / "merged"), "--config", str(root / "config.json"),
                       "--output-dir", str(root / "bench"), "--device", "cuda", "--no-html"])
        if rc != 0:
            fail(f"evaluate-clinical CLI exited {rc}")
        summary = read_table(root / "bench" / "AUC" /
                             "Summary_performance_clinical_substitutions_AUC.csv")
        levels = read_table(root / "bench" / "AUC" / "clinical_substitutions_AUC_DMS_level.csv")
    if summary[0] != ["Model_rank", "Model_name", "Model type", "Average_AUC",
                      "Bootstrap_standard_error_AUC"]:
        fail(f"clinical summary columns {summary[0]}")
    if [r[1] for r in summary[1:]] != ["GOOD", "WEAK", "NOISE"] or len(levels) != 13:
        fail(f"clinical summary {summary[1:]} / {len(levels) - 1} proteins are not as expected")
    print("  Summary: " + ", ".join(f"{r[1]} AUC {r[3]} (SE {r[4]})" for r in summary[1:]))


def phase_msa_transformer(torch, dev, card, fa, check_close):
    """13. The MSA Transformer slice through the port's CLI: ``score --model
    msa_transformer --checkpoint esm_msa1b_t12_100M`` (seeded random bf16
    weights, full width and depth: 12 layers, width 768, 12 heads of 64)
    on a synthetic L=250 assay with a 16,384-sequence alignment covering
    residues 1-240, with no weights file beforehand: K5 writes it once,
    then each forward launches K1 12 times (the column attention, over
    R=384 sampled rows, at B*C = 4 x 241) and nothing else, since the model
    scales q itself. Cut from ProteinGym's protocol: 1 seed of 5 (time).
    The 8 mutants past the alignment (241-250) must be empty fields, the WT
    row 0. Then the warm k=1 table once and the k=8 table (median of 3)
    are timed, the first 4 and the last 4 masked columns recomputed with
    the plain attention, and K1 timed at the column attention's shape."""
    from proteingym_tpu_torch.models import msa_transformer as mt
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.msa.parser import load_msa
    from proteingym_tpu_torch.pipeline import cli
    from proteingym_tpu_torch.pipeline.scorers import _score_focus_model

    s = MSA_SLICE
    config = mt.PRESETS[s["preset"]]
    length, covered, n_seqs, n_in, n_out = (s[key] for key in (
        "length", "covered", "n_seqs", "n_in", "n_out"))
    chunk = max(1, s["batch"] // 8)  # the scorer's grids per forward
    print(f"[msa_transformer] score --model msa_transformer --checkpoint {s['preset']}: "
          f"L={length}, MSA N={n_seqs} over residues 1-{covered}, {n_in} + {n_out} singles "
          f"+ WT, {s['rows']} sampled rows, 1 seed")
    rs = np.random.RandomState(13)
    target = rs.randint(1, 21, length)
    seq = "".join(GAP_AA[c] for c in target)
    mutants = []
    for lo, hi, n in ((0, covered, n_in), (covered, length, n_out)):
        for p in sorted(rs.choice(np.arange(lo, hi), n, replace=False)):
            mutants.append(f"{seq[p]}{p + 1}{rs.choice([a for a in AA if a != seq[p]])}")
    mutants.append("WT")
    n_mut = len(mutants)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        msa_dir, weights_dir, out_dir = root / "msa", root / "weights", root / "out"
        msa_dir.mkdir()
        write_a2m(msa_dir / "SYNTH.a2m", "SYNTH", synth_family(target[:covered], n_seqs, 13))
        ref, dms_dir = write_assays(root, [("SYNTH_MSA", seq, mutants)], {
            "MSA_filename": "SYNTH.a2m", "MSA_start": 1, "MSA_end": covered,
            "MSA_theta": 0.2, "weight_file_name": "SYNTH.npy",
        })
        for counts in (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES):
            for name in counts:
                counts[name] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main([
            "score", "--model", "msa_transformer", "--checkpoint", s["preset"],
            "--msa-dir", str(msa_dir), "--weights-dir", str(weights_dir),
            "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
            "--output-dir", str(out_dir), "--batch-size", str(s["batch"]),
            "--device", "cuda", "--quiet", "--fail-fast",
            "--extra", f"msa_samples={s['rows']}", "num_seeds=1",
        ])
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if rc != 0:
            fail(f"msa_transformer score CLI exited {rc}")
        with open(out_dir / "SYNTH_MSA.csv", newline="") as f:
            cells = [row["esm_msa1b_ensemble"] for row in csv.DictReader(f)]
        msa = load_msa(msa_dir / "SYNTH.a2m")
        weights = np.load(weights_dir / "SYNTH.npy")

    total = covered + 1  # [CLS] + the focus columns
    n_fwd = -(-total // chunk)
    expected = config.num_layers * n_fwd
    print(f"  CLI wall {wall:.2f} s incl. weight init, A2M parse, K5 and the k=1 table; "
          f"peak device memory {peak_gib:.2f} GiB ({card})")
    print(f"  launches {launches} (expected 1 cluster_counts, {config.num_layers} layers x "
          f"{n_fwd} forwards = {expected} grouped_attention, no rope_qk: q comes scaled)")
    check_launches("msa_transformer", launches, {"cluster_counts": 1,
                                                 "grouped_attention": expected})
    empty = [i for i, c in enumerate(cells) if c == ""]
    if len(cells) != n_mut or empty != list(range(n_in, n_in + n_out)):
        fail(f"CSV: {len(cells)} rows, empty fields at {empty}; expected {n_mut} rows, "
             f"empty at {n_in}..{n_in + n_out - 1} (the mutants past the alignment)")
    scores = np.asarray([float(c) for c in cells[:n_in]] + [float(cells[-1])])
    if not np.isfinite(scores).all() or scores[-1] != 0.0:
        fail(f"CSV: non-finite scores or a WT score of {cells[-1]!r}")
    print(f"  CSV: {n_in} finite scores, {n_out} empty fields at rows {n_in}..{n_in + n_out - 1}"
          f" (past the alignment), WT 0")

    model = mt.init_random(config, seed=0, device=dev)  # the CLI's weights
    ctx = types.SimpleNamespace(record=types.SimpleNamespace(MSA_start=1))

    def score(k):  # the scorer's work after the model and the alignment are loaded
        return _score_focus_model(ctx, msa, lambda wt, remapped: mt.score_assay_msa_transformer(
            model, wt, remapped, msa.sequences(), weights, nseq=s["rows"], seeds=(1,),
            chunk=chunk, cols_per_forward=k), mutants)

    timed = {}
    for k, reps in ((1, 1), (s["k_cols"], 3)):
        if k > 1:
            score(k)  # warm: k=1 is warm from the CLI run
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rescored = score(k)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        timed[k] = (statistics.median(runs), rescored)
    cli_scores = np.asarray([float(c) if c else np.nan for c in cells])
    if not np.allclose(timed[1][1], cli_scores, atol=1e-4, equal_nan=True):
        fail("msa_transformer scores recomputed outside the CLI differ from the CLI's")
    t1, tk = timed[1][0], timed[s["k_cols"]][0]
    fwd_k = -(-(-(-total // s["k_cols"])) // chunk)
    print(f"  k=1 table + scores (warm, once): {t1:.3f} s, {n_fwd} forwards of {chunk} x "
          f"{s['rows']} x {total} -> {n_mut / t1:.2f} mutants/s; k={s['k_cols']}: {tk:.3f} s "
          f"median of 3, {fwd_k} forwards -> {n_mut / tk:.2f} mutants/s ({card})")

    # the first and the last masked columns, each chunk's grids through the
    # model with the kernel and with the plain attention
    tokens = mt.tokenize_msa(mt.sample_msa_weighted(msa.sequences(), weights, s["rows"], 1))
    base = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    got, want = [], []
    for part in (list(range(chunk)), list(range(total - chunk, total))):
        offs = torch.tensor(part, device=dev)[:, None]
        grids = base.expand(chunk, -1, -1).clone()
        grids[torch.arange(chunk, device=dev)[:, None], 0, offs] = mt.ALPHABET.mask_idx
        with torch.no_grad():
            got.append(mt._query_log_probs(model, grids, offs)[:, 0])
            with mock.patch.object(mt, "mha", fa.plain_mha):
                want.append(mt._query_log_probs(model, grids, offs)[:, 0])
    check_close(f"log-prob rows of columns 0-{chunk - 1} and {total - chunk}-{total - 1}, "
                "kernel vs plain attention", torch.cat(got), torch.cat(want),
                MSA_TABLE_ATOL, 0.0)
    del model, got, want
    torch.cuda.empty_cache()

    # K1 at the column attention's shape: (B*C, R, H, D) memory, q pre-scaled
    b, h, t, d = chunk * total, config.num_heads, s["rows"], config.head_dim
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    q = (q.float() * d ** -0.5).to(torch.bfloat16)
    lengths = torch.full((b,), t, device=dev)
    lengths[::7] = t - 48  # some columns with padded rows
    lengths[3] = 0  # and one with every row masked
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    got = fa.grouped_mha(q, k, v, key_mask=mask, sm_scale=1.0)
    torch.cuda.synchronize()
    want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask, sm_scale=1.0)
    err = check_close(f"K1 B{b} H{h} T{t} D{d} mask, pre-scaled q, vs plain", got, want,
                      BF16_ATOL, BF16_RTOL)
    del want
    times = median_pair(torch, {
        "kernel": lambda: fa.grouped_mha(q, k, v, key_mask=mask, sm_scale=1.0),
        "plain": lambda: fa.plain_mha(q, k, v, key_mask=mask, sm_scale=1.0),
        "sdpa": sdpa(torch, q, k, v, mask[:, None, None, :]),
    }, reps=3, inner=5, rounds=1)
    live = float(mask.sum())
    bnd = bound(4.0 * h * d * t * live, nbytes(q, k, v, got, mask))
    torch.cuda.empty_cache()
    print(f"  K1 at B{b} H{h} T{t} D{d}: kernel {times['kernel']:.4f} ms, plain "
          f"{times['plain']:.4f} ms, SDPA (dense mask) {times['sdpa']:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {card})")
    return {"launches": launches, "k1_err": err, "k1": dict(
        shape=f"B{b} H{h} T{t} D{d} mask, q pre-scaled (MSA column attention), loop alone",
        ms=times["kernel"], plain_ms=times["plain"], library_ms=times["sdpa"],
        max_abs_err=err, **bnd)}


def k1_pairs(lengths, t):
    """(query, key) pairs K1 computes under causal + a key mask of each
    row's length: query i meets the live keys up to i."""
    return sum(n * (n + 1) // 2 + (t - n) * n for n in lengths)


def phase_tranception(torch, dev, card, fa, check_close):
    """14. Tranception and TranceptEVE through the port's CLI (seeded random
    Tranception-L, full width and depth; EVE at its default architecture
    from a file in the reference layout): (a) TranceptEVE on phase 13's
    L=250 target and alignment with all 4,750 singles, (b) Tranception
    alone on an L=1,500 target (T=1024 windows), (c) EVE's evol indices,
    (d) kernel against the plain attention in the model, (e) K1 at
    Tranception's two shapes, (f) merge of the three score files."""
    from proteingym_tpu_torch.models import ar_scoring, eve, retrieval, tranception
    from proteingym_tpu_torch.models import trancepteve as te
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli
    from proteingym_tpu_torch.pipeline.checkpoints import TRANCEPTION_PRESETS

    s = TRANCEPTION_SLICE
    length, covered, batch = s["length"], s["covered"], s["batch"]
    rs = np.random.RandomState(13)  # phase 13's target and alignment
    codes = rs.randint(1, 21, length)
    seq = "".join(GAP_AA[c] for c in codes)
    mutants = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    mut_seqs = [seq[:int(m[1:-1]) - 1] + m[-1] + seq[int(m[1:-1]):] for m in mutants]
    rs = np.random.RandomState(14)
    long_seq = "".join(AA[i] for i in rs.randint(0, 20, s["long_length"]))
    positions = np.linspace(0, s["long_length"] - 1, s["long_mutants"]).astype(int)
    long_mutants = [f"{long_seq[p]}{p + 1}{AA[(AA.index(long_seq[p]) + 1 + rs.randint(19)) % 20]}"
                    for p in positions]
    long_seqs = [long_seq[:p] + m[-1] + long_seq[p + 1:] for p, m in zip(positions, long_mutants)]
    print(f"[tranception] Tranception-L (seeded random bf16) + EVE ({card}): L={length} with "
          f"{len(mutants)} singles, MSA N={s['n_seqs']} over residues 1-{covered}; "
          f"L={s['long_length']} with {len(long_mutants)} singles")

    def reset():
        for counts in (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES):
            for name in counts:
                counts[name] = 0

    spans = {}

    def timed(name, fn):
        return spans_of(torch, spans, name, fn)

    forwards = [0]
    plain_forward = tranception.Tranception.forward

    def counted_forward(self, tokens):
        forwards[0] += 1
        return plain_forward(self, tokens)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        msa_dir, weights_dir = root / "msa", root / "weights"
        msa_dir.mkdir()
        write_a2m(msa_dir / "SYNTH.a2m", "SYNTH", synth_family(codes[:covered], s["n_seqs"], 13))
        eve_config = eve.EveConfig(seq_len=covered)
        eve_file = root / "eve.pt"
        torch.save(eve.checkpoint_dict(eve.init_random(eve_config, seed=14, device=dev)),
                   eve_file)
        y = np.random.RandomState(15).randn(len(mutants) + 1)
        (root / "dms").mkdir()
        write_csv_rows(root / "dms" / "SYNTH_L250.csv", ["mutant", "mutated_sequence", "DMS_score"],
                       [[m, ms, repr(float(v))] for m, ms, v in zip(mutants, mut_seqs, y)])
        write_csv_rows(root / "dms" / "SYNTH_L250_WT.csv",
                       ["mutant", "mutated_sequence", "DMS_score"],
                       [[m, ms, repr(float(v))] for m, ms, v in
                        zip(mutants + ["WT"], mut_seqs + [seq], y)])
        write_csv_rows(root / "dms" / "SYNTH_L1500.csv", ["mutant", "mutated_sequence", "DMS_score"],
                       [[m, ms, "0.5"] for m, ms in zip(long_mutants, long_seqs)])
        msa_cells = ["SYNTH.a2m", 1, covered, 0.2, "SYNTH.npy"]
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                        "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"],
                       [["SYNTH_L250", "SYNTH_L250.csv", "SYNTH", seq, length, *msa_cells],
                        ["SYNTH_L250_WT", "SYNTH_L250_WT.csv", "SYNTH", seq, length, *msa_cells],
                        ["SYNTH_L1500", "SYNTH_L1500.csv", "SYNTH", long_seq, s["long_length"],
                         "", "", "", "", ""]])

        def score(model, dms_id, out, checkpoint, extra=()):
            rc = cli.main([
                "score", "--model", model, "--checkpoint", checkpoint, "--dms-id", dms_id,
                "--msa-dir", str(msa_dir), "--weights-dir", str(weights_dir),
                "--dms-reference", str(root / "reference.csv"), "--dms-dir", str(root / "dms"),
                "--output-dir", str(root / out), "--batch-size", str(batch), "--device", "cuda",
                "--quiet", "--fail-fast", *(["--extra", *extra] if extra else [])])
            if rc != 0:
                fail(f"{model} score CLI exited {rc} on {dms_id}")
            return read_table(root / out / f"{dms_id}.csv")

        # (a) TranceptEVE on the L=250 singles
        header = ["mutated_sequence", "avg_score_L_to_R", "avg_score_R_to_L", "avg_score"]
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(tranception.Tranception, "forward", counted_forward), \
                mock.patch.object(retrieval, "hamming_filter",
                                  timed("msa_filter", retrieval.hamming_filter)), \
                mock.patch.object(retrieval, "log_msa_prior",
                                  timed("msa_prior", retrieval.log_msa_prior)), \
                mock.patch.object(retrieval, "eve_log_prior",
                                  timed("eve_prior", retrieval.eve_log_prior)), \
                mock.patch.object(te, "score_trancepteve",
                                  timed("ar_scoring", te.score_trancepteve)):
            rows = score("trancepteve", "SYNTH_L250", "TranceptEVE_L", s["checkpoint"], [
                "retrieval_type=TranceptEVE", f"eve_checkpoints={eve_file}",
                f"eve_num_samples={s['eve_num_samples']}"])
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        config = TRANCEPTION_PRESETS[s["checkpoint"]]  # the table the CLI's loader reads
        per_direction = len(mutants) + 1  # every mutant and one WT row (one window)
        n_fwd = 2 * -(-per_direction // batch)
        if forwards[0] != n_fwd:
            fail(f"trancepteve: {forwards[0]} forwards, expected {n_fwd}")
        print(f"  (a) launches {launches} (expected 1 cluster_counts, {config.num_layers} layers "
              f"x {n_fwd} forwards = {config.num_layers * n_fwd} grouped_attention, "
              "no rope_qk: q comes scaled)")
        check_launches("trancepteve", launches, {"cluster_counts": 1,
                                                 "grouped_attention": config.num_layers * n_fwd})
        if rows[0] != header or [r[0] for r in rows[1:]] != mut_seqs:
            fail(f"trancepteve CSV: columns {rows[0]}, {len(rows) - 1} rows; expected {header} "
                 f"over the {len(mut_seqs)} mutated sequences in assay order")
        scores_a = np.asarray([r[1:] for r in rows[1:]], dtype=np.float64)
        if not np.isfinite(scores_a).all():
            fail("trancepteve CSV: non-finite scores")
        n_draws = max(1, s["eve_num_samples"] // 512) * 512
        print(f"  (a) {len(mutants)} x 3 finite scores; CLI wall {wall:.2f} s (weight init, A2M "
              f"parse, K5, priors, scoring); MSA filter {spans['msa_filter']:.3f} s + MSA prior "
              f"{spans['msa_prior']:.3f} s, EVE prior {spans['eve_prior']:.2f} s ({n_draws} "
              f"draws), AR scoring {spans['ar_scoring']:.2f} s ({n_fwd} forwards of {batch} x "
              f"256) -> {len(mutants) / spans['ar_scoring']:.2f} mutants/s; peak device "
              f"memory {peak_gib:.2f} GiB ({card})")
        run_a = dict(launches=launches, wall_s=wall, spans=dict(spans), peak_gib=peak_gib,
                     forwards=n_fwd)

        # (b) Tranception alone, L=1,500: 1,022-residue windows
        reset()
        forwards[0] = 0
        t0 = time.perf_counter()
        with mock.patch.object(tranception.Tranception, "forward", counted_forward):
            rows = score("tranception", "SYNTH_L1500", "Tranception_L_no_retrieval",
                         s["checkpoint"])
        wall_b = time.perf_counter() - t0
        launches_b = {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}
        plans = ar_scoring.get_sequence_slices(long_mutants, long_seqs, long_seq, config.n_ctx - 2)
        n_fwd_b = 2 * -(-len(plans) // batch)
        widths = {p.window_end - p.window_start for p in plans}
        if forwards[0] != n_fwd_b or widths != {config.n_ctx - 2}:
            fail(f"tranception L=1500: {forwards[0]} forwards (expected {n_fwd_b}), window "
                 f"widths {widths}")
        check_launches("tranception L=1500", launches_b,
                       {"grouped_attention": config.num_layers * n_fwd_b})
        if rows[0] != header or len(rows) != len(long_mutants) + 1 or not np.isfinite(
                np.asarray([r[1:] for r in rows[1:]], dtype=np.float64)).all():
            fail(f"tranception L=1500 CSV: columns {rows[0]}, {len(rows) - 1} rows, or "
                 "non-finite scores")
        print(f"  (b) L={s['long_length']}: {len(plans)} rows per direction ({len(long_mutants)} "
              f"mutants + {len(plans) - len(long_mutants)} WT windows of {config.n_ctx - 2}), "
              f"{n_fwd_b} forwards of T=1024, launches {launches_b}; CLI wall {wall_b:.2f} s")

        # (c) EVE's evol indices at 2,000 draws
        reset()
        t0 = time.perf_counter()
        rows = score("eve", "SYNTH_L250_WT", "EVE", str(eve_file),
                     [f"num_samples={s['eve_scoring_samples']}"])
        wall_c = time.perf_counter() - t0
        launches_c = {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}
        check_launches("eve", launches_c, {})  # the weights file exists; EVE runs no kernel
        cells = [r[-1] for r in rows[1:]]
        past = [i for i, m in enumerate(mutants) if int(m[1:-1]) > covered]
        empty = [i for i, c in enumerate(cells) if c == ""]
        if rows[0] != ["mutant", "mutated_sequence", "DMS_score", "evol_indices"] or \
                empty != past or len(past) != 190 or cells[-1] != "0.0":
            fail(f"eve CSV: columns {rows[0]}, {len(empty)} empty fields (expected the 190 "
                 f"mutants past residue {covered}), WT {cells[-1]!r}")
        evol = np.asarray([float(c) for c in cells if c])
        if not np.isfinite(evol).all():
            fail("eve CSV: non-finite evol indices")
        n_scored = len(cells) - len(past)
        print(f"  (c) eve: {n_scored - 1} finite evol indices, 190 empty fields (residues "
              f"{covered + 1}-{length}), WT 0; CLI wall {wall_c:.2f} s at "
              f"{s['eve_scoring_samples']} draws -> {n_scored / wall_c:.2f} mutants/s ({card})")

        # (f) merge of the three score files
        config_json = {
            "TranceptEVE_L": ("TranceptEVE_L", "avg_score", "mutated_sequence", 1),
            "Tranception_L_no_retrieval": ("Tranception_L_no_retrieval", "avg_score",
                                           "mutated_sequence", 1),
            "EVE_single": ("EVE", "evol_indices", "mutant", -1),
        }
        (root / "EVE" / "SYNTH_L250_WT.csv").rename(root / "EVE" / "SYNTH_L250.csv")
        (root / "config.json").write_text(json.dumps({"model_list_zero_shot_substitutions_DMS": {
            name: {"input_score_name": col, "location": loc, "directionality": sign, "key": key,
                   "model_type": "Alignment-based model"}
            for name, (loc, col, key, sign) in config_json.items()}}))
        rc = cli.main(["merge", "--dms-reference", str(root / "reference.csv"),
                       "--dms-dir", str(root / "dms"), "--scores-root", str(root),
                       "--config", str(root / "config.json"), "--output-dir", str(root / "merged")])
        if rc != 0:
            fail(f"merge CLI exited {rc}")
        merged = read_table(root / "merged" / "SYNTH_L250.csv")
        col = {name: merged[0].index(name) for name in ("TranceptEVE_L", "EVE_single")}
        te_col = [r[col["TranceptEVE_L"]] for r in merged[1:]]
        eve_col = [r[col["EVE_single"]] for r in merged[1:]]
        long_merged = read_table(root / "merged" / "SYNTH_L1500.csv")
        long_col = [r[long_merged[0].index("Tranception_L_no_retrieval")]
                    for r in long_merged[1:]]
        if (len(te_col) != len(mutants) or "" in te_col
                or [i for i, c in enumerate(eve_col) if c == ""] != past
                or len(long_col) != len(long_mutants) or "" in long_col):
            fail("merged files do not hold the three models' scores on their assays")
        print(f"  (f) merge: SYNTH_L250 {len(mutants)} rows x (TranceptEVE_L, EVE_single: 190 "
              f"empty past the alignment), SYNTH_L1500 {len(long_mutants)} rows x "
              "Tranception_L_no_retrieval")

    # (d) two rows of (a) and two windows of (b), both directions, with the
    # kernel and with the plain attention in the model
    from proteingym_tpu_torch.pipeline.checkpoints import load_tranception_checkpoint

    model, _ = load_tranception_checkpoint(s["checkpoint"], device=dev)  # the CLI's weights
    errs = []
    for rows_of, what in (([mut_seqs[0], mut_seqs[-1]],
                           f"L={length} rows 0 and {len(mut_seqs) - 1}"),
                          ([p.sliced_sequence for p in plans if p.mutated_sequence != long_seq][::31],
                           "L=1500 windows of mutants 0 and 31")):
        texts = rows_of + [r[::-1] for r in rows_of]  # L->R and R->L
        width = -(-(len(texts[0]) + 2) // 32) * 32
        tokens = torch.from_numpy(np.stack([tranception.VOCAB.tokenize(t, pad_to=width)
                                            for t in texts])).long().to(dev)
        targets = tokens[:, 1:, None]
        live = targets[..., 0] != tranception.VOCAB.PAD

        def per_token():  # log p(x_t | x_<t) of each live token, as the scoring reads it
            return torch.log_softmax(model(tokens), -1)[:, :-1].gather(-1, targets)[..., 0][live]

        with torch.no_grad():
            got = per_token()
            with mock.patch.object(tranception, "mha", fa.plain_mha):
                want = per_token()
        errs.append(check_close(f"(d) per-token log-probs, {what}, both directions, kernel "
                                "vs plain", got, want, TRANCEPTION_LOGP_ATOL, 0.0))
    del model, got, want
    torch.cuda.empty_cache()

    # (e) K1 alone at Tranception's shapes: q pre-scaled, ALiBi, causal, and
    # each row's own pad tail
    records = []
    for b, h, t in K1_TRANCEPTION:
        d = 64
        gen = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        q = (q.float() * 0.125).to(torch.bfloat16)
        lengths = [t - (i * 37) % 97 for i in range(b)]
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
        bias = tranception.alibi_bias(h, t, dev)
        kw = dict(key_mask=mask, bias=bias, causal=True, sm_scale=1.0)
        tiles = fa.KeyTiles(None, mask, True)  # the extents, made once as the model does
        got = fa.grouped_mha(q, k, v, key_tiles=tiles, **kw)
        torch.cuda.synchronize()
        want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
        err = check_close(f"(e) K1 B{b} H{h} T{t} D{d} ALiBi + causal + pad tails, live rows",
                          got.transpose(1, 2)[mask], want.transpose(1, 2)[mask],
                          BF16_ATOL, BF16_RTOL)
        del want
        allowed = (torch.ones(t, t, dtype=torch.bool, device=dev).tril()[None]
                   & mask[:, None, :])  # (B, T, T)
        dense = torch.where(allowed[:, None], bias[None, :, None, :],
                            float("-inf")).to(torch.bfloat16)  # (B, H, T, T)
        times = median_pair(torch, {
            "kernel": lambda: fa.grouped_mha(q, k, v, key_tiles=tiles, **kw),
            "call": lambda: fa.grouped_mha(q, k, v, **kw),  # the extents made per call
            "plain": lambda: fa.plain_mha(q, k, v, **kw),
            "sdpa": sdpa(torch, q, k, v, dense),
        }, reps=3, inner=5, rounds=1)
        del dense
        torch.cuda.empty_cache()
        bnd = bound(4.0 * h * d * k1_pairs(lengths, t), nbytes(q, k, v, got, mask, bias))
        print(f"  (e) K1 at B{b} H{h} T{t} D{d}: kernel {times['kernel']:.4f} ms (with the "
              f"extents made per call {times['call']:.4f}), plain {times['plain']:.4f} ms, SDPA "
              f"(dense bf16 mask) {times['sdpa']:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; {card})")
        records.append(dict(shape=f"B{b} H{h} T{t} D{d} ALiBi + causal + per-row pad tails, q "
                                  "pre-scaled (Tranception), extents made once",
                            ms=times["kernel"], call_ms=times["call"], plain_ms=times["plain"],
                            library_ms=times["sdpa"], max_abs_err=err, **bnd))
    print(f"  (d) per-token log-probs, kernel vs plain: max |diff| {max(errs):.3g} over "
          f"{config.num_layers} bf16 layers (atol {TRANCEPTION_LOGP_ATOL:g}); K1 alone at both shapes: "
          f"{max(r['max_abs_err'] for r in records):.3g}")
    return {"launches": run_a["launches"], "long_launches": launches_b, "eve_launches": launches_c,
            "k1_err": max(r["max_abs_err"] for r in records), "logp_err": max(errs),
            "k1": records}


def indel_variants(seq: str, counts, seed: int):
    """Distinct indel variants of ``seq``, spread along it: ``counts`` =
    (deletions, insertions, a substitution plus an indel, two indels),
    each indel of 1-3 residues at a seeded position."""
    rs = np.random.RandomState(seed)

    def indel(s, insert):
        at, size = rs.randint(0, len(s) + 1), rs.randint(1, 4)
        if insert:
            return s[:at] + "".join(AA[i] for i in rs.randint(0, 20, size)) + s[at:]
        return s[:at] + s[at + size:]

    def sub(s):
        p = rs.randint(len(s))
        return s[:p] + AA[(AA.index(s[p]) + 1 + rs.randint(19)) % 20] + s[p + 1:]

    makers = (lambda: indel(seq, False), lambda: indel(seq, True),
              lambda: indel(sub(seq), rs.rand() < 0.5),
              lambda: indel(indel(seq, rs.rand() < 0.5), rs.rand() < 0.5))
    out, seen = [], {seq}
    for n, make in zip(counts, makers):
        made = 0
        while made < n:
            v = make()
            if v not in seen:
                seen.add(v)
                out.append(v)
                made += 1
    return out


def spans_of(torch, spans, name, fn):
    """``fn`` with its host seconds, device synchronised at both ends,
    added to ``spans[name]``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


def capturing(torch, module, name, store):
    """``module.name`` patched to keep its last arguments and result in
    ``store`` and to add its host seconds (device synchronised at both
    ends) to ``store["seconds"]``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        store.update(args=args, kwargs=kwargs, out=out,
                     seconds=store.get("seconds", 0.0) + time.perf_counter() - t0,
                     calls=store.get("calls", 0) + 1)
        return out
    return mock.patch.object(module, name, wrapper)


def kernel_kind(name: str) -> str:
    """The kind of a device kernel, from its name: dense products, the
    normal draws, Adam, the batch draw, or elementwise and reductions."""
    low = name.lower()
    if any(key in low for key in ("gemm", "cutlass", "xmma", "splitk", "nvjet")):
        return "GEMM"
    if "adam" in low:
        return "Adam"
    if "multinomial" in low:
        return "batch draw"
    if "normal" in low or "randn" in low:
        return "normal draws"
    return "elementwise and reductions"


def device_seconds(torch, fn, by_kernel=None):
    """``fn()``, its wall, the summed device time of what it ran on the
    card (torch.profiler; None when the profiler reads none), the number
    of those launches and their device seconds by ``kernel_kind``; a dict
    ``by_kernel`` also gets each kernel's device seconds by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / 1e6 if kernels else None
    kinds = {}
    for e in kernels:
        kinds[kernel_kind(e.key)] = kinds.get(kernel_kind(e.key), 0.0) + e.device_time_total / 1e6
        if by_kernel is not None:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + e.device_time_total / 1e6
    return out, wall, busy, sum(e.count for e in kernels), kinds


def profile_forwards(torch, fa, fn):
    """``fn()``, which returns the number of forwards it ran, under
    torch.profiler, its launches taken back out of ``fa.LAUNCHES`` and
    ``ln.LAUNCHES`` (they are the measurement's, not the path's): the idle
    share, device ms a forward, the GEMMs' share of the device time and the
    four kernels that took most of it; None when the profiler reads no
    device time."""
    from proteingym_tpu_torch.ops import layer_norm as ln

    counts, per = saved_launches(fa.LAUNCHES, ln.LAUNCHES), {}
    forwards, wall, busy, _, kinds = device_seconds(torch, fn, by_kernel=per)
    restore_launches(counts)
    if busy is None:
        return None
    top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
    return dict(idle=1.0 - busy / wall, ms=busy / forwards * 1e3,
                gemm=kinds.get("GEMM", 0.0) / busy,
                top="; ".join(f"{name[:60]} {s / busy:.1%}" for name, s in top))


def keeping(module, name, kept):
    """``module.name`` patched to keep its last result in ``kept[name]``:
    the model a CLI run built."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        kept[name] = fn(*args, **kwargs)
        return kept[name]
    return mock.patch.object(module, name, wrapper)


def counting(box, owner, name):
    """``owner.name`` patched to add one to ``box[0]`` at each call: the
    forwards a CLI run makes."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        box[0] += 1
        return fn(*args, **kwargs)
    return mock.patch.object(owner, name, wrapper)


def profile_two(torch, fa, forward):
    """``profile_forwards`` of two no-grad calls of ``forward``."""
    def fn():
        with torch.no_grad():
            forward()
            forward()
        return 2
    return profile_forwards(torch, fa, fn)


def cli_score(torch, cli, root, n, model, dms_id, column, counters, batch_size,
              checkpoint=None, flags=(), extra=(), patches=()):
    """One ``score`` run of the port's CLI on the card, on
    ``root/reference.csv`` and ``root/dms``, every launch counter of
    ``counters`` set to 0 just before it and ``patches`` in force during
    it. Fails unless it exits 0 and writes ``column`` for ``n`` rows;
    returns its wall, launches, scores, peak memory and mutants/s."""
    for counts in counters:
        for name in counts:
            counts[name] = 0
    torch.cuda.reset_peak_memory_stats()
    out_dir = Path(tempfile.mkdtemp(prefix=f"{model}_", dir=root))
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        rc = cli.main([
            "score", "--model", model, *(["--checkpoint", checkpoint] if checkpoint else []),
            "--dms-id", dms_id, "--dms-reference", str(root / "reference.csv"),
            "--dms-dir", str(root / "dms"), "--output-dir", str(out_dir),
            "--batch-size", str(batch_size), "--device", "cuda", "--quiet", "--fail-fast",
            *flags, *(["--extra", *extra] if extra else [])])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{model} score CLI exited {rc} on {dms_id}")
    return dict(wall=wall, launches={k: v for c in counters for k, v in c.items()}, n=n,
                scores=read_scores(out_dir / f"{dms_id}.csv", column, n),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, mutants_per_s=n / wall,
                out=out_dir / f"{dms_id}.csv")


def report_run(tag, what, r, card, column, want_forwards, per_forward, extra_launches=None,
               detail=""):
    """Fail unless run ``r`` made ``want_forwards`` forwards, launched the
    kernels of ``per_forward`` ({counter: n}) that often in each, plus
    ``extra_launches``, and no other kernel; print its line: the column's
    finite count, the CLI wall, mutants/s, ``detail``, peak memory and the
    profiled forwards of ``r["profile"]``."""
    if r["forwards"] != want_forwards:
        fail(f"{what}: {r['forwards']} forwards, expected {want_forwards}")
    want = {k: v * r["forwards"] for k, v in per_forward.items()}
    for k, v in (extra_launches or {}).items():
        want[k] = want.get(k, 0) + v
    check_launches(what, r["launches"], want)
    prof = r.get("profile")
    prof_s = "not read" if prof is None else (
        f"{prof['idle']:.3f} (device {prof['ms']:.2f} ms a forward, GEMMs {prof['gemm']:.1%}; "
        f"most time: {prof['top']})")
    print(f"  ({tag}) {what}: {column} {int(np.isfinite(r['scores']).sum())}/{r['n']} finite; "
          f"CLI wall {r['wall']:.2f} s -> {r['mutants_per_s']:.1f} mutants/s; {r['forwards']} "
          "forwards, per forward "
          + (", ".join(f"{v} {k}" for k, v in per_forward.items()) or "no kernel of the port")
          + f"{detail}; peak {r['peak_gib']:.2f} GiB; idle share of the profiled forwards "
          f"{prof_s} ({card})")


INDEL_REFERENCE = ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                   "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name",
                   "taxon", "coarse_selection_type", "MSA_Neff_L_category",
                   "DMS_total_number_mutants"]


def phase_indels(torch, dev, card, fa, check_close):
    """15. The indel track and the alignment baselines through the port's
    CLI: (a) ``score --indel-mode`` with TranceptEVE and then Tranception
    with MSA retrieval on an L=400 target with 2,000 indel variants and the
    WT, per-token log-probs of 8 indel rows against the plain attention,
    and K1 at the indel bucket; (b) ``hmm`` on it with --indel-mode and on
    phase 14's L=250 substitution assay; (c) ``site_independent`` and
    ``potts`` (300 Adam steps) on the L=250 assay, the trained model
    written as a plmc file and scored again through --checkpoint; (d)
    ``merge`` and ``evaluate --mutation-type indels`` of (a) and (b)."""
    from proteingym_tpu_torch import native
    from proteingym_tpu_torch.models import ar_scoring, eve, hmm, potts, retrieval, tranception
    from proteingym_tpu_torch.models import trancepteve as te
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli
    from proteingym_tpu_torch.pipeline.checkpoints import (
        TRANCEPTION_PRESETS, load_tranception_checkpoint,
    )

    s = INDEL_SLICE
    length, covered, batch = s["length"], s["covered"], s["batch"]
    config = TRANCEPTION_PRESETS[s["checkpoint"]]
    rs = np.random.RandomState(15)
    codes = rs.randint(1, 21, length)
    seq = "".join(GAP_AA[c] for c in codes)
    variants = indel_variants(seq, s["variants"], 15)
    assay = variants + [seq]  # the WT last
    y = np.random.RandomState(16).randn(len(assay))
    # phase 14's L=250 target, alignment and singles
    t = TRANCEPTION_SLICE
    codes250 = np.random.RandomState(13).randint(1, 21, t["length"])
    seq250 = "".join(GAP_AA[c] for c in codes250)
    singles = [f"{seq250[p]}{p + 1}{a}" for p in range(t["length"]) for a in AA
               if a != seq250[p]]
    t0 = time.perf_counter()
    native.get_lib()
    print(f"[indels] L={length} target, {len(variants)} unique indel variants "
          f"({', '.join(map(str, s['variants']))}: deletions, insertions, substitution + indel, "
          f"two indels) + WT, MSA N={s['n_seqs']} over residues 1-{covered}; the aligner "
          f"built with g++ in {time.perf_counter() - t0:.2f} s ({native.library_path().name}); "
          f"{card}")

    def reset():
        for counts in (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES):
            for name in counts:
                counts[name] = 0

    def launched():
        return {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}

    forwards = [0]
    plain_forward = tranception.Tranception.forward

    def counted_forward(self, tokens):
        forwards[0] += 1
        return plain_forward(self, tokens)

    plans = ar_scoring.get_sequence_slices(assay, assay, seq, config.n_ctx - 2, indel_mode=True)
    buckets = ar_scoring._length_buckets(np.asarray([len(p.sliced_sequence) + 2 for p in plans]))
    n_fwd = 2 * sum(-(-int((buckets == b).sum()) // batch) for b in np.unique(buckets))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "msa").mkdir()
        (root / "dms").mkdir()
        write_a2m(root / "msa" / "SYNTH_INDEL.a2m", "SYNTH_INDEL",
                  synth_family(codes[:covered], s["n_seqs"], 15))
        write_a2m(root / "msa" / "SYNTH250.a2m", "SYNTH250",
                  synth_family(codes250[:t["covered"]], t["n_seqs"], 13))
        eve_file = root / "eve.pt"
        torch.save(eve.checkpoint_dict(eve.init_random(eve.EveConfig(seq_len=covered), seed=15,
                                                       device=dev)), eve_file)
        cut = np.quantile(y, 0.7)
        write_csv_rows(root / "dms" / "SYNTH_INDEL.csv",
                       ["mutant", "mutated_sequence", "DMS_score", "DMS_score_bin"],
                       [[v, v, repr(float(x)), int(x > cut)] for v, x in zip(assay, y)])
        write_csv_rows(root / "dms" / "SYNTH_L250.csv", ["mutant", "DMS_score"],
                       [[m, "0.5"] for m in singles])
        write_csv_rows(root / "dms" / "SYNTH_L250_WT.csv", ["mutant", "DMS_score"],
                       [[m, "0.5"] for m in singles + ["WT"]])
        write_csv_rows(root / "indels.csv", INDEL_REFERENCE, [[
            "SYNTH_INDEL", "SYNTH_INDEL.csv", "SYNTH", seq, length, "SYNTH_INDEL.a2m", 1,
            covered, 0.2, "SYNTH_INDEL.npy", "Human", "Stability", "Medium", len(assay)]])
        write_csv_rows(root / "l250.csv", INDEL_REFERENCE, [
            [dms_id, f"{dms_id}.csv", "SYNTH", seq250, t["length"], "SYNTH250.a2m", 1,
             t["covered"], 0.2, "SYNTH250.npy", "Human", "Stability", "Medium", n]
            for dms_id, n in (("SYNTH_L250", len(singles)), ("SYNTH_L250_WT", len(singles) + 1))])

        def score(model, ref, dms_id, out_dir, checkpoint=None, extra=(), indel=False):
            rc = cli.main([
                "score", "--model", model, "--dms-id", dms_id, "--msa-dir", str(root / "msa"),
                "--weights-dir", str(root / "weights"), "--dms-reference", str(root / ref),
                "--dms-dir", str(root / "dms"), "--output-dir", str(root / out_dir),
                "--batch-size", str(batch), "--device", dev.type, "--quiet", "--fail-fast",
                *(["--indel-mode"] if indel else []),
                *(["--checkpoint", checkpoint] if checkpoint else []),
                *(["--extra", *extra] if extra else [])])
            if rc != 0:
                fail(f"{model} score CLI exited {rc} on {dms_id}")
            return read_table(root / out_dir / f"{dms_id}.csv")

        header = ["mutated_sequence", "avg_score_L_to_R", "avg_score_R_to_L", "avg_score"]

        def check_table(rows, what):
            if rows[0] != header or [r[0] for r in rows[1:]] != assay:
                fail(f"{what} CSV: columns {rows[0]}, {len(rows) - 1} rows; expected {header} "
                     f"over the {len(assay)} sequences in assay order")
            scores = np.asarray([r[1:] for r in rows[1:]], dtype=np.float64)
            if not np.isfinite(scores).all() or rows[-1][1:] != ["0.0"] * 3:
                fail(f"{what} CSV: non-finite scores, or the WT row {rows[-1][1:]} is not 0")

        # (a) TranceptEVE --indel-mode
        spans, stacks = {}, {}
        make_indel_fusion = retrieval.make_indel_fusion

        def recorded_fusion(*args, **kwargs):
            fusion, table_of = make_indel_fusion(*args, **kwargs)
            stacks.update(tables=len(table_of), bytes=nbytes(fusion.msa_lp, fusion.eve_lp),
                          l_pad=fusion.msa_lp.shape[1])
            return fusion, table_of

        def run_a(model, out_dir, extra):
            reset()
            spans.clear()
            forwards[0] = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with mock.patch.object(tranception.Tranception, "forward", counted_forward), \
                    mock.patch.object(retrieval, "_align_to_reference",
                                      spans_of(torch, spans, "align",
                                               retrieval._align_to_reference)), \
                    mock.patch.object(retrieval, "make_indel_fusion",
                                      spans_of(torch, spans, "realign", recorded_fusion)), \
                    mock.patch.object(retrieval, "eve_log_prior",
                                      spans_of(torch, spans, "eve_prior",
                                               retrieval.eve_log_prior)), \
                    mock.patch.object(te, "score_trancepteve",
                                      spans_of(torch, spans, "scoring", te.score_trancepteve)):
                rows = score(model, "indels.csv", "SYNTH_INDEL", out_dir, s["checkpoint"], extra,
                             indel=True)
            wall = time.perf_counter() - t0
            return rows, wall, launched(), torch.cuda.max_memory_allocated() / 2**30

        rows, wall, launches, peak = run_a("trancepteve", "TranceptEVE_L", [
            "retrieval_type=TranceptEVE", f"eve_checkpoints={eve_file}",
            f"eve_num_samples={s['eve_num_samples']}"])
        if forwards[0] != n_fwd:
            fail(f"trancepteve --indel-mode: {forwards[0]} forwards, expected {n_fwd}")
        want = {"cluster_counts": 1, "grouped_attention": config.num_layers * n_fwd}
        print(f"  (a) launches {launches} (expected {want}; rope_qk and K2-K4 0)")
        check_launches("trancepteve --indel-mode", launches, want)
        check_table(rows, "trancepteve --indel-mode")
        ar_s = spans["scoring"] - spans["realign"]
        print(f"  (a) TranceptEVE: {stacks['tables']} unique sequences and alignments (the "
              f"variants and the WT), aligner {spans['align']:.3f} s, realignment (aligner + "
              f"tables + upload) {spans['realign']:.3f} s; two stacks of {stacks['tables']} x "
              f"{stacks['l_pad']} x 25 float32, {stacks['bytes'] / 1e6:.1f} MB on the card; EVE "
              f"prior {spans['eve_prior']:.2f} s; {n_fwd} forwards of {batch} x "
              f"{int(buckets.max())} ({config.num_layers} K1 each), AR scoring {ar_s:.2f} s -> "
              f"{len(variants) / ar_s:.2f} mutants/s; CLI wall {wall:.2f} s, peak {peak:.2f} GiB "
              f"({card})")
        out["a"] = dict(launches=launches, wall_s=wall, spans=dict(spans), stacks=dict(stacks),
                        peak_gib=peak, forwards=n_fwd)
        # Tranception with MSA retrieval, --indel-mode, under the profiler
        # for the idle share (the weights file exists now: no K5)
        (rows, wall, launches, peak), wall_p, busy, n_kernels, _ = device_seconds(
            torch, lambda: run_a("tranception", "Tranception_L", ["retrieval_type=Tranception"]))
        check_launches("tranception --indel-mode", launches,
                       {"grouped_attention": config.num_layers * n_fwd})
        check_table(rows, "tranception --indel-mode")
        ar_s = spans["scoring"] - spans["realign"]
        idle = None if busy is None else 1.0 - busy / wall_p
        print(f"  (a) Tranception + MSA retrieval (under torch.profiler): aligner "
              f"{spans['align']:.3f} s, realignment {spans['realign']:.3f} s, AR scoring "
              f"{ar_s:.2f} s -> {len(variants) / ar_s:.2f} mutants/s; CLI wall {wall:.2f} s, "
              f"peak {peak:.2f} GiB; {n_kernels} kernels, device busy "
              + ("not read" if busy is None else f"{busy:.2f} s, idle share {idle:.3f}")
              + f" ({card})")
        out["a_tranception"] = dict(launches=launches, wall_s=wall, spans=dict(spans),
                                    device_s=busy, idle=idle, peak_gib=peak)

        # (b) the HMM, --indel-mode on the indel assay and on the L=250
        # substitution assay (its alignment's weights by K5 here)
        captured = {}
        score_sequences = hmm.score_sequences

        def captured_scores(model, seqs, device="cuda"):
            captured.update(model=model, seqs=list(seqs))
            captured["out"] = score_sequences(model, seqs, device=device)
            return captured["out"]

        for what, ref, dms_id, indel, want in (
                ("indels", "indels.csv", "SYNTH_INDEL", True, {}),
                ("L=250 substitutions", "l250.csv", "SYNTH_L250_WT", False,
                 {"cluster_counts": 1})):
            reset()
            spans.clear()
            with mock.patch.object(hmm, "build_profile_hmm",
                                   spans_of(torch, spans, "build", hmm.build_profile_hmm)), \
                    mock.patch.object(hmm, "score_sequences",
                                      spans_of(torch, spans, "forward", captured_scores)):
                rows = score("hmm", ref, dms_id, "HMM", indel=indel)
            check_launches(f"hmm {what}", launched(), want)
            cells = [r[-1] for r in rows[1:]]
            if rows[0][-1] != "HMM_score" or "" in cells or cells[-1] != "0.0" or not np.isfinite(
                    np.asarray(cells, dtype=np.float64)).all():
                fail(f"hmm {what}: column {rows[0][-1]}, {cells.count('')} empty fields, WT "
                     f"{cells[-1]!r}: expected finite scores and the WT row 0")
            t_len = max(len(x) for x in captured["seqs"])
            pick = np.unique(np.linspace(0, len(captured["seqs"]) - 1, HMM_CPU_ROWS).astype(int))
            on_cpu = score_sequences(captured["model"], [captured["seqs"][k] for k in pick],
                                     device="cpu")
            cpu_err = float(np.abs(captured["out"][pick] - on_cpu).max())
            if not cpu_err <= HMM_CPU_ATOL:
                fail(f"hmm {what}: {len(pick)} rows' log-probs, card against CPU: max |diff| "
                     f"{cpu_err:.3g} (atol {HMM_CPU_ATOL:g})")
            # the forward again under the profiler: launches and device time
            _, wall_h, busy_h, n_kernels, _ = device_seconds(
                torch, lambda: score_sequences(captured["model"], captured["seqs"], device=dev))
            host = None if busy_h is None else 1.0 - busy_h / wall_h
            print(f"  (b) hmm {what}: {len(cells)} finite scores, WT 0; {captured['model'].L} "
                  f"match states, build {spans['build']:.3f} s, forward {spans['forward']:.3f} s "
                  f"for {len(captured['seqs'])} rows x {t_len} steps -> "
                  f"{len(cells) / spans['forward']:.1f} mutants/s, {n_kernels / t_len:.1f} "
                  "launches per residue step; profiled: device busy "
                  + ("not read" if busy_h is None else
                     f"{busy_h:.3f} s of {wall_h:.3f} s, host share {host:.3f}")
                  + f"; {len(pick)} rows' log-probs against the CPU: max |diff| {cpu_err:.3g} "
                  f"(atol {HMM_CPU_ATOL:g}) ({card})")
            out[f"hmm_{'indel' if indel else 'sub'}"] = dict(
                spans=dict(spans), launches_per_step=n_kernels / t_len, rows=len(cells),
                device_s=busy_h, host_share=host, cpu_err=cpu_err)

        # (c) site_independent and potts on the L=250 singles
        reset()
        rows_si = score("site_independent", "l250.csv", "SYNTH_L250", "Site_Independent")
        trained = {}
        train = potts.train_potts_plm

        def captured_train(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = train(*args, **kwargs)
            trained.update(model=model, seconds=time.perf_counter() - t0, args=args,
                           kwargs=kwargs)
            return model

        spans.clear()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(potts, "train_potts_plm", captured_train), \
                mock.patch.object(potts.PottsModel, "delta_hamiltonians",
                                  spans_of(torch, spans, "dE", potts.PottsModel.delta_hamiltonians)):
            rows_p = score("potts", "l250.csv", "SYNTH_L250", "EVmutation")
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_launches("site_independent + potts", launched(), {})
        past = [i for i, m in enumerate(singles) if int(m[1:-1]) > t["covered"]]
        cols = {}
        for name, rows in (("Site_Independent_score", rows_si), ("EVmutation_score", rows_p)):
            cells = [r[-1] for r in rows[1:]]
            if rows[0][-1] != name or [i for i, c in enumerate(cells) if c == ""] != past:
                fail(f"{name}: column {rows[0][-1]}, {cells.count('')} empty fields (expected the "
                     f"{len(past)} mutants past residue {t['covered']})")
            cols[name] = np.asarray([float(c) for c in cells if c])
            if not np.isfinite(cols[name]).all():
                fail(f"{name}: non-finite scores")
        model, losses = trained["model"], trained["model"].losses
        diff = float(np.abs(cols["EVmutation_score"] - cols["Site_Independent_score"]).max())
        if not losses[-1] < losses[0] or diff < 1e-3:
            fail(f"potts: loss {losses[0]:.4f} -> {losses[-1]:.4f}, max |potts - site "
                 f"independent| {diff:.3g}")
        n_rows, lq = len(model.weights), model.L * model.q
        flops = 4.0 * n_rows * lq * lq * len(losses)  # the product and J's gradient, per step
        print(f"  (c) potts: {len(losses)} Adam steps on N={n_rows} x L={model.L} x q={model.q}: "
              f"{trained['seconds']:.2f} s, loss {losses[0]:.4f} (step 1) -> {losses[-1]:.4f} "
              f"(step {len(losses)}), {flops / trained['seconds'] / 1e12:.1f} TFLOP/s float32 "
              f"(peak {PEAK_F32_FLOPS / 1e12:.0f} without TF32); dE of {len(singles)} singles "
              f"{spans['dE']:.3f} s; peak {peak:.2f} GiB; {len(singles) - len(past)} finite scores "
              f"each, {len(past)} empty past residue {t['covered']}, max |potts - site "
              f"independent| {diff:.3f} ({card})")
        # the first steps on the card against the same steps in float64 on the CPU
        few = dict(trained["kwargs"], steps=POTTS_CPU_STEPS)
        on_card = train(*trained["args"], **dict(few, device=dev))
        t0 = time.perf_counter()
        torch.set_default_dtype(torch.float64)  # every tensor the trainer makes
        try:
            on_cpu = train(*trained["args"], **dict(few, device="cpu"))
        finally:
            torch.set_default_dtype(torch.float32)
        cpu_s = time.perf_counter() - t0
        potts_err = dict(
            loss=float(np.abs(on_card.losses / on_cpu.losses - 1.0).max()),
            h=float(np.linalg.norm(on_card.h - on_cpu.h) / np.linalg.norm(on_cpu.h)),
            J=float(np.linalg.norm(on_card.J - on_cpu.J) / np.linalg.norm(on_cpu.J)),
            J_max_abs=float(np.abs(on_card.J - on_cpu.J).max()))
        del on_card, on_cpu
        print(f"  (c) potts, the first {POTTS_CPU_STEPS} Adam steps on the card against float64 "
              f"on the CPU ({cpu_s:.1f} s there): losses rel {potts_err['loss']:.3g} (rtol "
              f"{POTTS_LOSS_RTOL:g}), h rel {potts_err['h']:.3g}, J rel {potts_err['J']:.3g} "
              f"(rtol {POTTS_HJ_RTOL:g}), J max |diff| {potts_err['J_max_abs']:.3g}")
        if not (potts_err["loss"] <= POTTS_LOSS_RTOL and potts_err["h"] <= POTTS_HJ_RTOL
                and potts_err["J"] <= POTTS_HJ_RTOL):
            fail(f"potts: the card's first {POTTS_CPU_STEPS} steps disagree with float64 on the "
                 f"CPU: {potts_err}")
        model_file = root / "potts.model"
        potts.write_plmc_model(model, model_file)
        rows_f = score("potts", "l250.csv", "SYNTH_L250", "EVmutation_file", str(model_file))
        again = np.asarray([float(r[-1]) for r in rows_f[1:] if r[-1]])
        file_err = float(np.abs(again - cols["EVmutation_score"]).max()) \
            if len(again) == len(cols["EVmutation_score"]) else float("inf")
        if not file_err <= POTTS_FILE_ATOL:
            fail(f"potts from its plmc file: max |diff| {file_err:.3g} (atol {POTTS_FILE_ATOL:g})")
        print(f"  (c) potts written with write_plmc_model and scored through --checkpoint: max "
              f"|diff| {file_err:.3g} (atol {POTTS_FILE_ATOL:g})")
        out["potts"] = dict(train_s=trained["seconds"], loss_first=float(losses[0]),
                            loss_last=float(losses[-1]), tflops=flops / trained["seconds"] / 1e12,
                            de_s=spans["dE"], peak_gib=peak, file_err=file_err,
                            cpu_err=potts_err, cpu_s=cpu_s)

        # (d) merge and evaluate --mutation-type indels of (a) and (b)
        models = {"TranceptEVE_L": ("TranceptEVE_L", "avg_score"),
                  "Tranception_L": ("Tranception_L", "avg_score"), "HMM": ("HMM", "HMM_score")}
        (root / "config.json").write_text(json.dumps({"model_list_zero_shot_indels_DMS": {
            name: {"input_score_name": col, "location": loc, "directionality": 1,
                   "key": "mutated_sequence", "model_type": "Alignment-based model"}
            for name, (loc, col) in models.items()}}))
        common = ["--dms-reference", str(root / "indels.csv"), "--config",
                  str(root / "config.json"), "--mutation-type", "indels"]
        if cli.main(["merge", "--dms-dir", str(root / "dms"), "--scores-root", str(root),
                     "--output-dir", str(root / "merged"), *common]) != 0:
            fail("merge --mutation-type indels failed")
        if cli.main(["evaluate", "--merged-dir", str(root / "merged"), "--output-dir",
                     str(root / "bench"), "--device", dev.type, "--no-html",
                     "--bootstrap-samples", "1000", *common]) != 0:
            fail("evaluate --mutation-type indels failed")
        summary = root / "bench" / "Spearman" / "Summary_performance_DMS_indels_Spearman.csv"
        table = read_table(summary) if summary.exists() else [[]]
        named = sorted(r[1] for r in table[1:])
        if named != sorted(models):
            fail(f"{summary.name}: models {named}, expected {sorted(models)}")
        print("  (d) merge + evaluate --mutation-type indels: " + ", ".join(
            f"{r[1]} Spearman {r[3]}" for r in table[1:]))

    # the per-token log-probs of 8 indel rows of (a), both directions, with
    # the kernel and with the plain attention in the model
    model, _ = load_tranception_checkpoint(s["checkpoint"], device=dev)  # the CLI's weights
    picks = [variants[i] for i in np.linspace(0, len(variants) - 1, s["logp_rows"]).astype(int)]
    texts = picks + [r[::-1] for r in picks]
    width = int(buckets.max())
    tokens = torch.from_numpy(np.stack([tranception.VOCAB.tokenize(x, pad_to=width)
                                        for x in texts])).long().to(dev)
    targets = tokens[:, 1:, None]
    live = targets[..., 0] != tranception.VOCAB.PAD

    def per_token():
        return torch.log_softmax(model(tokens), -1)[:, :-1].gather(-1, targets)[..., 0][live]

    with torch.no_grad():
        got = per_token()
        with mock.patch.object(tranception, "mha", fa.plain_mha):
            want = per_token()
    lens = sorted(len(x) for x in picks)
    logp_err = check_close(f"(a) per-token log-probs, {len(picks)} indel rows of {lens[0]}-"
                           f"{lens[-1]} residues, both directions, kernel vs plain", got, want,
                           TRANCEPTION_LOGP_ATOL, 0.0)
    del model, got, want
    torch.cuda.empty_cache()

    # K1 alone at the indel bucket: q pre-scaled, ALiBi, causal, and each
    # row's own pad tail of 1-31 tokens
    b, h, t_len = K1_INDEL
    d = 64
    gen = torch.Generator(device=dev).manual_seed(t_len)
    q, k, v = (torch.randn(b, t_len, h, d, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    q = (q.float() * 0.125).to(torch.bfloat16)
    lengths = [t_len - 1 - (i % 31) for i in range(b)]
    mask = torch.arange(t_len, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    bias = tranception.alibi_bias(h, t_len, dev)
    kw = dict(key_mask=mask, bias=bias, causal=True, sm_scale=1.0)
    tiles = fa.KeyTiles(None, mask, True)
    got = fa.grouped_mha(q, k, v, key_tiles=tiles, **kw)
    torch.cuda.synchronize()
    want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
    err = check_close(f"K1 B{b} H{h} T{t_len} D{d} ALiBi + causal + pad tails 1-31, live rows",
                      got.transpose(1, 2)[mask], want.transpose(1, 2)[mask], BF16_ATOL, BF16_RTOL)
    del want
    allowed = torch.ones(t_len, t_len, dtype=torch.bool, device=dev).tril()[None] & mask[:, None]
    dense = torch.where(allowed[:, None], bias[None, :, None, :],
                        float("-inf")).to(torch.bfloat16)
    times = median_pair(torch, {
        "kernel": lambda: fa.grouped_mha(q, k, v, key_tiles=tiles, **kw),
        "call": lambda: fa.grouped_mha(q, k, v, **kw),
        "plain": lambda: fa.plain_mha(q, k, v, **kw),
        "sdpa": sdpa(torch, q, k, v, dense),
    }, reps=3, inner=5, rounds=1)
    del dense
    torch.cuda.empty_cache()
    bnd = bound(4.0 * h * d * k1_pairs(lengths, t_len), nbytes(q, k, v, got, mask, bias))
    print(f"  (a) K1 at B{b} H{h} T{t_len} D{d}: kernel {times['kernel']:.4f} ms (with the extents "
          f"made per call {times['call']:.4f}), plain {times['plain']:.4f} ms, SDPA (dense bf16 "
          f"mask) {times['sdpa']:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; "
          f"{card})")
    out["k1"] = dict(shape=f"B{b} H{h} T{t_len} D{d} ALiBi + causal + per-row pad tails of 1-31, "
                           "q pre-scaled (whole indel rows), extents made once",
                     ms=times["kernel"], call_ms=times["call"], plain_ms=times["plain"],
                     library_ms=times["sdpa"], max_abs_err=err, **bnd)
    out["logp_err"] = logp_err
    return out


def params_against(card_model, cpu_model, start, atol):
    """Each parameter tensor after Adam steps from the state ``start``:
    the share of its entries where card and CPU differ by more than
    ``atol``, its largest |card - CPU|, and ||card - CPU|| / ||CPU -
    start|| (Frobenius norms in float64). Returns, for each of the three,
    the worst value over the tensors and the tensor's name."""
    worst = {"share": (0.0, None), "max_abs": (0.0, None), "rel_update": (0.0, None)}
    cpu_state = cpu_model.state_dict()
    for name, value in card_model.state_dict().items():
        diff = value.cpu().double() - cpu_state[name].double()
        update = float((cpu_state[name].double() - start[name].double()).norm())
        off = float(diff.norm())
        reading = {"share": float((diff.abs() > atol).double().mean()),
                   "max_abs": float(diff.abs().max()),
                   "rel_update": off / update if update > 0 else (0.0 if off == 0 else math.inf)}
        for key, v in reading.items():
            if v > worst[key][0]:
                worst[key] = (v, name)
    return worst


def held_to(worst, atol, max_abs):
    """``params_against``'s readings as a line, and whether they are
    within ``TRAINER_CPU_SHARE``, ``max_abs`` and
    ``TRAINER_CPU_REL_UPDATE``."""
    (share, at_share), (big, at_big), (rel, at_rel) = (
        worst["share"], worst["max_abs"], worst["rel_update"])
    line = (f"worst tensor: share beyond {atol:g} {share:.3g} ({at_share}; at most "
            f"{TRAINER_CPU_SHARE:g}), max |diff| {big:.3g} ({at_big}; at most {max_abs:g}), "
            f"||card - CPU|| / ||update|| {rel:.3g} ({at_rel}; at most {TRAINER_CPU_REL_UPDATE:g})")
    return line, share <= TRAINER_CPU_SHARE and big <= max_abs and rel <= TRAINER_CPU_REL_UPDATE


def phase_trainers(torch, dev, card, fa):
    """16. The trainers from the alignment through the port's CLI, on
    phase 13/14's L=250 target and 16,384-row alignment over residues
    1-240 and phase 15's L=400 indel assay, with no weights file (so K5
    runs once per alignment load): (a) ``train --model eve --steps
    10000`` at EVE's default architecture; (b) ``score --model
    deepsequence`` without --checkpoint; (c) ``score --model trancepteve``
    with the EVE file of (a) on the first 512 singles; (d) ``train --model
    potts``; (e) ``score --model wavenet`` on the indel assay and on the
    singles; (f) the first Adam steps of EVE and WaveNet on the card
    against the same steps on the CPU."""
    from proteingym_tpu_torch.devices import adam
    from proteingym_tpu_torch.models import eve, potts, retrieval, tranception, wavenet
    from proteingym_tpu_torch.models import trancepteve as te
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli
    from proteingym_tpu_torch.pipeline.checkpoints import TRANCEPTION_PRESETS

    s, t, ind = TRAINER_SLICE, TRANCEPTION_SLICE, INDEL_SLICE
    length, covered = t["length"], t["covered"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 13/14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    past = [i for i, m in enumerate(singles) if int(m[1:-1]) > covered]
    codes400 = np.random.RandomState(15).randint(1, 21, ind["length"])  # phase 15's target
    seq400 = "".join(GAP_AA[c] for c in codes400)
    assay = indel_variants(seq400, ind["variants"], 15) + [seq400]
    config = TRANCEPTION_PRESETS[s["checkpoint"]]
    phase_t0 = time.perf_counter()
    print(f"[trainers] EVE, DeepSequence, Potts and WaveNet trained from the alignment through "
          f"the CLI ({card}): L={length} target with {len(singles)} singles, MSA N={t['n_seqs']} "
          f"over residues 1-{covered}; L={ind['length']} with {len(assay) - 1} indel variants + "
          f"WT, MSA N={ind['n_seqs']} over residues 1-{ind['covered']}; no weights file")

    def reset():
        for counts in (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES):
            for name in counts:
                counts[name] = 0

    def launched():
        return {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}

    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "msa").mkdir()
        (root / "dms").mkdir()
        write_a2m(root / "msa" / "SYNTH.a2m", "SYNTH", synth_family(codes[:covered], t["n_seqs"], 13))
        write_a2m(root / "msa" / "SYNTH_INDEL.a2m", "SYNTH_INDEL",
                  synth_family(codes400[:ind["covered"]], ind["n_seqs"], 15))
        write_csv_rows(root / "dms" / "SYNTH_L250.csv", ["mutant", "DMS_score"],
                       [[m, "0.5"] for m in singles])
        write_csv_rows(root / "dms" / "SYNTH_L250_FIRST.csv", ["mutant", "DMS_score"],
                       [[m, "0.5"] for m in singles[:s["trancepteve_mutants"]]])
        write_csv_rows(root / "dms" / "SYNTH_INDEL.csv", ["mutant", "mutated_sequence", "DMS_score"],
                       [[v, v, "0.5"] for v in assay])
        cells = ["SYNTH.a2m", 1, covered, 0.2, "SYNTH.npy"]
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                        "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"],
                       [["SYNTH_L250", "SYNTH_L250.csv", "SYNTH", seq, length, *cells],
                        ["SYNTH_L250_FIRST", "SYNTH_L250_FIRST.csv", "SYNTH", seq, length, *cells],
                        ["SYNTH_INDEL", "SYNTH_INDEL.csv", "SYNTH", seq400, ind["length"],
                         "SYNTH_INDEL.a2m", 1, ind["covered"], 0.2, "SYNTH_INDEL.npy"]])
        common = ["--dms-reference", str(root / "reference.csv"), "--msa-dir", str(root / "msa"),
                  "--device", dev.type]

        def train(model, steps):
            rc = cli.main(["train", "--model", model, "--dms-id", "SYNTH_L250", "--steps",
                           str(steps), "--seed", "0", "--output-dir", str(root / "models"),
                           *common])
            if rc != 0:
                fail(f"train --model {model} exited {rc}")

        def score(model, dms_id, extra=(), checkpoint=None):
            rc = cli.main(["score", "--model", model, "--dms-id", dms_id, "--dms-dir",
                           str(root / "dms"), "--output-dir", str(root / model), "--batch-size",
                           str(s["batch"]), "--quiet", "--fail-fast", *common,
                           *(["--checkpoint", checkpoint] if checkpoint else []),
                           *(["--extra", *extra] if extra else [])])
            if rc != 0:
                fail(f"score --model {model} exited {rc} on {dms_id}")
            return read_table(root / model / f"{dms_id}.csv")

        # (a) train --model eve at the default architecture
        trained = {}
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with capturing(torch, eve, "train", trained):
            train("eve", s["eve_steps"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        out["launches"]["eve_train"] = launched()
        check_launches("train --model eve", launched(), {"cluster_counts": 1})
        eve_file = root / "models" / "eve_SYNTH_L250_seed0"
        model = trained["out"]
        losses = model.losses
        n_params = sum(p.numel() for p in model.parameters())
        if not (eve_file.is_file() and model.config == eve.EveConfig(seq_len=covered)
                and len(losses) == s["eve_steps"] and np.isfinite(losses).all()
                and losses[-100:].mean() < losses[:100].mean()):
            fail(f"train --model eve: file {eve_file.is_file()}, config {model.config}, "
                 f"{len(losses)} losses, first 100 {losses[:100].mean():.2f}, last 100 "
                 f"{losses[-100:].mean():.2f}")
        steps_per_s = s["eve_steps"] / trained["seconds"]
        print(f"  (a) train --model eve --steps {s['eve_steps']}: {n_params / 1e6:.2f}M parameters, "
              f"training {trained['seconds']:.2f} s -> {steps_per_s:.1f} steps/s "
              f"({1e3 / steps_per_s:.3f} ms a step); loss {losses[:100].mean():.2f} (steps 1-100) "
              f"-> {losses[-100:].mean():.2f} (last 100); CLI wall {wall:.2f} s (alignment, K5, "
              f"one-hots, file); peak device memory {peak:.2f} GiB ({card})")
        onehot, weights, eve_config = trained["args"]
        # the entry itself under the profiler: eve.train for 200 steps, its
        # set-up (the init, the one-hots' upload) included
        n_prof = s["profiled_steps"]
        prof_model, prof_wall, busy, n_kernels, kinds = device_seconds(
            torch, lambda: eve.train(onehot, weights, eve_config, steps=n_prof, seed=1, device=dev))
        # the decoder KL's forward and backward alone: device time and launches
        prof_model.requires_grad_(True)
        _, _, kl_busy, kl_launches, _ = device_seconds(torch, lambda: [
            eve.kld_decoder_params(prof_model).backward() for _ in range(10)])
        kl_ms = None if kl_busy is None else kl_busy * 1e2
        print(f"  (a) eve.train for {n_prof} steps profiled: wall {prof_wall:.3f} s, "
              + ("device busy not read" if busy is None else
                 f"device busy {busy:.3f} s, idle share {1 - busy / prof_wall:.3f}; by kind "
                 + ", ".join(f"{k} {v * 1e3 / n_prof:.3f} ms" for k, v in sorted(kinds.items()))
                 + " a step")
              + f"; {n_kernels / n_prof:.1f} launches a step; the decoder KL alone (forward and "
              f"backward): device {kl_ms} ms, {kl_launches / 10:.0f} launches ({card})")
        out["eve"] = dict(steps=s["eve_steps"], train_s=trained["seconds"], steps_per_s=steps_per_s,
                          loss_first100=float(losses[:100].mean()),
                          loss_last100=float(losses[-100:].mean()), peak_gib=peak, cli_wall_s=wall,
                          params=n_params, profiled_wall_s=prof_wall, busy_s=busy,
                          idle_share=None if busy is None else 1 - busy / prof_wall,
                          kinds_ms_per_step={k: v * 1e3 / n_prof for k, v in kinds.items()},
                          launches_per_step=n_kernels / n_prof, kl_ms=kl_ms,
                          kl_launches=kl_launches / 10)
        del prof_model, model, trained
        torch.cuda.empty_cache()

        # (b) deepsequence without --checkpoint
        spans = {}
        reset()
        t0 = time.perf_counter()
        with mock.patch.object(eve, "train", spans_of(torch, spans, "train", eve.train)), \
                mock.patch.object(eve, "evol_indices",
                                  spans_of(torch, spans, "evol", eve.evol_indices)):
            table = score("deepsequence", "SYNTH_L250",
                          [f"train_steps={s['deepsequence_steps']}",
                           f"num_samples={s['deepsequence_samples']}"])
        wall_b = time.perf_counter() - t0
        out["launches"]["deepsequence"] = launched()
        check_launches("deepsequence", launched(), {"cluster_counts": 1})
        column = [r[-1] for r in table[1:]]
        if table[0] != ["mutant", "DMS_score", "mutated_sequence", "DeepSequence_evol_indices"] \
                or [i for i, c in enumerate(column) if c == ""] != past:
            fail(f"deepsequence CSV: columns {table[0]}, {column.count('')} empty fields "
                 f"(expected the {len(past)} mutants past residue {covered})")
        evol = np.asarray([float(c) for c in column if c])
        if not (np.isfinite(evol).all() and np.ptp(evol) > 0):
            fail("deepsequence: non-finite or constant evol indices")
        print(f"  (b) deepsequence, no checkpoint: {len(evol)} finite evol indices, {len(past)} "
              f"empty; training {spans['train']:.2f} s ({s['deepsequence_steps']} steps), evol "
              f"indices {spans['evol']:.2f} s ({s['deepsequence_samples']} draws), CLI wall {wall_b:.2f} s -> "
              f"{len(singles) / wall_b:.1f} mutants/s ({card})")
        out["deepsequence"] = dict(train_s=spans["train"], evol_s=spans["evol"], wall_s=wall_b)

        # (c) TranceptEVE with the EVE file of (a)
        spans = {}
        forwards = [0]
        plain_forward = tranception.Tranception.forward

        def counted_forward(self, tokens):
            forwards[0] += 1
            return plain_forward(self, tokens)

        reset()
        n_first = s["trancepteve_mutants"]
        t0 = time.perf_counter()
        with mock.patch.object(tranception.Tranception, "forward", counted_forward), \
                mock.patch.object(retrieval, "eve_log_prior",
                                  spans_of(torch, spans, "eve_prior", retrieval.eve_log_prior)), \
                mock.patch.object(te, "score_trancepteve",
                                  spans_of(torch, spans, "ar_scoring", te.score_trancepteve)):
            table = score("trancepteve", "SYNTH_L250_FIRST",
                          ["retrieval_type=TranceptEVE", f"eve_checkpoints={eve_file}",
                           f"eve_num_samples={s['eve_num_samples']}"],
                          checkpoint=s["checkpoint"])
        wall_c = time.perf_counter() - t0
        n_fwd = 2 * -(-(n_first + 1) // s["batch"])  # the mutants and one WT row, both ways
        out["launches"]["trancepteve_trained_eve"] = launched()
        if forwards[0] != n_fwd:
            fail(f"trancepteve: {forwards[0]} forwards, expected {n_fwd}")
        check_launches("trancepteve with the trained EVE", launched(),
                       {"cluster_counts": 1, "grouped_attention": config.num_layers * n_fwd})
        scores_c = np.asarray([r[1:] for r in table[1:]], dtype=np.float64)
        if table[0] != ["mutated_sequence", "avg_score_L_to_R", "avg_score_R_to_L", "avg_score"] \
                or len(scores_c) != n_first or not np.isfinite(scores_c).all():
            fail(f"trancepteve CSV: columns {table[0]}, {len(scores_c)} rows, or non-finite")
        print(f"  (c) trancepteve with the EVE file of (a): {n_first} x 3 finite scores; "
              f"{config.num_layers} x {n_fwd} K1 launches (B{s['batch']} H20 T256) and 1 K5; EVE "
              f"prior {spans['eve_prior']:.2f} s ({s['eve_num_samples']} draws), AR scoring "
              f"{spans['ar_scoring']:.2f} s -> {n_first / spans['ar_scoring']:.1f} mutants/s; CLI "
              f"wall {wall_c:.2f} s -> {n_first / wall_c:.1f} mutants/s ({card})")
        out["trancepteve"] = dict(eve_prior_s=spans["eve_prior"], ar_s=spans["ar_scoring"],
                                  wall_s=wall_c, forwards=n_fwd)

        # (d) train --model potts, and its file read back
        trained = {}
        reset()
        with capturing(torch, potts, "train_potts_plm", trained):
            train("potts", s["potts_steps"])
        out["launches"]["potts_train"] = launched()
        check_launches("train --model potts", launched(), {"cluster_counts": 1})
        model = trained["out"]
        back = potts.read_plmc_model(root / "models" / "potts_SYNTH_L250_seed0.model")
        f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
        file_err = max(float(np.abs(back.h - f32(model.h)).max()),
                       float(np.abs(back.J - f32(model.J)).max()))
        if not (file_err <= POTTS_FILE_ATOL and back.target_seq == model.target_seq
                and np.array_equal(back.index_list, model.index_list)
                and len(model.losses) == s["potts_steps"]):
            fail(f"train --model potts: the file read back differs from the trained model "
                 f"(max |diff| {file_err:.3g}) or its losses ({len(model.losses)}) are short")
        print(f"  (d) train --model potts --steps {s['potts_steps']}: {trained['seconds']:.2f} s, "
              f"loss {model.losses[0]:.4f} -> {model.losses[-1]:.4f}; the .model file read back "
              f"equals the trained h and J (max |diff| {file_err:.3g}, atol {POTTS_FILE_ATOL:g})")
        out["potts"] = dict(train_s=trained["seconds"], file_err=file_err)
        del model, back, trained

        # (e) wavenet on the indel assay and on the singles
        for dms_id, n_rows, path in (("SYNTH_INDEL", len(assay), "wavenet_indel"),
                                     ("SYNTH_L250", len(singles), "wavenet_sub")):
            trained, scored = {}, {}
            reset()
            t0 = time.perf_counter()
            with capturing(torch, wavenet, "train", trained), \
                    capturing(torch, wavenet, "score_sequences", scored):
                table = score("wavenet", dms_id, extra=[f"steps={s['wavenet_steps']}"])
            wall_e = time.perf_counter() - t0
            out["launches"][path] = launched()
            check_launches(f"wavenet {dms_id}", launched(), {"cluster_counts": 1})
            values = np.asarray([float(r[-1]) for r in table[1:]])
            if table[0][-1] != "Wavenet_score" or len(values) != n_rows or not (
                    np.isfinite(values).all() and np.ptp(values) > 0):
                fail(f"wavenet {dms_id}: column {table[0][-1]}, {len(values)} rows, or "
                     "non-finite or constant scores")
            model, losses = trained["out"]
            wn_config, seqs = trained["args"][1], trained["args"][2]
            wn_rows = seqs, trained["kwargs"]["weights"], wn_config
            # the entries themselves under the profiler: wavenet.train for
            # 50 steps from a fresh init (its set-up, the rows' encoding,
            # included), and the scoring
            short = dataclasses.replace(wn_config, steps=s["wavenet_profiled_steps"])
            fresh = wavenet.init_random(short, seed=1, device=dev)
            idle, per_step = {}, {}
            for what, fn in (("training", lambda: wavenet.train(fresh, short, seqs,
                                                                weights=wn_rows[1])),
                             ("scoring", lambda: wavenet.score_sequences(
                                 model, scored["args"][1], batch=s["batch"]))):
                _, p_wall, p_busy, per_step[what], _ = device_seconds(torch, fn)
                idle[what] = None if p_busy is None else 1 - p_busy / p_wall
            print(f"  (e) wavenet on {dms_id}: {n_rows} finite scores; training "
                  f"{trained['seconds']:.2f} s ({wn_config.steps} steps, loss {losses[0]:.3f} -> "
                  f"{losses[-1]:.3f}), scoring {scored['seconds']:.3f} s -> "
                  f"{n_rows / scored['seconds']:.1f} mutants/s; CLI wall {wall_e:.2f} s; idle "
                  f"share, training {idle['training']} ({s['wavenet_profiled_steps']} steps "
                  f"profiled, {per_step['training'] / s['wavenet_profiled_steps']:.0f} launches a "
                  f"step), scoring {idle['scoring']} ({card})")
            out[path] = dict(train_s=trained["seconds"], score_s=scored["seconds"], wall_s=wall_e,
                             rows=n_rows, idle_training=idle["training"],
                             idle_scoring=idle["scoring"], loss_first=float(losses[0]),
                             loss_last=float(losses[-1]),
                             launches_per_step=per_step["training"] / s["wavenet_profiled_steps"])
            del model, fresh, trained, scored

    # (f) the first Adam steps on the card against the same steps on the
    # CPU, every draw made once on the CPU and handed to both
    gen = torch.Generator().manual_seed(16)
    cpu_rows = torch.from_numpy(np.asarray(onehot, dtype=np.float32))
    cpu_probs = torch.as_tensor(weights / weights.sum(), dtype=torch.float32)
    neff = float(weights.sum())
    on_cpu = eve.init_random(eve_config, seed=16, device="cpu")
    on_card = eve.load_state_dict(on_cpu.state_dict(), eve_config, device=dev)
    start = {k: v.clone() for k, v in on_cpu.state_dict().items()}
    draws = []
    for _ in range(TRAINER_CPU_STEPS):
        idx = torch.multinomial(cpu_probs, eve.BATCH_SIZE, replacement=True, generator=gen)
        draws.append((idx, torch.randn(eve.BATCH_SIZE, eve_config.z_dim, generator=gen),
                      on_cpu.draw_noise(1, gen)))
    losses = {}
    t0 = time.perf_counter()
    for side, model, where in (("card", on_card, dev), ("cpu", on_cpu, torch.device("cpu"))):
        model.requires_grad_(True)
        optimizer = adam(model, 1e-4)
        losses[side] = [float(eve.train_step(
            model, optimizer, cpu_rows[idx].to(where), neff, z_noise=z.to(where),
            decoder_noise=[n.to(where) for n in noise])) for idx, z, noise in draws]
    cpu_s = time.perf_counter() - t0
    loss_rel = max(abs(a / b - 1) for a, b in zip(losses["card"], losses["cpu"]))
    worst = params_against(on_card, on_cpu, start, EVE_CPU_ATOL)
    line, ok = held_to(worst, EVE_CPU_ATOL, EVE_CPU_MAX)
    print(f"  (f) EVE's first {TRAINER_CPU_STEPS} Adam steps (batch {eve.BATCH_SIZE} of "
          f"{len(cpu_rows)} rows, default architecture) on the card against the CPU ({cpu_s:.1f} s "
          f"for both): losses rel {loss_rel:.3g} (rtol {EVE_CPU_LOSS_RTOL:g}); {line}")
    if not (loss_rel <= EVE_CPU_LOSS_RTOL and ok):
        fail(f"EVE: the card's first {TRAINER_CPU_STEPS} steps disagree with the CPU's")
    out["eve_cpu"] = dict(loss_rel=loss_rel, seconds=cpu_s,
                          **{k: v for k, (v, _) in worst.items()})
    del on_card, on_cpu, cpu_rows, draws, start
    torch.cuda.empty_cache()

    seqs, weights, wn_config = wn_rows
    tokens, mask, probs = (torch.from_numpy(a) for a in wavenet.training_rows(seqs, weights))
    gen = torch.Generator().manual_seed(17)
    on_cpu = wavenet.init_random(wn_config, seed=17, device="cpu")
    on_card = wavenet.load_state_dict(on_cpu.state_dict(), wn_config, device=dev)
    start = {k: v.clone() for k, v in on_cpu.state_dict().items()}
    picks = [torch.multinomial(probs.float(), wn_config.batch, replacement=True, generator=gen)
             for _ in range(TRAINER_CPU_STEPS)]
    losses = {}
    for side, model, where in (("card", on_card, dev), ("cpu", on_cpu, torch.device("cpu"))):
        model.requires_grad_(True)
        optimizer = adam(model, wn_config.learning_rate)
        losses[side] = [float(wavenet.train_step(model, optimizer, tokens[idx].to(where),
                                                 mask[idx].to(where))) for idx in picks]
    loss_rel = max(abs(a / b - 1) for a, b in zip(losses["card"], losses["cpu"]))
    worst = params_against(on_card, on_cpu, start, WAVENET_CPU_ATOL)
    line, ok = held_to(worst, WAVENET_CPU_ATOL, WAVENET_CPU_MAX)
    print(f"  (f) WaveNet's first {TRAINER_CPU_STEPS} Adam steps (batch {wn_config.batch} of "
          f"{len(tokens)} rows x {tokens.shape[1]} tokens) on the card against the CPU: losses rel "
          f"{loss_rel:.3g} (rtol {WAVENET_CPU_LOSS_RTOL:g}); {line}")
    if not (loss_rel <= WAVENET_CPU_LOSS_RTOL and ok):
        fail(f"WaveNet: the card's first {TRAINER_CPU_STEPS} steps disagree with the CPU's")
    out["wavenet_cpu"] = dict(loss_rel=loss_rel, **{k: v for k, (v, _) in worst.items()})
    print(f"  [trainers] {time.perf_counter() - phase_t0:.1f} s in all")
    return out


def phase_baselines(torch, dev, card, fa):
    """17. The rest of the alignment baselines through the port's CLI, each
    at its defaults, on phase 14's L=250 target, 16,384-row alignment over
    residues 1-240 and 4,750 singles (with a synonymous WT row) and on
    phase 15's indel assay, with no weights file (K5 once per CLI run):
    (a) ``gemme``; (b) ``escott`` with --structure-dir (a synthetic helix
    of the target, and one of the wrong length); (c) ``siterm``; (d)
    ``siterm --extra method=f81``; (e) ``rsalor`` with and without a
    structure; (f) ``provean`` on the singles and on the indel assay. The
    card is held against the CPU at these sizes: GEMME's tables, the GTR
    rate matrices and scores, the F81 rates, PROVEAN's scores."""
    import contextlib
    import io

    from scipy.stats import spearmanr

    from proteingym_tpu_torch import native
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
    from proteingym_tpu_torch.models import gemme, provean, rsalor, siterm
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli

    t, ind, b = TRANCEPTION_SLICE, INDEL_SLICE, BASELINE_SLICE
    length, covered = t["length"], t["covered"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 13/14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    mutants = singles + [f"{seq[0]}1{seq[0]}"]  # the WT row, as a synonymous mutant
    past = [i for i, m in enumerate(mutants) if int(m[1:-1]) > covered]
    codes400 = np.random.RandomState(15).randint(1, 21, ind["length"])  # phase 15's target
    seq400 = "".join(GAP_AA[c] for c in codes400)
    assay = indel_variants(seq400, ind["variants"], 15) + [seq400]
    phase_t0 = time.perf_counter()
    print(f"[baselines] gemme, escott, siterm (GTR and F81), rsalor and provean through the CLI "
          f"at their defaults ({card}): L={length} target with {len(singles)} singles + a WT row, "
          f"MSA N={t['n_seqs']} over residues 1-{covered}; L={ind['length']} with "
          f"{len(assay) - 1} indel variants + WT, MSA N={ind['n_seqs']}; no weights file")

    def reset():
        for counts in (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES):
            for name in counts:
                counts[name] = 0

    def launched():
        return {**fa.LAUNCHES, **W.LAUNCHES, **ln.LAUNCHES}

    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for d in ("msa", "dms", "pdb"):
            (root / d).mkdir()
        write_a2m(root / "msa" / "SYNTH.a2m", "SYNTH", synth_family(codes[:covered], t["n_seqs"], 13))
        write_a2m(root / "msa" / "SYNTH_INDEL.a2m", "SYNTH_INDEL",
                  synth_family(codes400[:ind["covered"]], ind["n_seqs"], 15))
        write_csv_rows(root / "dms" / "SYNTH_L250.csv", ["mutant", "DMS_score"],
                       [[m, "0.5"] for m in mutants])
        write_csv_rows(root / "dms" / "SYNTH_INDEL.csv", ["mutant", "mutated_sequence", "DMS_score"],
                       [[v, v, "0.5"] for v in assay])
        write_pdb_backbone(root / "pdb" / "SYNTH.pdb", synthetic_helix_backbone(length), seq)
        write_pdb_backbone(root / "pdb" / "SYNTH_SHORT.pdb",
                           synthetic_helix_backbone(b["short_structure"]), seq)
        cells = ["SYNTH.a2m", 1, covered, 0.2, "SYNTH.npy"]
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                        "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"],
                       [["SYNTH_L250", "SYNTH_L250.csv", "SYNTH", seq, length, *cells],
                        ["SYNTH_L250_SHORT", "SYNTH_L250.csv", "SYNTH_SHORT", seq, length, *cells],
                        ["SYNTH_INDEL", "SYNTH_INDEL.csv", "SYNTH_INDEL", seq400, ind["length"],
                         "SYNTH_INDEL.a2m", 1, ind["covered"], 0.2, "SYNTH_INDEL.npy"]])

        def score(model, dms_id, extra=(), structure=False, tag=None):
            """One CLI run: its rows, wall, peak device memory and stdout;
            K5 once and no other kernel of the port."""
            tag = tag or model
            reset()
            torch.cuda.reset_peak_memory_stats()
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = cli.main(["score", "--model", model, "--dms-id", dms_id, "--dms-reference",
                               str(root / "reference.csv"), "--dms-dir", str(root / "dms"),
                               "--msa-dir", str(root / "msa"), "--output-dir",
                               str(root / "out" / tag), "--device", dev.type, "--quiet",
                               "--fail-fast", *(["--structure-dir", str(root / "pdb")]
                                                if structure else []),
                               *(["--extra", *extra] if extra else [])])
            wall = time.perf_counter() - t0
            if rc != 0:
                fail(f"score --model {model} exited {rc} on {dms_id}")
            out["launches"][tag] = launched()
            check_launches(f"{tag} on {dms_id}", launched(), {"cluster_counts": 1})
            return (read_table(root / "out" / tag / f"{dms_id}.csv"), wall,
                    torch.cuda.max_memory_allocated() / 2**30, text.getvalue())

        def check_column(tag, rows, column, want_empty=past):
            """The scores: the JAX CLI's column, finite where the JAX scorer
            scores (``want_empty``: the mutants past the alignment), the WT
            row (the last) 0."""
            cells = [r[-1] for r in rows[1:]]
            empty = [i for i, c in enumerate(cells) if c == ""]
            if rows[0][-1] != column or empty != want_empty or float(cells[-1]) != 0.0:
                fail(f"{tag}: column {rows[0][-1]} (expected {column}), {len(empty)} empty fields "
                     f"(expected {len(want_empty)}), WT row {cells[-1]!r}")
            scores = np.asarray([float(c) if c else np.nan for c in cells])
            live = np.isfinite(scores)
            if live.sum() != len(cells) - len(want_empty) or np.ptp(scores[live]) <= 0:
                fail(f"{tag}: {int(live.sum())} finite scores, or all equal")
            return scores

        def report(tag, scores, wall, peak, spans, extra=""):
            print(f"  {tag}: {int(np.isfinite(scores).sum())} finite scores, WT 0; CLI wall "
                  f"{wall:.2f} s (" + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
                  + f"); peak device memory {peak:.3f} GiB; K5 launches 1{extra} ({card})")
            out[tag] = dict(wall_s=wall, peak_gib=peak, finite=int(np.isfinite(scores).sum()),
                            **{f"{k}_s": v for k, v in spans.items()})

        # (a) gemme: 3 NJ trees of 512 sampled rows
        fit, nj, sc = {}, {}, {}
        with capturing(torch, gemme, "fit_gemme", fit), capturing(torch, native, "nj_tree", nj), \
                capturing(torch, gemme, "score_mutants", sc):
            rows, wall, peak, _ = score("gemme", "SYNTH_L250")
        scores = check_column("(a) gemme", rows, "GEMME_score")
        model = fit["out"]
        n_rows = fit["args"][0].shape[0]
        n_trees = 3 if n_rows > 512 else 1  # a sample of every row is drawn once
        if model.method != "tree" or nj["calls"] != n_trees:
            fail(f"gemme: method {model.method}, {nj['calls']} NJ trees over {n_rows} rows "
                 f"(expected tree, {n_trees})")
        on_cpu = gemme.fit_gemme(*fit["args"], **{**fit["kwargs"], "device": "cpu"})
        gemme_err = max(float(np.abs(model.pred_epi - on_cpu.pred_epi).max()),
                        float(np.abs(model.pred_ind - on_cpu.pred_ind).max()))
        report("(a) gemme", scores, wall, peak, {"fit": fit["seconds"], "NJ": nj["seconds"],
                                                 "scoring": sc["seconds"]},
               f"; pred_epi and pred_ind against the CPU: max |diff| {gemme_err:.3g} "
               f"(atol {GEMME_CPU_ATOL:g})")
        if not gemme_err <= GEMME_CPU_ATOL:
            fail(f"gemme: card against CPU max |diff| {gemme_err:.3g} > {GEMME_CPU_ATOL:g}")
        out["(a) gemme"]["cpu_err"] = gemme_err

        # (b) escott: with the target's structure, and with one of the wrong length
        fit = {}
        with capturing(torch, gemme, "fit_gemme", fit):
            rows, wall, peak, text = score("escott", "SYNTH_L250", structure=True)
        scores = check_column("(b) escott", rows, "ESCOTT_score")
        report("(b) escott --structure-dir", scores, wall, peak, {"fit": fit["seconds"]})
        rows_short, wall, peak, text = score("escott", "SYNTH_L250_SHORT", structure=True,
                                             tag="escott_short")
        short = check_column("(b) escott, short structure", rows_short, "ESCOTT_score")
        message = (f"escott/SYNTH_L250_SHORT: structure length {b['short_structure']} != target "
                   f"{length}; skipping RSA modulation")
        live = np.isfinite(scores) & (short != 0)
        if message not in text or np.allclose(scores[live], short[live]):
            fail(f"escott: the wrong-length structure printed {text.strip()!r}, or the RSA "
                 "weights changed nothing")
        print(f"  (b) escott with a {b['short_structure']}-residue structure: {message!r}; "
              f"CLI wall {wall:.2f} s")

        # (c) siterm, GTR: 1,024 rows, 100 epochs, 20 rate categories, 129 taus.
        # The process's first batched eigh pays a one-time load (~9.5 s of
        # the first epoch when this phase ran alone): timed on its own first,
        # so the epochs below are the fit's (a fresh CLI process pays it once)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.linalg.eigh(torch.eye(21, device=dev).expand(240, 21, 21))
        torch.cuda.synchronize()
        first_eigh = time.perf_counter() - t0
        fit, nj, adam_fit, sc = {}, {}, {}, {}
        with capturing(torch, siterm, "fit_site_rate_matrices", fit), \
                capturing(torch, native, "nj_tree", nj), \
                capturing(torch, siterm, "fit_gtr_params", adam_fit), \
                capturing(torch, siterm, "score_mutants_gtr", sc):
            rows, wall, peak, _ = score("siterm", "SYNTH_L250")
        scores = check_column("(c) siterm", rows, "SiteRM_score")
        gtr = fit["out"]
        counts, taus = adam_fit["args"][:2]
        epochs = adam_fit["args"][4]
        _, prof_wall, busy, n_kernels, _ = device_seconds(torch, lambda: siterm.fit_gtr_params(
            *adam_fit["args"]))
        idle = None if busy is None else 1.0 - busy / prof_wall
        t_cpu = time.perf_counter()
        gtr_cpu = siterm.fit_site_rate_matrices(*fit["args"], **{**fit["kwargs"], "device": "cpu"})
        t_cpu = time.perf_counter() - t_cpu
        q_rel = float(np.linalg.norm(gtr.rate_matrices - gtr_cpu.rate_matrices)
                      / np.linalg.norm(gtr_cpu.rate_matrices))
        wt_focus, remapped = sc["args"][1], sc["args"][2]
        on_cpu = siterm.score_mutants_gtr(gtr_cpu, wt_focus, remapped, device="cpu")
        s_err = float(np.abs(sc["out"] - on_cpu).max())
        rho = float(spearmanr(sc["out"], on_cpu)[0])
        report("(c) siterm (GTR)", scores, wall, peak,
               {"fit": fit["seconds"], "NJ": nj["seconds"], "Adam": adam_fit["seconds"],
                "scoring": sc["seconds"]},
               f"; the process's first eigh, before the run: {first_eigh:.3f} s; "
               f"{counts.shape[0]} sites x {counts.shape[1]} time buckets, "
               f"{epochs} epochs: {adam_fit['seconds'] / epochs * 1e3:.2f} ms an epoch; profiled: "
               f"{n_kernels / epochs:.1f} launches an epoch, "
               + ("device busy not read" if busy is None else
                  f"device busy {busy:.3f} s of {prof_wall:.3f} s, idle share {idle:.3f}")
               + f"; against the CPU ({t_cpu:.2f} s there): rate matrices rel. Frobenius "
               f"{q_rel:.3g} (bound {SITERM_Q_REL:g}), site rates "
               f"{'equal' if np.array_equal(gtr.site_rates, gtr_cpu.site_rates) else 'DIFFER'}, "
               f"scores max |diff| {s_err:.3g} (bound {SITERM_SCORE_ATOL:g}), Spearman {rho:.6f} "
               f"(bound {SITERM_SPEARMAN:g})")
        if not (q_rel <= SITERM_Q_REL and s_err <= SITERM_SCORE_ATOL and rho >= SITERM_SPEARMAN):
            fail("siterm: the card's GTR fit disagrees with the CPU's")
        out["(c) siterm (GTR)"].update(
            first_eigh_s=first_eigh, sites=counts.shape[0], buckets=counts.shape[1], epochs=epochs,
            ms_per_epoch=adam_fit["seconds"] / epochs * 1e3, launches_per_epoch=n_kernels / epochs,
            busy_s=busy, idle_share=idle, q_rel=q_rel, score_err=s_err, spearman=rho)

        # (d) siterm --extra method=f81: 2,048 rows, 200 Adam steps
        fit, nj, rates = {}, {}, {}
        with capturing(torch, siterm, "fit_siterm", fit), capturing(torch, native, "nj_tree", nj), \
                capturing(torch, siterm, "fit_site_rates", rates):
            rows, wall, peak, _ = score("siterm", "SYNTH_L250", extra=["method=f81"],
                                        tag="siterm_f81")
        scores = check_column("(d) siterm f81", rows, "SiteRM_score")
        mu_cpu = siterm.fit_site_rates(*rates["args"], **{**rates["kwargs"], "device": "cpu"})
        mu_rel = float(np.max(np.abs(rates["out"] - mu_cpu) / np.abs(mu_cpu)))
        report("(d) siterm --extra method=f81", scores, wall, peak,
               {"fit": fit["seconds"], "NJ": nj["seconds"], "Adam": rates["seconds"]},
               f"; {len(rates['args'][2])} cherries of {rates['args'][0].shape[0]} rows; rates "
               f"against the CPU: max rel. diff {mu_rel:.3g} (bound {F81_MU_RTOL:g})")
        if not mu_rel <= F81_MU_RTOL:
            fail(f"siterm f81: card against CPU rates differ by {mu_rel:.3g}")

        # (e) rsalor, with the structure and without
        fit = {}
        with capturing(torch, rsalor, "fit_rsalor", fit):
            rows, wall, peak, _ = score("rsalor", "SYNTH_L250", structure=True)
        with_rsa = check_column("(e) rsalor", rows, "RSALOR_score")
        report("(e) rsalor --structure-dir", with_rsa, wall, peak, {"fit": fit["seconds"]})
        fit = {}
        with capturing(torch, rsalor, "fit_rsalor", fit):
            rows, wall, peak, _ = score("rsalor", "SYNTH_L250", tag="rsalor_plain")
        plain = check_column("(e) rsalor, no structure", rows, "RSALOR_score")
        report("(e) rsalor, no structure", plain, wall, peak, {"fit": fit["seconds"]})
        if np.allclose(with_rsa[np.isfinite(plain)], plain[np.isfinite(plain)]):
            fail("rsalor: the structure changed no score")

        # (f) provean: 200 candidates, up to 30 clusters of 5
        for tag, path, dms_id in (("(f) provean, singles", "provean_singles", "SYNTH_L250"),
                                  ("(f) provean, indels", "provean_indels", "SYNTH_INDEL")):
            clus, ps, dp = {}, {}, {}
            with capturing(torch, provean, "cluster_supporting_set", clus), \
                    capturing(torch, provean, "provean_scores", ps), \
                    capturing(torch, provean, "_gotoh_scores", dp):
                rows, wall, peak, _ = score("provean", dms_id, tag=path)
            scores = check_column(tag, rows, "Provean_score", want_empty=[])  # whole sequences
            wt, seqs, clusters = ps["args"][:3]
            supporting, _ = provean.supporting_sequences(clusters)
            l2 = -(-max(map(len, supporting)) // 32) * 32
            n_pairs = len(seqs) * len(supporting)
            n_cells = sum(len(s) for s in seqs + [wt]) * len(supporting) * (l2 + 1)
            # the DP again under the profiler: launches per query row, idle share
            _, prof_wall, busy, n_kernels, _ = device_seconds(
                torch, lambda: provean.provean_scores(wt, seqs, clusters, device=dev))
            idle = None if busy is None else 1.0 - busy / prof_wall
            _, _, _, row_kernels, _ = device_seconds(
                torch, lambda: provean.align_scores([wt] * 8, supporting[:8], device=dev))
            per_row = row_kernels / len(wt)
            # card against CPU: the whole PROVEAN score of a spread of variants
            pick = np.unique(np.linspace(0, len(seqs) - 1, b["provean_cpu_variants"]).astype(int))
            sub = [seqs[k] for k in pick]
            cpu = provean.provean_scores(wt, sub, clusters, device="cpu")
            card_sub = provean.provean_scores(wt, sub, clusters, device=dev)
            p_err = max(float(np.abs(cpu - card_sub).max()),
                        float(np.abs(cpu - ps["out"][pick]).max()))
            report(tag, scores, wall, peak,
                   {"supporting set": clus["seconds"], "scoring": ps["seconds"],
                    "DP": dp["seconds"]},
                   f"; supporting set {len(supporting)} sequences in {len(clusters)} clusters; "
                   f"{n_pairs} (variant, subject) pairs, {n_cells:.4g} DP cells in "
                   f"{dp['calls']} calls -> {n_cells / dp['seconds']:.4g} cells/s; "
                   f"{per_row:.1f} launches per query row; profiled: "
                   + ("device busy not read" if busy is None else
                      f"device busy {busy:.3f} s of {prof_wall:.3f} s, idle share {idle:.3f}")
                   + f"; {len(pick)} variants' scores against the CPU: max |diff| {p_err:g} "
                   f"(atol {PROVEAN_CPU_ATOL:g})")
            if not p_err <= PROVEAN_CPU_ATOL:
                fail(f"provean {dms_id}: card against CPU max |diff| {p_err:g}")
            out[tag].update(supporting=len(supporting), clusters=len(clusters), pairs=n_pairs,
                            cells=n_cells, cells_per_s=n_cells / dp["seconds"],
                            launches_per_row=per_row, busy_s=busy, idle_share=idle,
                            cpu_err=p_err)
    print(f"  [baselines] {time.perf_counter() - phase_t0:.1f} s in all")
    return out


def phase_zoo(torch, dev, card, fa, check_close):
    """18. The AR zoo through the port's CLI at each preset's full width and
    depth (seeded random weights) on phase 14's L=250 target: (a)
    ``progen2 --checkpoint progen2-xlarge`` on the first 512 singles, (b)
    ``rita --checkpoint RITA_xl`` on the first 512 and on every 2nd row of
    phase 15's indel assay, (c) ``protgpt2`` at its defaults on the first 512, (d)
    ``progen3 --checkpoint progen3-3b`` on the first 256, (e) ``unirep`` on
    all singles, then with ``--extra evotune_steps=20`` on phase 14's
    alignment; for each run its column, forwards, K1 launches per forward,
    mutants/s, peak memory and the idle share of two forwards of its first
    scoring pass (torch.profiler); (f) per-row log-likelihoods of 8 rows per
    transformer family against the plain attention; (g) the float32 K1 at
    the zoo's shapes beside its plain version, SDPA and its bound."""
    from proteingym_tpu_torch.models import ar_scoring, ar_zoo, progen3, unirep
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli

    z, t, ind = ZOO_SLICE, TRANCEPTION_SLICE, INDEL_SLICE
    length, covered, batch = t["length"], t["covered"], z["batch"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    single_seqs = [seq[:int(m[1:-1]) - 1] + m[-1] + seq[int(m[1:-1]):] for m in singles]
    seq400 = "".join(GAP_AA[c] for c in np.random.RandomState(15).randint(1, 21, ind["length"]))
    indels = indel_variants(seq400, ind["variants"], 15) + [seq400]  # phase 15's assay
    indels = indels[::z["indel_stride"]]  # every kind of variant, and the WT last
    phase_t0 = time.perf_counter()
    print(f"[zoo] ProGen2, RITA, ProtGPT2, ProGen3, UniRep (seeded random, full width and "
          f"depth) on phase 14's L={length} target ({len(singles)} singles, MSA N="
          f"{t['n_seqs']} over residues 1-{covered}) and {len(indels)} rows of phase 15's indel "
          f"assay (one row in {z['indel_stride']}); batch {batch}; {card}")

    # every scoring pass (one direction of batched_ar_loglik): its forwards
    # and seconds; after a run's first pass, its first 2 x batch rows again
    # under torch.profiler, alone, for the idle share (profiling a whole
    # pass costs more in the profiler's own bookkeeping than the pass)
    passes, profiled = [], {}
    real_loglik = ar_scoring.batched_ar_loglik

    def traced(logits_fn, token_rows, pad_id, **kwargs):
        n = [0]

        def counted(tokens):
            n[0] += 1
            return logits_fn(tokens)

        def first_rows():
            n[0] = 0
            real_loglik(counted, token_rows[:2 * kwargs["batch_size"]], pad_id, **kwargs)
            return n[0]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_loglik(counted, token_rows, pad_id, **kwargs)
        torch.cuda.synchronize()
        passes.append(dict(forwards=n[0], wall=time.perf_counter() - t0))
        if len(passes) == 1:
            profiled["profile"] = profile_forwards(torch, fa, first_rows)
        return out

    kept = {}  # the model a run built, for (f)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "msa").mkdir()
        write_a2m(root / "msa" / "SYNTH.a2m", "SYNTH", synth_family(codes[:covered], t["n_seqs"], 13))
        (root / "dms").mkdir()
        assays = {"ZOO_L250": (singles, single_seqs),
                  "ZOO_L250_P2": (singles[:z["progen2_singles"]],
                                  single_seqs[:z["progen2_singles"]]),
                  "ZOO_L250_P3": (singles[:z["progen3_singles"]],
                                  single_seqs[:z["progen3_singles"]]),
                  "ZOO_INDEL": (indels, indels)}
        ref_rows = []
        for dms_id, (muts, seqs) in assays.items():
            y = np.random.RandomState(18).randn(len(muts))
            write_csv_rows(root / "dms" / f"{dms_id}.csv", ["mutant", "mutated_sequence", "DMS_score"],
                           [[m, ms, repr(float(v))] for m, ms, v in zip(muts, seqs, y)])
            target = seq400 if dms_id == "ZOO_INDEL" else seq
            ref_rows.append([dms_id, f"{dms_id}.csv", "SYNTH", target, len(target), "SYNTH.a2m",
                             1, covered, 0.2, "SYNTH.npy"])
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                        "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"],
                       ref_rows)

        def run(model, dms_id, column, checkpoint=None, extra=(), patches=()):
            passes.clear()
            profiled.clear()
            kept.clear()
            r = cli_score(torch, cli, root, len(assays[dms_id][0]), model, dms_id, column,
                          (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES), batch, checkpoint,
                          flags=["--msa-dir", str(root / "msa"), "--weights-dir",
                                 str(root / "weights")], extra=extra,
                          patches=[mock.patch.object(ar_scoring, "batched_ar_loglik", traced),
                                   *patches])
            return dict(r, forwards=sum(p["forwards"] for p in passes), passes=list(passes),
                        profile=profiled.get("profile"))

        def expected_forwards(seqs, directions=2):
            lengths = np.asarray([len(x) for x in seqs])
            _, counts = np.unique(-(-lengths // 32), return_counts=True)
            return directions * int(sum(-(-c // batch) for c in counts))

        def report(tag, what, r, layers, column, directions=2, extra_launches=None, norms=0):
            per_forward = {"grouped_attention": layers} if layers else {}
            if norms:
                per_forward["layer_norm"] = norms
            report_run(tag, what, r, card, column, expected_forwards(assays_of[tag], directions),
                       per_forward, extra_launches,
                       "; scoring passes " + ", ".join(f"{p['wall']:.2f} s" for p in r["passes"]))

        def rows_ll(model_fn, tokenize, pad, seqs, module):
            """Per-row mean log-likelihoods of ``seqs`` and their reverses,
            with the kernel and with the plain attention in ``module``."""
            texts = list(seqs) + [x[::-1] for x in seqs]
            rows = [tokenize(x) for x in texts]
            lens = np.asarray([len(x) for x in texts], dtype=np.float64)
            got = real_loglik(model_fn, rows, pad, batch_size=len(rows), device=dev) / lens
            with mock.patch.object(module, "mha", fa.plain_mha):
                want = real_loglik(model_fn, rows, pad, batch_size=len(rows), device=dev) / lens
            return torch.from_numpy(got), torch.from_numpy(want)

        assays_of = {}
        runs, ll_errs = {}, {}
        four = single_seqs[::len(single_seqs) // z["logp_rows"]][:z["logp_rows"]]
        aa25 = {c: i for i, c in enumerate("ABCDEFGHIKLMNOPQRSTUVWXYZ")}
        aa26 = {c: i for i, c in enumerate("ABCDEFGHIJKLMNOPQRSTUVWXYZ")}

        # (a) ProGen2-xlarge
        assays_of["a"] = assays["ZOO_L250_P2"][1]
        cfg = ar_zoo.PROGEN2_PRESETS["progen2-xlarge"]
        r = run("progen2", "ZOO_L250_P2", "progen2-xlarge_score", "progen2-xlarge",
                patches=[keeping(ar_zoo, "progen2_init", kept)])
        report("a", "progen2 --checkpoint progen2-xlarge", r, cfg.num_layers,
               "progen2-xlarge_score", norms=cfg.num_layers + 1)  # a norm a block, the final one
        runs["progen2_xlarge"] = r
        got, want = rows_ll(kept.pop("progen2_init").restricted_logits,
                            lambda x: np.asarray([aa25[c] for c in x], np.int64), aa25["X"],
                            four, ar_zoo)
        ll_errs["progen2"] = check_close("(f) ProGen2-xlarge: 8 rows' mean log-likelihoods, "
                                         "kernel vs plain", got, want, ZOO_LL_ATOL, 0.0)
        torch.cuda.empty_cache()

        # (b) RITA_xl on the singles and on the indel assay
        assays_of["b"] = assays["ZOO_L250_P2"][1]
        cfg = ar_zoo.RITA_PRESETS["RITA_xl"]
        r = run("rita", "ZOO_L250_P2", "RITA_xl_score", "RITA_xl",
                patches=[keeping(ar_zoo, "rita_init", kept)])
        report("b", "rita --checkpoint RITA_xl, singles", r, cfg.num_layers, "RITA_xl_score")
        runs["rita_xl"] = r
        tok = ar_zoo.RitaTokenizer()
        got, want = rows_ll(kept.pop("rita_init"), tok.encode, tok.PAD, four, ar_zoo)
        ll_errs["rita"] = check_close("(f) RITA_xl: 8 rows' mean log-likelihoods, kernel vs "
                                      "plain", got, want, ZOO_LL_ATOL, 0.0)
        torch.cuda.empty_cache()
        assays_of["b'"] = indels
        r = run("rita", "ZOO_INDEL", "RITA_xl_score", "RITA_xl")
        report("b'", "rita --checkpoint RITA_xl, indel rows", r, cfg.num_layers, "RITA_xl_score")
        runs["rita_xl_indel"] = r

        # (c) ProtGPT2 at its defaults (byte-level tokens)
        assays_of["c"] = assays["ZOO_L250_P2"][1]
        cfg = ar_zoo.Gpt2Config()
        r = run("protgpt2", "ZOO_L250_P2", "ProtGPT2_score",
                patches=[keeping(ar_zoo, "gpt2_init", kept)])
        report("c", "protgpt2 (36 x 1280, 20 heads, 50,257 tokens)", r, cfg.num_layers,
               "ProtGPT2_score")
        print(f"      logits of one forward: {batch} x 256 x {cfg.vocab_size} float32 = "
              f"{batch * 256 * cfg.vocab_size * 4 / 1e9:.2f} GB")
        runs["protgpt2"] = r
        got, want = rows_ll(kept.pop("gpt2_init"),
                            lambda x: np.asarray([ord(c) % cfg.vocab_size for c in x], np.int64),
                            0, four, ar_zoo)
        ll_errs["protgpt2"] = check_close("(f) ProtGPT2: 8 rows' mean log-likelihoods, kernel "
                                          "vs plain", got, want, ZOO_LL_ATOL, 0.0)
        torch.cuda.empty_cache()

        # (d) ProGen3-3b: the routed float32 experts
        assays_of["d"] = assays["ZOO_L250_P3"][1]
        cfg = progen3.PRESETS["progen3-3b"]
        r = run("progen3", "ZOO_L250_P3", "progen3-3b_score", "progen3-3b",
                patches=[keeping(progen3, "init_random", kept)])
        report("d", "progen3 --checkpoint progen3-3b", r, cfg.num_layers, "progen3-3b_score")
        runs["progen3_3b"] = r
        got, want = rows_ll(kept.pop("init_random").restricted_logits,
                            lambda x: np.asarray([aa26[c] for c in x], np.int64), aa26["X"],
                            four, progen3)
        ll_errs["progen3"] = check_close("(f) ProGen3-3b: 8 rows' mean log-likelihoods, kernel "
                                         "vs plain", got, want, ZOO_LL_ATOL, 0.0)
        torch.cuda.empty_cache()

        # (e) UniRep, then evotuned on the alignment (K5 once: no weights file)
        assays_of["e"] = [unirep.UniRepTokenizer().encode(x) for x in single_seqs]
        r = run("unirep", "ZOO_L250", "unirep_score")
        report("e", "unirep (hidden 1,900)", r, 0, "unirep_score", directions=1)
        runs["unirep"] = r
        spans = {}
        assays_of["e'"] = assays_of["e"]
        r = run("unirep", "ZOO_L250", "unirep_score", extra=[f"evotune_steps={z['evotune_steps']}"],
                patches=[mock.patch.object(unirep, "evotune",
                                           spans_of(torch, spans, "evotune", unirep.evotune))])
        report("e'", f"unirep --extra evotune_steps={z['evotune_steps']}", r, 0, "unirep_score",
               directions=1, extra_launches={"cluster_counts": 1})
        print(f"      evotune: {z['evotune_steps']} Adam steps of {batch} rows in "
              f"{spans['evotune']:.2f} s ({spans['evotune'] / z['evotune_steps'] * 1e3:.1f} ms a "
              f"step); scores moved by up to {np.abs(r['scores'] - runs['unirep']['scores']).max():.3g}")
        if not np.abs(r["scores"] - runs["unirep"]["scores"]).max() > 0:
            fail("unirep: evotuning left the scores unchanged")
        runs["unirep_evotune"] = r

    # (g) the float32 K1 alone at the zoo's shapes, as the models hand it in:
    # (B, T, H, D) memory seen as (B, H, T, D), causal, no mask
    records = [f32_k1_record(torch, dev, fa, card, spec, "g") for spec in K1_ZOO]
    print(f"  [zoo] {time.perf_counter() - phase_t0:.1f} s in all; (f) max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in ll_errs.items())
          + f" (atol {ZOO_LL_ATOL:g})")
    return {"launches": {name: r["launches"] for name, r in runs.items()}, "k1": records,
            "k1_err": max(rec["max_abs_err"] for rec in records)}


def f32_k1_record(torch, dev, fa, card, spec, tag):
    """The float32 K1 alone at ``spec`` (label, B, H, T, D) as the AR models
    hand it in: (B, T, H, D) memory seen as (B, H, T, D), causal, no mask.
    Held against its plain version and timed beside it, SDPA ``is_causal``
    and the bound (three TF32 passes per product on the tensor cores)."""
    label, b, h, tt, d = spec
    gen = torch.Generator(device=dev).manual_seed(tt + d)
    q, k, v = (torch.randn(b, tt, h, d, generator=gen, device=dev).transpose(1, 2)
               for _ in range(3))
    got = fa.grouped_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = fa.plain_mha(q, k, v, causal=True)
    err = check_close(f"({tag}) float32 K1 B{b} H{h} T{tt} D{d} causal ({label})", got, want,
                      F32_ATOL, F32_RTOL)
    del want
    times = median_pair(torch, {
        "kernel": lambda: fa.grouped_mha(q, k, v, causal=True),
        "plain": lambda: fa.plain_mha(q, k, v, causal=True),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                                         is_causal=True),
    }, reps=3, inner=5, rounds=1)
    # the least time on the tensor cores: three TF32 passes per product
    flops = 4.0 * b * h * d * tt * (tt + 1) / 2
    bnd = bound(flops, nbytes(q, k, v, got), peak=PEAK_TF32_FLOPS / 3)
    simt = bound(flops, nbytes(q, k, v, got), peak=PEAK_F32_FLOPS)
    print(f"  ({tag}) float32 K1 B{b} H{h} T{tt} D{d} causal: kernel {times['kernel']:.4f} ms, "
          f"plain {times['plain']:.4f} ms, SDPA is_causal {times['sdpa']:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, 3xTF32 at 495/3 TFLOP/s; "
          f"{simt['bound_ms']:.4f} ms float32 at 67 TFLOP/s outside the tensor cores; "
          f"{card})")
    del q, k, v, got
    torch.cuda.empty_cache()
    return dict(label=label, shape=f"B{b} H{h} T{tt} D{d} float32, causal",
                ms=times["kernel"], plain_ms=times["plain"], library_ms=times["sdpa"],
                max_abs_err=err, **bnd)


def k2_esm3_long(torch, dev, card, fa, check_close, b, h, t, d):
    """K2 in float32 at ESM3's long rows (no mask, not causal), as the
    model hands it q/k/v: (B, T, H, D) memory seen as (B, H, T, D), the
    softmax scale left to the kernel. Held against its plain version and
    timed beside SDPA on the same inputs and its 3xTF32 bound."""
    gen = torch.Generator(device=dev).manual_seed(t + d)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
               for _ in range(3))
    what = f"B{b} H{h} T{t} D{d} float32, no mask"
    got = fa.flash_mha(q, k, v)
    torch.cuda.synchronize()
    err = check_close(f"(c) K2 {what} (esm3_long)", got, fa.plain_mha(q, k, v),
                      F32_ATOL, F32_RTOL)
    sdpa_fn = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    times = median_pair(torch, {"kernel": lambda: fa.flash_mha(q, k, v),
                                "plain": lambda: fa.plain_mha(q, k, v),
                                "sdpa": sdpa_fn}, reps=3, inner=5, rounds=1)
    bnd = bound(4.0 * b * h * d * t * t, nbytes(q, k, v, got), peak=PEAK_TF32_FLOPS / 3)
    print(f"  (c) K2 {what}: kernel {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
          f"SDPA {times['sdpa']:.4f} ms ({sdpa_backend(torch, sdpa_fn)}), bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, 3xTF32 at 495/3 TFLOP/s; {card})")
    return dict(label="esm3_long", shape=what, ms=times["kernel"], plain_ms=times["plain"],
                library_ms=times["sdpa"], max_abs_err=err, **bnd)


def xtrimo_ar_held(torch, dev, fa, check_close, model, config, rows):
    """xTrimoPGLM's AR rows held against the plain attention: per-token
    target log-probs of ``rows`` (B, T) with the kernel and with the plain
    attention, both within XTRIMO_AR_TOKEN_ATOL, and both held against a
    float32 copy of ``model`` (plain attention) by their RMS error, the
    kernel's within XTRIMO_AR_F32_FACTOR of the plain version's. Two
    planted faults must fail the check: the plain attention with each
    row's next key visible, and the kernel with every key-tile extent one
    tile short. Returns the per-token max |kernel - plain|."""
    from proteingym_tpu_torch.models import esmc, xtrimo

    class ShortTiles(fa.KeyTiles):
        def extents(self, b, t, device):
            lo, hi = super().extents(b, t, device)
            return lo, torch.maximum(lo, hi - 1)

    def leaked_mha(q, k, v, key_mask=None, causal=False, **_):
        t = q.shape[2]
        visible = torch.ones(t, t, dtype=torch.bool, device=q.device).tril(1)
        visible = visible & key_mask[:, None, None, :]
        scores = q.float() @ k.float().transpose(-1, -2) / q.shape[-1] ** 0.5
        probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), -1)
        return (probs.to(q.dtype).float() @ v.float()).to(q.dtype)

    def token_logp(net, patches=()):
        with torch.no_grad(), contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            logp = torch.log_softmax(xtrimo.apply(net, rows[:, :-1], "ar"), -1)
        return logp.gather(-1, rows[:, 1:, None])[..., 0]

    plain = mock.patch.object(esmc, "mha", fa.plain_mha)
    got, want = token_logp(model), token_logp(model, [plain])
    faults = {"each row's next key visible (plain attention)":
              token_logp(model, [mock.patch.object(esmc, "mha", leaked_mha)]),
              "every key-tile extent one tile short (kernel)":
              token_logp(model, [mock.patch.object(esmc, "KeyTiles", ShortTiles)])}
    f32 = esmc.load_state_dict({k: v.float() for k, v in model.state_dict().items()},
                               dataclasses.replace(config, dtype=torch.float32), device=dev)
    truth = token_logp(f32, [plain])
    del f32
    torch.cuda.empty_cache()
    rms = lambda x: float(x.pow(2).mean().sqrt())  # noqa: E731
    err = check_close(f"(f) xTrimoPGLM-3B AR: {rows.shape[0]} rows' per-token target "
                      "log-probs, kernel vs plain", got, want, XTRIMO_AR_TOKEN_ATOL, 0.0)
    ref = rms(want - truth)
    ratio = rms(got - truth) / ref
    print(f"      against the float32 model: RMS kernel {rms(got - truth):.4g}, plain "
          f"{ref:.4g} (ratio {ratio:.3g}, limit {XTRIMO_AR_F32_FACTOR:g}); max "
          f"{float((got - truth).abs().max()):.4g}, {float((want - truth).abs().max()):.4g}")
    if not ratio <= XTRIMO_AR_F32_FACTOR:
        fail(f"xTrimoPGLM-3B AR: the kernel's error against float32 is {ratio:.3g}x the "
             "plain attention's")
    for name, bad in faults.items():
        diff, bad_ratio = float((bad - want).abs().max()), rms(bad - truth) / ref
        print(f"      planted fault, {name}: max |diff| {diff:.4g} (limit "
              f"{XTRIMO_AR_TOKEN_ATOL:g}; of the row means "
              f"{float((bad - want).mean(-1).abs().max()):.3g}), RMS against float32 "
              f"{bad_ratio:.3g}x the plain version's (limit {XTRIMO_AR_F32_FACTOR:g})")
        if diff <= XTRIMO_AR_TOKEN_ATOL and bad_ratio <= XTRIMO_AR_F32_FACTOR:  # NaN fails
            fail(f"xTrimoPGLM-3B AR: a planted fault passes the check ({name})")
    return err


def phase_mlm(torch, dev, card, fa, check_close):
    """19. ESM-C, ESM3 with its structure track, xTrimoPGLM and CARP through
    the port's CLI, each at its preset's full width and depth with seeded
    random weights, on phase 14's L=250 target (4,750 singles and a
    synonymous WT row): (a) ``esmc --checkpoint esmc_600m``, masked then WT
    marginals; (b) ``esm3 --checkpoint esm3_open_small --structure-dir``
    (a helix of the target with CA noise) ``--extra
    structure_checkpoint=esm3_structure_encoder`` (the full encoder), then
    without --structure-dir; (c) ``esm3`` sequence-only on phase 5's
    L=1,100 target, 16 singles at --batch-size 4 (T=1,102: K2's float32
    mode), 4 of its rows against the plain attention and K2 alone at that
    shape beside its plain version, SDPA and its bound; (d) ``xtrimopglm
    --checkpoint xtrimopglm_1b`` (MLM) and ``xtrimopglm_3b --extra
    mode=ar`` on all singles; (e) ``carp --checkpoint carp_640M``, both
    strategies. Each run: its column and finite count, the CLI wall,
    forwards and launches a forward, mutants/s, peak memory, and the idle
    share of two forwards (torch.profiler). (f) 8 rows per transformer
    against the plain attention (xTrimoPGLM-3B AR per token, against a
    float32 copy too, with two planted faults), ESM3's structure codes on
    the card against the CPU (tokens equal above TOKEN_MARGIN, flips
    counted) and one CARP forward against the CPU; (g) K1 at the four new
    shapes beside its plain version, SDPA and its bound."""
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
    from proteingym_tpu_torch.models import carp, esm3, esmc, xtrimo
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli

    m = MLM_SLICE
    batch, length = m["batch"], TRANCEPTION_SLICE["length"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    muts = singles + [f"{seq[0]}1{seq[0]}"]
    seq_long, long_all = synth_assay(m["long_length"], 1)  # phase 5's target
    long_muts = long_all[::len(long_all) // m["long_singles"]][:m["long_singles"]]
    phase_t0 = time.perf_counter()
    print(f"[mlm] ESM-C, ESM3 (+ structure track), xTrimoPGLM, CARP (seeded random, full width "
          f"and depth) on phase 14's L={length} target ({len(muts)} rows) and phase 5's "
          f"L={m['long_length']} target ({len(long_muts)} singles); batch {batch}; {card}")

    forwards = [0]
    kept = {}

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "dms").mkdir()
        (root / "pdb").mkdir()
        assays = {"MLM_L250": (seq, muts), "MLM_L1100": (seq_long, long_muts)}
        for dms_id, (target, rows) in assays.items():
            y = np.random.RandomState(19).randn(len(rows))
            write_csv_rows(root / "dms" / f"{dms_id}.csv", ["mutant", "DMS_score"],
                           [[x, repr(float(v))] for x, v in zip(rows, y)])
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len"],
                       [[dms_id, f"{dms_id}.csv", "SYNTH", target, len(target)]
                        for dms_id, (target, _) in assays.items()])
        helix = synthetic_helix_backbone(length, seed=19)
        helix[:, 1] += m["ca_noise"] * np.random.RandomState(19).randn(length, 3)
        write_pdb_backbone(root / "pdb" / "MLM_L250.pdb", helix, seq)

        def run(model, dms_id, column, counted, scoring, checkpoint=None, extra=(),
                structure=False, batch_size=batch, patches=()):
            """One CLI run with its forwards counted (``counted``: the model
            class and method) and the seconds of ``scoring`` (a module and
            the name of its scoring function) timed."""
            spans = {}
            forwards[0] = 0
            timed = mock.patch.object(scoring[0], scoring[1],
                                      spans_of(torch, spans, "scoring", getattr(*scoring)))
            r = cli_score(torch, cli, root, len(assays[dms_id][1]), model, dms_id, column,
                          (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES), batch_size, checkpoint,
                          flags=["--structure-dir", str(root / "pdb")] if structure else [],
                          extra=extra, patches=[counting(forwards, *counted), timed, *patches])
            return dict(r, forwards=forwards[0], scoring=spans["scoring"])

        def report(tag, what, r, want_forwards, per_forward, column, forward=None):
            """``report_run`` with two calls of ``forward`` profiled first."""
            if forward is not None:
                def two():
                    with torch.no_grad():
                        forward()
                        forward()
                    return 2
                r["profile"] = profile_forwards(torch, fa, two)
            synonymous = r["scores"][-1] if r["n"] == len(muts) else None
            if synonymous is not None and synonymous != 0.0:
                fail(f"{what}: the synonymous WT row scores {synonymous}, not 0")
            report_run(tag, what, r, card, column, want_forwards, per_forward,
                       detail=f"; scoring {r['scoring']:.2f} s "
                              f"({r['scoring'] / r['forwards'] * 1e3:.1f} ms a forward)")

        runs, errs = {}, {}
        rng = np.random.RandomState(19)
        rows_at = np.sort(rng.choice(length, m["logp_rows"], replace=False)) + 1  # token grid

        def masked_rows(tokens, positions, mask_idx):
            rows = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
            rows = rows.expand(len(positions), -1).clone()
            at = torch.as_tensor(positions, device=dev)
            rows[torch.arange(len(positions), device=dev), at] = mask_idx
            return rows, at

        def held(name, fn, atol):
            """``fn()`` with the kernel and with the plain attention in
            ``esmc``, where every model of this phase calls ``mha``."""
            with torch.no_grad():
                got = fn()
                with mock.patch.object(esmc, "mha", fa.plain_mha):
                    want = fn()
            errs[name] = check_close(f"(f) {name}: {len(got)} rows, kernel vs plain",
                                     got, want, atol, 0.0)

        # (a) ESM-C-600M, masked then WT marginals
        cfg = esmc.PRESETS["esmc_600m"]
        per = {"grouped_attention": cfg.num_layers, "rope_qk": cfg.num_layers}
        r = run("esmc", "MLM_L250", "esmc_600m_score", (esmc.EsmcModel, "forward"),
                (esmc, "score_assay"), "esmc_600m", patches=[keeping(esmc, "init_random", kept)])
        model = kept.pop("init_random")
        toks = esmc.ALPHABET.tokenize(seq, pad_to=256)
        rows, at = masked_rows(toks, rows_at, esmc.ALPHABET.mask_idx)
        full = masked_rows(toks, np.arange(batch) + 1, esmc.ALPHABET.mask_idx)[0]
        report("a", "esmc --checkpoint esmc_600m, masked", r, n_chunk_forwards(length, batch),
               per, "esmc_600m_score", lambda: model(full))
        runs["esmc"] = r
        held("ESM-C-600M masked log-probs", lambda: torch.log_softmax(
            model(rows)[torch.arange(len(at), device=dev), at], -1), MLM_BF16_ATOL)
        r = run("esmc", "MLM_L250", "esmc_600m_score", (esmc.EsmcModel, "forward"),
                (esmc, "score_assay"), "esmc_600m", extra=["scoring_strategy=wt-marginals"])
        report("a'", "esmc --checkpoint esmc_600m, WT marginals", r, 1, per, "esmc_600m_score")
        runs["esmc_wt"] = r
        del model, rows, full
        torch.cuda.empty_cache()

        # (b) ESM3-open-small with the full structure encoder, then sequence-only
        c3 = esm3.PRESETS["esm3_open_small"]
        spans = {}
        r = run("esm3", "MLM_L250", "ESM3_score", (esm3.Esm3Model, "forward"),
                (esm3, "masked_logprob_table"), "esm3_open_small",
                extra=["structure_checkpoint=esm3_structure_encoder"], structure=True,
                patches=[keeping(esm3, "init_random", kept),
                         keeping(esm3, "structure_encoder_init", kept),
                         mock.patch.object(esm3, "structure_tokens_from_coords", spans_of(
                             torch, spans, "tokens", esm3.structure_tokens_from_coords))])
        model, encoder = kept.pop("init_random"), kept.pop("structure_encoder_init")
        tokens3, struct3, pc3 = esm3.prepare_tracks(encoder, seq, helix[:, :3])
        kw = dict(structure_tokens=torch.as_tensor(struct3, dtype=torch.long, device=dev)[None],
                  coords=torch.as_tensor(pc3, device=dev)[None],
                  per_res_plddt=torch.as_tensor(np.isfinite(pc3).all(-1).any(-1).astype(
                      np.float32), device=dev)[None])
        ex = lambda n: {k: v.expand(n, *v.shape[1:]) for k, v in kw.items()}  # noqa: E731
        full = masked_rows(tokens3, np.arange(batch) + 1, esm3.SEQ_MASK)[0]
        report("b", "esm3 --checkpoint esm3_open_small --structure-dir, full encoder", r,
               -(-length // batch), {"grouped_attention": c3.n_layers}, "ESM3_score",
               lambda: model(full, **ex(batch)))
        print(f"      structure tokens {spans['tokens']:.2f} s (L={length}, kNN {encoder.config.knn}, "
              f"{encoder.config.n_codes} codes), scoring pass {r['scoring']:.2f} s; peak at "
              f"--batch-size {batch} {r['peak_gib']:.2f} GiB")
        runs["esm3"] = r
        rows, at = masked_rows(tokens3, rows_at, esm3.SEQ_MASK)
        held("ESM3 structure-conditioned masked log-probs", lambda: torch.log_softmax(
            model(rows, **ex(len(at)))[0][torch.arange(len(at), device=dev), at], -1),
            ESM3_LOGP_ATOL)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            model(full, **ex(batch))
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"      one forward of {batch} x {len(tokens3)} with coordinates: peak {fwd_peak:.2f} "
              f"GiB (weights {sum(p.numel() for p in model.parameters()) * 4 / 2**30:.2f} GiB)")
        # the codes on the card against the CPU
        d2_card = esm3.structure_code_distances(encoder, helix[:, :3])
        cpu_encoder = esm3.load_structure_encoder_state_dict(
            {k: v.cpu() for k, v in encoder.state_dict().items()}, encoder.config, device="cpu")
        d2_cpu = esm3.structure_code_distances(cpu_encoder, helix[:, :3])
        two = d2_cpu.topk(2, dim=-1, largest=False).values
        margin = two[:, 1] - two[:, 0]
        tok_card, tok_cpu = d2_card.argmin(-1).cpu(), d2_cpu.argmin(-1)
        clear = margin > TOKEN_MARGIN
        flips = int((tok_card != tok_cpu).sum())
        rel = float(((d2_card.cpu() - d2_cpu).abs() / d2_cpu.abs().clamp(min=1.0)).max())
        print(f"  (f) ESM3 structure codes, card vs CPU: {flips} of {length} tokens differ, "
              f"{int((~clear).sum())} within the margin {TOKEN_MARGIN:g} (smallest margin "
              f"{float(margin.min()):.3g}); {len(torch.unique(tok_cpu))} distinct codes; d2 max "
              f"relative diff {rel:.3g} (rtol {TOKEN_D2_RTOL:g})")
        if bool((tok_card != tok_cpu)[clear].any()):
            fail("ESM3 structure tokens differ between the card and the CPU above the margin")
        if rel > TOKEN_D2_RTOL:
            fail(f"ESM3 structure code distances differ between the card and the CPU: {rel:.3g}")
        errs["esm3_tokens_d2_rel"] = rel
        del cpu_encoder, encoder, rows, full, model
        torch.cuda.empty_cache()
        r = run("esm3", "MLM_L250", "ESM3_score", (esm3.Esm3Model, "forward"),
                (esm3, "masked_logprob_table"), "esm3_open_small")
        report("b'", "esm3 --checkpoint esm3_open_small, sequence-only", r, -(-length // batch),
               {"grouped_attention": c3.n_layers}, "ESM3_score")
        if not np.abs(r["scores"] - runs["esm3"]["scores"]).max() > 1e-3:
            fail("esm3: the structure track left the scores unchanged")
        runs["esm3_seq"] = r

        # (c) ESM3 on the L=1,100 target: T=1,102, K2's float32 mode
        n_pos = len({int(x[1:-1]) for x in long_muts})
        r = run("esm3", "MLM_L1100", "ESM3_score", (esm3.Esm3Model, "forward"),
                (esm3, "masked_logprob_table"), "esm3_open_small", batch_size=m["long_batch"],
                patches=[keeping(esm3, "init_random", kept)])
        report("c", f"esm3 sequence-only, L={m['long_length']} (T={m['long_length'] + 2}), "
               f"--batch-size {m['long_batch']}", r, -(-n_pos // m["long_batch"]),
               {"flash_attention": c3.n_layers}, "ESM3_score")
        runs["esm3_long"] = r
        model = kept.pop("init_random")
        tokens_long = esm3.tokenize_sequence(seq_long)
        long_at = sorted({int(x[1:-1]) for x in long_muts})[:m["long_batch"]]  # token grid
        held(f"ESM3 L={m['long_length']} sequence-only masked log-probs (K2)",
             lambda: torch.from_numpy(esm3.masked_logprob_table(
                 model, tokens_long, None, None, long_at, batch=m["long_batch"])),
             ESM3_LOGP_ATOL)
        del model
        torch.cuda.empty_cache()
        k2 = k2_esm3_long(torch, dev, card, fa, check_close, m["long_batch"], c3.n_heads,
                          len(tokens_long), c3.d_model // c3.n_heads)

        # (d) xTrimoPGLM-1B MLM, then xTrimoPGLM-3B AR
        cx = xtrimo.PRESETS["xtrimopglm_1b"]
        r = run("xtrimopglm", "MLM_L250", "xtrimopglm_score", (esmc.EsmcModel, "forward"),
                (xtrimo, "score_assay"), "xtrimopglm_1b", patches=[keeping(esmc, "init_random", kept)])
        model = kept.pop("init_random")
        toks = esmc.ALPHABET.tokenize(seq)
        rows, at = masked_rows(toks, rows_at, esmc.ALPHABET.mask_idx)
        full = masked_rows(toks, np.arange(batch) + 1, esmc.ALPHABET.mask_idx)[0]
        report("d", "xtrimopglm --checkpoint xtrimopglm_1b (MLM)", r, -(-length // batch),
               {"grouped_attention": cx.num_layers, "rope_qk": cx.num_layers}, "xtrimopglm_score",
               lambda: model(full))
        runs["xtrimopglm"] = r
        held("xTrimoPGLM-1B masked log-probs", lambda: torch.log_softmax(
            model(rows)[torch.arange(len(at), device=dev), at], -1), MLM_BF16_ATOL)
        del model, rows, full
        torch.cuda.empty_cache()
        cx = xtrimo.PRESETS["xtrimopglm_3b"]
        r = run("xtrimopglm", "MLM_L250", "xtrimopglm_score", (esmc.EsmcModel, "trunk"),
                (xtrimo, "score_assay"), "xtrimopglm_3b", extra=["mode=ar"],
                patches=[keeping(esmc, "init_random", kept)])
        model = kept.pop("init_random")
        ar_rows = torch.as_tensor(np.stack([esmc.ALPHABET.tokenize(
            seq[:p] + AA[(AA.index(seq[p]) + 1) % 20] + seq[p + 1:])
            for p in rows_at - 1]), dtype=torch.long, device=dev)
        full = ar_rows[:1, :-1].expand(batch, -1)
        # one row per unique chunk: the WT's (the synonymous row's too) and each single's
        report("d'", "xtrimopglm --checkpoint xtrimopglm_3b --extra mode=ar", r,
               -(-(len(singles) + 1) // batch),
               {"grouped_attention": cx.num_layers, "rope_qk": cx.num_layers}, "xtrimopglm_score",
               lambda: xtrimo.apply(model, full, "ar"))
        runs["xtrimopglm_ar"] = r
        errs["xTrimoPGLM-3B AR"] = xtrimo_ar_held(torch, dev, fa, check_close, model, cx,
                                                  ar_rows)
        del model, ar_rows, full
        torch.cuda.empty_cache()

        # (e) CARP-640M, masked then WT marginals: no kernel of the port
        cc = carp.CARP_PRESETS["carp_640M"]
        r = run("carp", "MLM_L250", "carp_640M_score", (carp.Carp, "forward"),
                (carp, "score_assay"), "carp_640M", patches=[keeping(carp, "init_random", kept)])
        model = kept.pop("init_random")
        ctoks = carp.CarpTokenizer().encode(seq)
        full = torch.as_tensor(ctoks, dtype=torch.long, device=dev).expand(batch, -1)
        report("e", "carp --checkpoint carp_640M, masked", r, -(-length // batch), {},
               "carp_640M_score", lambda: model(full))
        runs["carp"] = r
        r = run("carp", "MLM_L250", "carp_640M_score", (carp.Carp, "forward"),
                (carp, "score_assay"), "carp_640M", extra=["scoring_strategy=wt-marginals"])
        report("e'", "carp --checkpoint carp_640M, WT marginals", r, 1, {}, "carp_640M_score")
        runs["carp_wt"] = r
        # one forward on the card against the CPU, both in float32
        state = {k: v.float().cpu() for k, v in model.state_dict().items()}
        f32 = dataclasses.replace(cc, dtype=torch.float32)
        del model, full
        torch.cuda.empty_cache()
        one = torch.as_tensor(ctoks, dtype=torch.long)[None]
        with torch.no_grad():
            got = carp.convert_torch_state_dict(state, f32, device=dev)(one.to(dev))
            t0 = time.perf_counter()
            want = carp.convert_torch_state_dict(state, f32, device="cpu")(one)
            cpu_s = time.perf_counter() - t0
        errs["carp_cpu"] = check_close(f"(f) CARP-640M one forward (float32), card vs CPU "
                                       f"({cpu_s:.1f} s on the CPU)", got.cpu(), want,
                                       CARP_CPU_ATOL, 0.0)
        del got, want, state
        torch.cuda.empty_cache()

    # (g) K1 at the new shapes, as the models hand it q/k/v: (B, T, H, D)
    # memory seen as (B, H, T, D), the softmax scale left to the kernel
    records = []
    for label, b, h, tt, d, dt, mode in K1_MLM:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(tt + d + h)
        q, k, v = (torch.randn(b, tt, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
                   for _ in range(3))
        live = 252 if label.startswith("esmc") else tt
        key_mask = (torch.arange(tt, device=dev) < live)[None].expand(b, tt) if mode != "none" \
            else None
        causal = mode == "causal"
        kw = dict(key_mask=key_mask, causal=causal)
        # a causal forward makes the key-tile extents once for its layers
        tiles = dict(key_tiles=fa.KeyTiles(None, key_mask, True)) if causal else {}
        got = fa.grouped_mha(q, k, v, **kw, **tiles)
        torch.cuda.synchronize()
        want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
        tol = (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (F32_ATOL, F32_RTOL)
        what = f"B{b} H{h} T{tt} D{d} {dt}, " + {"mask": f"pad mask ({live} live)",
                                                  "causal": "causal + key mask",
                                                  "none": "no mask"}[mode]
        err = check_close(f"(g) K1 {what} ({label})", got, want, *tol)
        del want
        dense = None
        if key_mask is not None:
            dense = key_mask[:, None, None, :]
            if causal:
                dense = dense & torch.ones(tt, tt, dtype=torch.bool, device=dev).tril()
        fns = {"kernel": lambda: fa.grouped_mha(q, k, v, **kw, **tiles),
               "plain": lambda: fa.plain_mha(q, k, v, **kw),
               "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, attn_mask=dense)}
        if causal:
            fns["sdpa_causal"] = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True)
            fns["per_call"] = lambda: fa.grouped_mha(q, k, v, **kw)
        times = median_pair(torch, fns, reps=3, inner=5, rounds=1)
        # with every key live, SDPA is_causal computes the causal call's function
        all_live = key_mask is None or bool(key_mask.all())
        library = times["sdpa_causal"] if causal and all_live else times["sdpa"]
        pairs = tt * (tt + 1) / 2 if causal else tt * live
        flops = 4.0 * b * h * d * pairs
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
        bnd = bound(flops, nbytes(q, k, v, got), peak=peak)
        print(f"  (g) K1 {what}: kernel {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
              f"SDPA{' with the dense mask' if causal else ''} {times['sdpa']:.4f} ms "
              f"({sdpa_backend(torch, fns['sdpa'])}"
              + (f"; is_causal {times['sdpa_causal']:.4f} ms" if causal else "")
              + f"; library_ms {library:.4f}"
              + f"), bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {card})"
              + (f"; {times['per_call']:.4f} ms with the extents made per call" if causal
                 else ""))
        records.append(dict(label=label, shape=what, ms=times["kernel"], plain_ms=times["plain"],
                            library_ms=library, max_abs_err=err, **bnd,
                            **({"sdpa_mask_ms": times["sdpa"],
                                "per_call_ms": times["per_call"]} if causal else {})))
        del q, k, v, got
        torch.cuda.empty_cache()
    print(f"  [mlm] {time.perf_counter() - phase_t0:.1f} s in all; (f) "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return {"launches": {name: r["launches"] for name, r in runs.items()}, "k1": records,
            "k1_err": max(rec["max_abs_err"] for rec in records), "k2": k2}


def if1_logp_held(torch, fa, gt, model, enc, enc_pad, rows):
    """ESM-IF1's per-token target log-probs of ``rows`` (B, T) with the
    kernel and with the plain attention, held per token within
    IF1_LOGP_ATOL; two planted faults, the decoder's causal mask off and
    each row's next key visible, must fail that check. Returns the max
    |kernel - plain|."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    def leaked(q, k, v, key_mask=None, causal=False, sm_scale=None):
        if not causal:
            return fa.plain_mha(q, k, v, key_mask=key_mask, sm_scale=sm_scale)
        t = q.shape[2]
        visible = torch.ones(t, t, dtype=torch.bool, device=q.device).tril(1)
        if key_mask is not None:
            visible = visible & key_mask[:, None, None, :]
        probs = torch.softmax((q @ k.transpose(-1, -2) * sm_scale).masked_fill(
            ~visible, float("-inf")), -1)
        return probs @ v

    def token_logp(attention=None):
        with torch.no_grad(), (mock.patch.object(gt, "mha", attention) if attention
                               else contextlib.nullcontext()):
            logp = torch.log_softmax(model.decoder(rows[:, :-1], enc, enc_pad), -1)
        return logp.gather(-1, rows[:, 1:, None])[..., 0]

    counts = saved_launches(fa.LAUNCHES, ln.LAUNCHES)
    got = token_logp()
    restore_launches(counts)  # the check's launches are not the path's
    want = token_logp(fa.plain_mha)
    err = check_close(f"(e) ESM-IF1: {rows.shape[0]} rows' per-token target log-probs, "
                      "kernel vs plain", got, want, IF1_LOGP_ATOL, 0.0)
    faults = {"causal mask off": lambda q, k, v, key_mask=None, causal=False, sm_scale=None:
              fa.plain_mha(q, k, v, key_mask=key_mask, sm_scale=sm_scale),
              "each row's next key visible": leaked}
    for name, attention in faults.items():
        diff = float((token_logp(attention) - want).abs().max())
        print(f"      planted fault, {name}: max |diff| {diff:.4g} a token (limit "
              f"{IF1_LOGP_ATOL:g})")
        if not diff > IF1_LOGP_ATOL:  # NaN fails
            fail(f"ESM-IF1: a planted fault passes the per-token check ({name})")
    return err


def phase_structure(torch, dev, card, fa, check_close):
    """20. The backbone-conditioned scorers through the port's CLI at full
    width with seeded random weights, on phase 14's L=250 target and its
    helix with seeded CA noise (``--structure-dir``): (a) ``esm_if1
    --checkpoint esm_if1`` on all 4,750 singles (one encoder pass, 149
    decoder forwards of 32 x 250: 8 float32 K1 launches each, 8 for the
    encoder); (b) ``esm_if1 --extra complex_chains=A,B`` on a two-helix
    complex, the first 1,024 singles; (c) ``protein_mpnn`` with 10 orders
    on the first 2,048 singles (no kernel of the port); (d) ``saprot
    --checkpoint saprot_650M`` on all singles (33 K4 and 33 rope_qk a
    forward). Each run: the CLI wall and mutants/s, forwards and launches,
    peak memory, and two forwards under the profiler (idle share, device
    ms, the four costliest kernels). (e) 8 ESM-IF1 rows per token against
    the plain attention, with two planted faults; K1 at the encoder's
    shapes; the card against the CPU at full size: ESM-IF1's per-token
    log-probs, ProteinMPNN's per-position log-probs of 4 (sequence,
    order) pairs, SaProt-650M's masked log-probs of 2 rows in float32.
    (f) the float32 K1 at the decoder shape beside its plain version, SDPA
    and its 3xTF32 bound; (g) K4 at SaProt-650M's rows likewise."""
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
    from proteingym_tpu_torch.models import esm2, gvp_transformer as gt, protein_mpnn as mpnn
    from proteingym_tpu_torch.models import saprot
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli

    s = STRUCTURE_SLICE
    batch, length = s["batch"], TRANCEPTION_SLICE["length"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    helix = synthetic_helix_backbone(length, seed=20)
    helix[:, 1] += s["ca_noise"] * np.random.RandomState(20).randn(length, 3)
    partner = synthetic_helix_backbone(s["partner_length"], seed=21) + np.array([12.0, 0, 0])
    partner_seq = "".join(np.random.RandomState(21).choice(list(AA), s["partner_length"]))
    phase_t0 = time.perf_counter()
    print(f"[structure] ESM-IF1, ProteinMPNN, SaProt (seeded random, full width) on phase 14's "
          f"L={length} target and its helix (CA noise {s['ca_noise']} A); batch {batch}; {card}")

    forwards = [0]
    kept, runs, errs = {}, {}, {}
    assays = {"STR_L250": singles, "STR_CPLX": singles[:s["complex_singles"]],
              "STR_MPNN": singles[:s["mpnn_singles"]]}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "dms").mkdir()
        (root / "pdb").mkdir()
        for dms_id, rows in assays.items():
            y = np.random.RandomState(22).randn(len(rows))
            write_csv_rows(root / "dms" / f"{dms_id}.csv", ["mutant", "DMS_score"],
                           [[x, repr(float(v))] for x, v in zip(rows, y)])
            write_pdb_backbone(root / "pdb" / f"{dms_id}.pdb", helix, seq)
        text = (root / "pdb" / "STR_CPLX.pdb").read_text().replace("END\n", "")
        write_pdb_backbone(root / "pdb" / "STR_CPLX.pdb", partner, partner_seq, chain="B")
        (root / "pdb" / "STR_CPLX.pdb").write_text(text + (root / "pdb" / "STR_CPLX.pdb")
                                                   .read_text())
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len"],
                       [[dms_id, f"{dms_id}.csv", "SYNTH_STRUCTURE", seq, length]
                        for dms_id in assays])

        def run(model, dms_id, column, counted, checkpoint=None, extra=(), patches=()):
            forwards[0] = 0
            r = cli_score(torch, cli, root, len(assays[dms_id]), model, dms_id, column,
                          (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES), batch, checkpoint,
                          flags=["--structure-dir", str(root / "pdb")], extra=extra,
                          patches=[counting(forwards, *counted), *patches])
            return dict(r, forwards=forwards[0])

        # (a) ESM-IF1 on all singles
        c = gt.PRESETS["esm_if1"]
        spans = {}
        r = run("esm_if1", "STR_L250", "esm_if1_score", (gt.TransformerDecoder, "forward"),
                "esm_if1", patches=[keeping(gt, "init_random", kept), mock.patch.object(
                    gt, "encode_structure", spans_of(torch, spans, "encoder",
                                                     gt.encode_structure))])
        model = kept.pop("init_random")
        enc, enc_pad = gt.encode_structure(model, helix)
        toks = torch.as_tensor(np.stack([gt.tokenize(seq)] * batch), device=dev)
        r["profile"] = profile_two(torch, fa, lambda: model.decoder(toks[:, :-1], enc, enc_pad))
        report_run("a", "esm_if1 --checkpoint esm_if1", r, card, "esm_if1_score",
                   -(-len(singles) // batch), {"grouped_attention": c.decoder_layers},
                   extra_launches={"grouped_attention": c.encoder_layers},
                   detail=f"; encoder pass {spans['encoder']:.3f} s (L={length}, k="
                          f"{c.gvp_top_k_neighbors})")
        runs["esm_if1"] = r
        rng = np.random.RandomState(20)
        rows_at = np.sort(rng.choice(length, s["logp_rows"], replace=False))
        rows = torch.as_tensor(np.stack([gt.tokenize(
            seq[:p] + AA[(AA.index(seq[p]) + 1) % 20] + seq[p + 1:]) for p in rows_at]),
            device=dev)
        errs["ESM-IF1 per token"] = if1_logp_held(torch, fa, gt, model, enc, enc_pad, rows)
        # the card against the CPU at full size: encoder and decoder, per token
        cpu = gt.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, c,
                                 device="cpu")
        few = rows[:s["cpu_rows"]]
        with torch.no_grad():
            got = torch.log_softmax(model.decoder(few[:, :-1], enc, enc_pad), -1)
            t0 = time.perf_counter()
            enc_cpu, pad_cpu = gt.encode_structure(cpu, helix)
            want = torch.log_softmax(cpu.decoder(few[:, :-1].cpu(), enc_cpu, pad_cpu), -1)
            cpu_s = time.perf_counter() - t0
        errs["ESM-IF1 card vs CPU"] = check_close(
            f"(e) ESM-IF1 {len(few)} rows' log-probs, card vs CPU ({cpu_s:.1f} s on the CPU; "
            f"encoder out max |diff| {float((enc.cpu() - enc_cpu).abs().max()):.3g})",
            got.cpu(), want, IF1_CPU_ATOL, 0.0)
        del cpu, model, enc, toks, got, want
        torch.cuda.empty_cache()

        # (b) ESM-IF1 on the two-helix complex
        n_enc = length + 10 + s["partner_length"] + 2
        r = run("esm_if1", "STR_CPLX", "esm_if1_score", (gt.TransformerDecoder, "forward"),
                "esm_if1", extra=["complex_chains=A,B", "target_chain=A"],
                patches=[keeping(gt, "init_random", kept)])
        model = kept.pop("init_random")
        enc, enc_pad = gt.encode_structure(model, gt.concatenate_complex_coords(
            {"A": helix, "B": partner}, "A"))
        toks = torch.as_tensor(np.stack([gt.tokenize(seq)] * batch), device=dev)
        r["profile"] = profile_two(torch, fa, lambda: model.decoder(toks[:, :-1], enc, enc_pad))
        del model, enc, toks
        report_run("b", f"esm_if1 complex_chains=A,B (encoder T={n_enc}, 10 spacers)", r, card,
                   "esm_if1_score", -(-len(assays["STR_CPLX"]) // batch),
                   {"grouped_attention": c.decoder_layers},
                   extra_launches={"grouped_attention": c.encoder_layers})
        moved = float(np.abs(r["scores"] - runs["esm_if1"]["scores"][:len(r["scores"])]).max())
        print(f"      the partner chain moves the scores by up to {moved:.4g}")
        if not moved > 1e-4:
            fail("esm_if1: the complex's second chain left the scores unchanged")
        runs["esm_if1_complex"] = r

        # (c) ProteinMPNN, 10 orders
        mc = mpnn.PRESETS["v_48_020"]
        n_pairs = len(assays["STR_MPNN"]) * s["mpnn_orders"]
        spans = {}
        r = run("protein_mpnn", "STR_MPNN", "pmpnn_ll", (mpnn, "decode"), "v_48_020",
                extra=[f"num_seq_per_target={s['mpnn_orders']}"],
                patches=[keeping(mpnn, "init_random", kept), mock.patch.object(
                    mpnn, "encode", spans_of(torch, spans, "encoder", mpnn.encode))])
        model = kept.pop("init_random")
        per_chunk = mpnn.pairs_per_chunk(model, length, mc.k_neighbors)
        enc_m = mpnn.encode(model, torch.as_tensor(helix, dtype=torch.float32, device=dev))
        orders = torch.as_tensor(mpnn.decoding_orders(length, s["mpnn_orders"]), device=dev)
        tok = torch.as_tensor(mpnn.tokenize_sequence(seq), device=dev)
        pairs_tok = tok.expand(per_chunk, -1)
        pairs_ord = orders[torch.arange(per_chunk, device=dev) % s["mpnn_orders"]]
        r["profile"] = profile_two(torch, fa,
                                   lambda: mpnn.decode(model, enc_m, pairs_tok, pairs_ord))
        report_run("c", f"protein_mpnn --checkpoint v_48_020, {s['mpnn_orders']} orders", r,
                   card, "pmpnn_ll", -(-n_pairs // per_chunk), {},
                   detail=f"; {n_pairs} pairs in chunks of {per_chunk} -> "
                          f"{n_pairs / r['wall']:.0f} pairs/s; encoder {spans['encoder']:.3f} s")
        runs["protein_mpnn"] = r
        cpu = mpnn.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, mc,
                                   device="cpu")
        few_tok = tok.expand(s["cpu_rows"], -1)
        few_ord = orders[torch.arange(s["cpu_rows"], device=dev) % s["mpnn_orders"]]
        got = mpnn.decode(model, enc_m, few_tok, few_ord)
        t0 = time.perf_counter()
        enc_cpu = mpnn.encode(cpu, torch.as_tensor(helix, dtype=torch.float32))
        want = mpnn.decode(cpu, enc_cpu, few_tok.cpu(), few_ord.cpu())
        cpu_s = time.perf_counter() - t0
        if not torch.equal(enc_cpu[2], enc_m[2].cpu()):
            fail("protein_mpnn: the kNN graph differs between the card and the CPU")
        errs["ProteinMPNN card vs CPU"] = check_close(
            f"(e) ProteinMPNN {len(few_ord)} pairs' log-probs, card vs CPU ({cpu_s:.1f} s on the "
            "CPU; neighbours equal)", got.cpu(), want, MPNN_CPU_ATOL, 0.0)
        del cpu, model, enc_m, got, want
        torch.cuda.empty_cache()

        # (d) SaProt-650M on all singles
        sc = saprot.PRESETS["saprot_650M"]
        r = run("saprot", "STR_L250", "SaProt_score", (esm2.EsmModel, "forward"), "saprot_650M",
                patches=[keeping(esm2, "init_random", kept)])
        model = kept.pop("init_random")
        struc = saprot.structure_letters(helix)
        stoks = saprot.VOCAB.tokenize(seq, struc)
        full = torch.as_tensor(stoks, device=dev).expand(batch, -1).clone()
        full[torch.arange(batch), torch.arange(batch) + 1] = saprot.VOCAB.pair_base["#"]
        r["profile"] = profile_two(torch, fa, lambda: model(full))
        report_run("d", "saprot --checkpoint saprot_650M", r, card, "SaProt_score",
                   -(-len(singles) // batch),
                   {"grouped_attention_bthd": sc.num_layers, "rope_qk": sc.num_layers},
                   detail=f"; 3Di letters: {len(set(struc))} distinct")
        runs["saprot"] = r
        # float32 copies on the card and the CPU, 2 masked rows
        state = {k: v.float().cpu() for k, v in model.state_dict().items()}
        f32 = dataclasses.replace(sc, dtype=torch.float32)
        del model, full
        torch.cuda.empty_cache()
        two_rows = torch.as_tensor(stoks).expand(s["saprot_cpu_rows"], -1).clone()
        two_rows[0, 5] = two_rows[1, 100] = saprot.VOCAB.pair_base["#"]
        with torch.no_grad():
            counts = saved_launches(fa.LAUNCHES, ln.LAUNCHES)
            got = torch.log_softmax(esm2.load_fair_esm_state_dict(state, f32, device=dev)(
                two_rows.to(dev)), -1)
            restore_launches(counts)
            t0 = time.perf_counter()
            want = torch.log_softmax(esm2.load_fair_esm_state_dict(state, f32, device="cpu")(
                two_rows), -1)
            cpu_s = time.perf_counter() - t0
        errs["SaProt card vs CPU"] = check_close(
            f"(e) SaProt-650M float32, {len(two_rows)} rows' log-probs, card vs CPU "
            f"({cpu_s:.1f} s on the CPU)", got.cpu(), want, SAPROT_CPU_ATOL, 0.0)
        del got, want, state
        torch.cuda.empty_cache()

    # (e) K1 at the encoder's two shapes: one chain (every key live) and the
    # complex (the 10 spacers masked)
    for t_enc, spacer in ((length + 2, None), (n_enc, (length + 1, length + 11))):
        gen = torch.Generator(device=dev).manual_seed(t_enc)
        q, k, v = (torch.randn(1, t_enc, 8, 64, generator=gen, device=dev).transpose(1, 2)
                   for _ in range(3))
        mask = torch.ones(1, t_enc, dtype=torch.bool, device=dev)
        if spacer:
            mask[:, spacer[0]:spacer[1]] = False
        errs[f"K1 encoder T{t_enc}"] = check_close(
            f"(e) K1 B1 H8 T{t_enc} D64 float32, {'spacer ' if spacer else ''}mask",
            fa.grouped_mha(q, k, v, key_mask=mask, sm_scale=1.0),
            fa.plain_mha(q, k, v, key_mask=mask, sm_scale=1.0), F32_ATOL, F32_RTOL)

    # (f) the float32 K1 at the decoder rows' shape, as the model hands it
    # q/k/v: (B, T, H, D) memory seen as (B, H, T, D), q pre-scaled; every
    # key is live on the singles' path, so SDPA is_causal computes the call
    label, b, h, tt, d = K1_IF1
    gen = torch.Generator(device=dev).manual_seed(tt)
    q, k, v = (torch.randn(b, tt, h, d, generator=gen, device=dev).transpose(1, 2)
               for _ in range(3))
    q = q * d ** -0.5
    key_mask = torch.ones(b, tt, dtype=torch.bool, device=dev)
    kw = dict(key_mask=key_mask, causal=True, sm_scale=1.0)
    got = fa.grouped_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    what = f"B{b} H{h} T{tt} D{d} float32, causal + PAD mask (every key live)"
    err = check_close(f"(f) K1 {what} ({label})", got, fa.plain_mha(q, k, v, **kw),
                      F32_ATOL, F32_RTOL)
    dense = key_mask[:, None, None, :] & torch.ones(tt, tt, dtype=torch.bool, device=dev).tril()
    fns = {"kernel": lambda: fa.grouped_mha(q, k, v, **kw),
           "plain": lambda: fa.plain_mha(q, k, v, **kw),
           "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, attn_mask=dense, scale=1.0),
           "sdpa_causal": lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, is_causal=True, scale=1.0)}
    times = median_pair(torch, fns, reps=3, inner=5, rounds=1)
    bnd = bound(4.0 * b * h * d * tt * (tt + 1) / 2, nbytes(q, k, v, got),
                peak=PEAK_TF32_FLOPS / 3)
    print(f"  (f) K1 {what}: kernel {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
          f"SDPA with the dense mask {times['sdpa']:.4f} ms ({sdpa_backend(torch, fns['sdpa'])}), "
          f"is_causal {times['sdpa_causal']:.4f} ms ({sdpa_backend(torch, fns['sdpa_causal'])}), "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, 3xTF32 at 495/3 TFLOP/s; {card})")
    record = dict(label=label, shape=what, ms=times["kernel"], plain_ms=times["plain"],
                  library_ms=times["sdpa_causal"], sdpa_mask_ms=times["sdpa"], max_abs_err=err,
                  **bnd)
    del q, k, v, got, dense
    torch.cuda.empty_cache()

    # (g) K4 at SaProt-650M's rows, as ESM2's layers call it: (B, T, H, D)
    # bf16 q/k/v, q pre-scaled, RoPE in the pre-pass, every key live
    label4, b, h, tt, d = K4_SAPROT
    gen = torch.Generator(device=dev).manual_seed(tt + 1)
    q, k, v = (torch.randn(b, tt, h, d, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    q = (q.float() * d ** -0.5).to(torch.bfloat16)
    mask = torch.ones(b, tt, dtype=torch.bool, device=dev)
    call = dict(key_mask=mask, sm_scale=1.0, rope_base=10000.0)
    got = fa.grouped_mha_bthd(q, k, v, **call)
    torch.cuda.synchronize()
    what4 = f"B{b} H{h} T{tt} D{d} bf16, mask + RoPE (every key live)"
    err4 = check_close(f"(g) K4 {what4} ({label4})", got,
                       fa.plain_mha_bthd(q.float(), k.float(), v.float(), **call),
                       BF16_ATOL, BF16_RTOL)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    qr, kr = fa.rope_qk(tr(q), tr(k), 1.0, 10000.0)  # the loop's and SDPA's operands
    times = median_pair(torch, {
        "plain": lambda: fa.plain_mha_bthd(q, k, v, **call),
        "kernel": lambda: fa.grouped_mha_bthd(tr(qr), tr(kr), v, key_mask=mask, sm_scale=1.0),
        "sdpa": sdpa(torch, qr, kr, tr(v), mask[:, None, None, :]),
        "call": lambda: fa.grouped_mha_bthd(q, k, v, **call),
    }, reps=3, inner=5, rounds=1)
    bnd4 = bound(4.0 * d * h * tt * float(mask.sum()), nbytes(q, k, v, got, mask))
    print(f"  (g) K4 {what4}: the call (pre-pass + loop) {times['call']:.4f} ms, the loop alone "
          f"{times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, SDPA on the rotated q/k "
          f"{times['sdpa']:.4f} ms "
          f"({sdpa_backend(torch, sdpa(torch, qr, kr, tr(v), mask[:, None, None, :]))}), bound "
          f"{bnd4['bound_ms']:.4f} ms ({bnd4['bound_by']}; {card})")
    record4 = dict(label=label4, shape=what4, ms=times["call"], loop_ms=times["kernel"],
                   plain_ms=times["plain"], library_ms=times["sdpa"], max_abs_err=err4, **bnd4)
    del q, k, v, qr, kr, got
    torch.cuda.empty_cache()
    print(f"  [structure] {time.perf_counter() - phase_t0:.1f} s in all; (e) "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return {"launches": {name: r["launches"] for name, r in runs.items()}, "k1": record,
            "k4": record4}


def phase_structure_plms(torch, dev, card, fa, check_close):
    """21. The structure-conditioned PLMs through the port's CLI at full
    width with seeded random weights, on phase 14's L=250 target, its 4,750
    singles and phase 20's helix (``--structure-dir``): (a) ``prosst
    --checkpoint prosst_2048`` with the 3Di k-means states (one forward, no
    kernel of the port); (b) the same with ``quantizer_dir=`` (a seeded
    ``AE.pt`` at the published size and 2,048 seeded centroids): nodes,
    edges and seconds of the quantizer; (c) ``venusrem --checkpoint
    prosst_2048`` with a 16,384-row alignment of the whole target (K5 once)
    and a structure alignment; (d) ``mulan --checkpoint mulan_small`` on
    all singles (149 forwards of 32 x 252: 12 float32 K4 and 1 float32 K1
    each); (e) ``mif`` and ``mif_st``; (f) each legacy method on the first
    320 singles (ESM2-8M, bf16, K4). Each run: the CLI wall and mutants/s,
    forwards and launches, peak memory, and two forwards under the
    profiler. (g) MULAN-small's per-token log-probs of 8 rows, kernels
    against the plain attention, with the adapter's last key tile skipped
    shown to fail that check; the card against the CPU at full size:
    ProSST-2048's log-probs, VenusREM's scores, MULAN-small's scores of a
    batch, MIF's and MIF-ST's logits in float32, the quantizer's pooled
    embeddings and tokens on the first 32 anchors (tokens flip only where
    the two nearest centroids are within QUANT_MARGIN, counted). (h) the
    float32 K4 at MULAN-small's trunk rows and the float32 K1 at its
    adapter's, each beside plain, SDPA and its 3xTF32 bound."""
    from proteingym_tpu_torch.data.structures import (
        parse_pdb_backbone, synthetic_helix_backbone, write_pdb_backbone,
    )
    from proteingym_tpu_torch.models import esm2, mulan, prosst, prosst_quantizer as pq
    from proteingym_tpu_torch.models import structure_plms as sp
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.msa.parser import load_msa
    from proteingym_tpu_torch.pipeline import cli

    s = PLM_SLICE
    batch, length = s["batch"], TRANCEPTION_SLICE["length"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    helix = synthetic_helix_backbone(length, seed=20)  # phase 20's helix
    helix[:, 1] += STRUCTURE_SLICE["ca_noise"] * np.random.RandomState(20).randn(length, 3)
    phase_t0 = time.perf_counter()
    print(f"[structure PLMs] ProSST-2048 (+ its quantizer), VenusREM, MULAN-small, MIF, MIF-ST "
          f"(seeded random, full width) on phase 14's L={length} target and phase 20's helix; "
          f"batch {batch}; {card}")

    forwards = [0]
    def on_cpu(model, build):
        """A CPU copy of a card model: ``build("cpu")`` given its state."""
        cpu = build("cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        return cpu

    kept, runs, errs, spans, graphs = {}, {}, {}, {}, {}
    legacy = singles[:s["legacy_singles"]]
    assays = {"PLM_L250": singles, "PLM_LEGACY": legacy}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for d in ("dms", "pdb", "msa", "weights", "ss_aln", "quantizer"):
            (root / d).mkdir()
        for dms_id, rows in assays.items():
            y = np.random.RandomState(22).randn(len(rows))
            write_csv_rows(root / "dms" / f"{dms_id}.csv", ["mutant", "DMS_score"],
                           [[x, repr(float(v))] for x, v in zip(rows, y)])
            write_pdb_backbone(root / "pdb" / f"{dms_id}.pdb", helix, seq)
        # phase 14's generator over the whole target: its focus rows are as
        # long as the target, so VenusREM's residue blend runs
        write_a2m(root / "msa" / "PLM.a2m", "PLM", synth_family(codes, s["n_seqs"], seed=21))
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                        "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"],
                       [[dms_id, f"{dms_id}.csv", "SYNTH_PLM", seq, length, "PLM.a2m", 1, length,
                         0.2, "PLM.npy"] for dms_id in assays])
        rs = np.random.RandomState(23)
        ss_rows = ["".join(rs.choice(list(AA + "-"), length)) for _ in range(s["struct_aln_rows"])]
        (root / "ss_aln" / "PLM_L250.fasta").write_text(
            "".join(f">s{i}\n{r}\n" for i, r in enumerate(ss_rows)))
        # a seeded encoder, and 2,048 centroids from its embeddings of 8
        # seeded helices of 256 residues with CA noise of 0.1-2 A (random
        # centroids would all lie far from the embeddings, one token for all)
        qcfg = pq.AutoGraphEncoderConfig()
        qref = pq.init_random(qcfg, seed=21, device=dev)
        torch.save({k: v.cpu() for k, v in qref.state_dict().items()},
                   root / "quantizer" / "AE.pt")
        cents = []
        for i, noise in enumerate((0.1, 0.3, 0.5, 0.8, 1.0, 1.3, 1.6, 2.0)):
            bb = synthetic_helix_backbone(256, seed=30 + i)
            bb[:, 1] += noise * np.random.RandomState(30 + i).randn(256, 3)
            cents.append(pq.anchor_embeddings(qref, pq.graph_features(bb)).cpu().numpy())
        cents = np.concatenate(cents)
        np.save(root / "quantizer" / "2048.npy", cents)
        del qref
        coords = parse_pdb_backbone(root / "pdb" / "PLM_L250.pdb")[0]  # as the CLI reads it

        def run(model, dms_id, column, counted, checkpoint=None, extra=(), patches=(), msa=False):
            forwards[0] = 0
            flags = ["--structure-dir", str(root / "pdb")]
            if msa:
                flags += ["--msa-dir", str(root / "msa"), "--weights-dir", str(root / "weights")]
            r = cli_score(torch, cli, root, len(assays[dms_id]), model, dms_id, column,
                          (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES), batch, checkpoint,
                          flags=flags, extra=extra,
                          patches=[counting(forwards, *counted), *patches])
            return dict(r, forwards=forwards[0])

        # (a) ProSST-2048 with the 3Di k-means states: one forward
        c = prosst.PROSST_PRESETS["prosst_2048"]
        r = run("prosst", "PLM_L250", "prosst_2048_score", (prosst.ProSST, "forward"),
                "prosst_2048", patches=[keeping(prosst, "init_random", kept), mock.patch.object(
                    prosst, "structure_token_ids", spans_of(torch, spans, "states",
                                                            prosst.structure_token_ids))])
        model = kept.pop("init_random")
        states = prosst.structure_token_ids(coords, c.ss_vocab_size - 3)
        toks = torch.as_tensor(prosst.tokenize_prosst(seq)[None], device=dev)
        ss = torch.as_tensor(prosst.tokenize_structure_sequence(states)[None], device=dev)
        r["profile"] = profile_two(torch, fa, lambda: model(toks, ss))
        report_run("a", "prosst --checkpoint prosst_2048 (3Di k-means states)", r, card,
                   "prosst_2048_score", 1, {},
                   detail=f"; {len(set(states))} states in {spans['states']:.2f} s (host)")
        runs["prosst"] = r
        cpu = on_cpu(model, lambda d: prosst.init_random(c, device=d))
        with torch.no_grad():
            got = torch.log_softmax(model(toks, ss), -1)
            t0 = time.perf_counter()
            want = torch.log_softmax(cpu(toks.cpu(), ss.cpu()), -1)
            cpu_s = time.perf_counter() - t0
        errs["ProSST card vs CPU"] = check_close(
            f"(g) ProSST-2048 log-probs of its forward, card vs CPU ({cpu_s:.2f} s on the CPU)",
            got.cpu(), want, PLM_CPU_ATOL, 0.0)

        # (b) ProSST-2048 with its own quantizer
        sizes = {}

        def sized(fn):
            def wrapper(graph, anchors):
                u = fn(graph, anchors)
                sizes.update(nodes=len(u["node_s"]), edges=len(u["src"]))
                return u
            return wrapper

        r = run("prosst", "PLM_L250", "prosst_2048_score", (prosst.ProSST, "forward"),
                "prosst_2048", extra=[f"quantizer_dir={root / 'quantizer'}"],
                patches=[keeping(pq, "load_state_dict", kept),
                         mock.patch.object(pq, "union_graph", sized(pq.union_graph)),
                         mock.patch.object(pq, "structure_tokens_from_coords", spans_of(
                             torch, spans, "quantizer", pq.structure_tokens_from_coords))])
        qmodel = kept.pop("load_state_dict")
        graph = pq.graph_features(coords)
        r["profile"] = profile_two(torch, fa, lambda: pq.anchor_embeddings(qmodel, graph))
        tokens = pq.structure_tokens_from_coords(coords, qmodel, cents)
        report_run("b", "prosst --checkpoint prosst_2048, quantizer_dir= (seeded AE.pt, 2,048 "
                   "centroids)", r, card, "prosst_2048_score", 1, {},
                   detail=f"; quantizer {sizes['nodes']} nodes, {sizes['edges']} edges in "
                          f"{length} subgraphs, {spans['quantizer']:.3f} s, {len(set(tokens))} "
                          "distinct tokens; the profiled forwards are the encoder's")
        moved = float(np.abs(r["scores"] - runs["prosst"]["scores"]).max())
        print(f"      the quantizer's tokens move the scores by up to {moved:.4g}")
        runs["prosst_quantizer"] = r
        qcpu = on_cpu(qmodel, lambda d: pq.init_random(qcfg, device=d))
        anchors = range(s["quantizer_cpu_anchors"])
        with torch.no_grad():
            emb = pq.anchor_embeddings(qmodel, graph, anchors)
            emb_cpu = pq.anchor_embeddings(qcpu, graph, anchors)
        errs["quantizer card vs CPU"] = check_close(
            f"(g) quantizer pooled embeddings, {len(anchors)} anchors, card vs CPU", emb.cpu(),
            emb_cpu, QUANT_EMB_ATOL, 0.0)
        d2 = pq.centroid_distances(emb_cpu, cents)
        best2 = d2.topk(2, largest=False).values
        near = (best2[:, 1] - best2[:, 0]) < QUANT_MARGIN
        flips = pq.centroid_distances(emb, cents).argmin(-1).cpu() != d2.argmin(-1)
        print(f"      tokens of the first {len(anchors)} anchors: {int(flips.sum())} differ, "
              f"{int(near.sum())} have their two nearest centroids within {QUANT_MARGIN:g}")
        if bool((flips & ~near).any()):
            fail("quantizer: a token differs between the card and the CPU away from a near tie")
        del qmodel, qcpu

        # (c) VenusREM over ProSST-2048: the alignment's focus rows and a
        # structure alignment; K5 once (no weights file yet)
        r = run("venusrem", "PLM_L250", "VenusREM_score", (prosst.ProSST, "forward"),
                "prosst_2048", extra=[f"struc_seq_aln_dir={root / 'ss_aln'}"], msa=True,
                patches=[keeping(prosst, "init_random", kept)])
        vmodel = kept.pop("init_random")
        r["profile"] = profile_two(torch, fa, lambda: vmodel(toks, ss))
        report_run("c", f"venusrem --checkpoint prosst_2048 ({s['n_seqs']}-row alignment, "
                   f"{s['struct_aln_rows']}-row structure alignment)", r, card, "VenusREM_score",
                   1, {}, extra_launches={"cluster_counts": 1})
        runs["venusrem"] = r
        vcpu = on_cpu(vmodel, lambda d: prosst.init_random(c, device=d))
        focus = load_msa(root / "msa" / "PLM.a2m").sequences()
        want = prosst.venusrem_score_assay_real(
            vcpu, seq, states, singles, aa_alignment=([f">msa/1-{length}"], focus),
            struct_alignment=([">s0"], ss_rows))
        errs["VenusREM card vs CPU"] = check_close(
            "(g) VenusREM scores of all singles, card vs CPU", torch.as_tensor(r["scores"]),
            torch.as_tensor(want), PLM_CPU_ATOL, 0.0)
        del model, cpu, vmodel, vcpu
        torch.cuda.empty_cache()

        # (d) MULAN-small on all singles
        mc = mulan.PRESETS["mulan_small"]
        r = run("mulan", "PLM_L250", "MULAN_score", (mulan.Mulan, "forward"), "mulan_small",
                patches=[keeping(mulan, "init_random", kept)])
        model = kept.pop("init_random")
        angles = mulan.backbone_angle_features(coords[:, :3])
        rows = np.tile(esm2.ALPHABET.tokenize(seq)[None], (batch, 1)).astype(np.int64)
        feats = np.tile(mulan.build_struct_features(angles)[None], (batch, 1, 1))
        rows[np.arange(batch), np.arange(batch) + 1] = esm2.ALPHABET.mask_idx
        feats[np.arange(batch), np.arange(batch) + 1] = mulan.MASKED_ANGLE
        rows_d, feats_d = torch.as_tensor(rows, device=dev), torch.as_tensor(feats, device=dev)
        r["profile"] = profile_two(torch, fa, lambda: model(rows_d, feats_d))
        report_run("d", "mulan --checkpoint mulan_small", r, card, "MULAN_score",
                   -(-len(singles) // batch),
                   {"grouped_attention_bthd": mc.esm.num_layers, "grouped_attention": 1})
        runs["mulan"] = r
        errs["MULAN per token"] = mulan_logp_held(torch, fa, esm2, mulan, model, rows_d, feats_d,
                                                  s["logp_rows"])
        cpu = on_cpu(model, lambda d: mulan.init_random(mc, device=d))
        n_batches = -(-len(singles) // batch)
        picked = [i for b in s["mulan_cpu_batches"] for i in
                  range(b % n_batches * batch, min((b % n_batches + 1) * batch, len(singles)))]
        t0 = time.perf_counter()
        want = mulan.score_mutants(cpu, seq, angles, [singles[i] for i in picked],
                                   batch_size=batch)
        cpu_s = time.perf_counter() - t0
        errs["MULAN card vs CPU"] = check_close(
            f"(g) MULAN-small scores of {len(picked)} singles (batches "
            f"{[b % n_batches for b in s['mulan_cpu_batches']]} of {n_batches}), card vs CPU "
            f"({cpu_s:.1f} s on the CPU)", torch.as_tensor(r["scores"][picked]),
            torch.as_tensor(want), PLM_CPU_ATOL, 0.0)
        del model, cpu, rows_d, feats_d
        torch.cuda.empty_cache()

        # (e) MIF and MIF-ST: one forward each; the CLI's bf16 scores against
        # the same module on the CPU, and the logits in float32 copies
        for variant, column in (("mif", "MIF_score"), ("mif_st", "MIF_ST_score")):
            r = run(variant, "PLM_L250", column, (sp.Mif, "forward"), variant,
                    patches=[keeping(sp, "mif_init", kept)])
            model = kept.pop("mif_init")
            cfg = sp.MIF_PRESETS[variant]
            mfeats = torch.as_tensor(sp.mif_structure_features(coords), device=dev)
            mtoks = torch.as_tensor(sp.carp.CarpTokenizer().encode(seq)[None], dtype=torch.long,
                                    device=dev)
            r["profile"] = profile_two(torch, fa, lambda: model(mtoks, mfeats))
            report_run("e", f"{variant} --checkpoint {variant} ({cfg.num_layers} x "
                       f"{cfg.embed_dim}, bf16)", r, card, column, 1, {})
            runs[variant] = r
            state = {k: v.float() for k, v in model.state_dict().items()}
            f32 = dataclasses.replace(cfg, dtype=torch.float32)
            f32_cpu = sp.mif_load_state_dict({k: v.cpu() for k, v in state.items()}, f32,
                                             device="cpu")
            with torch.no_grad():
                got = sp.mif_load_state_dict(state, f32, device=dev)(mtoks, mfeats)
                want = f32_cpu(mtoks.cpu(), mfeats.cpu())
            errs[f"{variant} card vs CPU"] = check_close(
                f"(g) {variant} logits in float32, card vs CPU", got.cpu(), want,
                PLM_CPU_ATOL, 0.0)
            exact = sp.mif_score_assay(f32_cpu, coords, seq, singles)
            bf16_cpu = sp.mif_score_assay(on_cpu(model, lambda d: sp.mif_init(cfg, device=d)),
                                          coords, seq, singles)
            noise = float(np.abs(bf16_cpu - exact).max())
            print(f"      {variant} bf16 scores against the float32 copy's: the CPU's "
                  f"{noise:.4g} at most, the card's {np.abs(r['scores'] - exact).max():.4g}")
            errs[f"{variant} bf16 card vs CPU"] = check_close(
                f"(g) {variant} scores of all singles as the CLI gives them (bf16), card vs CPU",
                torch.as_tensor(r["scores"]), torch.as_tensor(bf16_cpu),
                MIF_BF16_FACTOR * noise, 0.0)
            del model, got, state, f32_cpu

        # (f) the legacy methods over ESM2-8M (bf16, K4 + rope_qk), on the
        # first singles; VenusREM's reads (c)'s weights file, so no K5
        e8 = esm2.PRESETS["esm2_t6_8M"]
        per = {"grouped_attention_bthd": e8.num_layers, "rope_qk": e8.num_layers}
        n_tab = -(-(length + 2) // batch)  # one masked row per token, batch rows a forward
        e8_rows = torch.as_tensor(np.tile(esm2.ALPHABET.tokenize(seq)[None], (batch, 1)),
                                  dtype=torch.long, device=dev)
        for tag, (model_name, column, extra, msa) in {
                "prosst_additive": ("prosst", "ProSST_2048_score", ["method=additive"], False),
                "mulan_additive": ("mulan", "MULAN_score", ["method=additive"], False),
                "venusrem_esm": ("venusrem", "VenusREM_score", ["method=esm"], True)}.items():
            r = run(model_name, "PLM_LEGACY", column, (esm2.EsmModel, "forward"), extra=extra,
                    msa=msa, patches=[keeping(esm2, "init_random", kept)])
            trunk = kept.pop("init_random")
            r["profile"] = profile_two(torch, fa, lambda: trunk(e8_rows))
            report_run("f", f"{model_name} --extra {extra[0]} (ESM2-8M)", r, card, column, n_tab,
                       per)
            runs[tag] = r

    # (h) the float32 K4 at MULAN-small's trunk rows and K1 at its adapter's
    records = {}
    for key, (label, b, h, tt, d) in (("k4", K4_MULAN), ("k1", K1_MULAN)):
        gen = torch.Generator(device=dev).manual_seed(tt + d)
        q, k, v = (torch.randn(b, tt, h, d, generator=gen, device=dev) for _ in range(3))
        mask = torch.arange(tt, device=dev)[None, :] < torch.tensor(
            [tt - (i % 4) * 7 for i in range(b)], device=dev)[:, None]
        tr = lambda x: x.transpose(1, 2)  # noqa: E731
        if key == "k4":  # ESM2's layers: q pre-scaled, RoPE in the kernel
            q = q * d ** -0.5
            call = dict(key_mask=mask, sm_scale=1.0, rope_base=10000.0)
            kernel = lambda: fa.grouped_mha_bthd(q, k, v, **call)  # noqa: E731
            plain = lambda: fa.plain_mha_bthd(q, k, v, **call)  # noqa: E731
            qr, kr = fa.plain_rope_qk(tr(q), tr(k), 1.0, 10000.0)
            what = f"B{b} T{tt} H{h} D{d} float32, pad mask + RoPE"
        else:  # the adapter: (B, H, T, D) views of (B, T, H, D) projections, the default scale
            q, k, v = tr(q), tr(k), tr(v)
            kernel = lambda: fa.grouped_mha(q, k, v, key_mask=mask)  # noqa: E731
            plain = lambda: fa.plain_mha(q, k, v, key_mask=mask)  # noqa: E731
            qr, kr = q * d ** -0.5, k
            what = f"B{b} H{h} T{tt} D{d} float32, key mask"
        got = kernel()
        torch.cuda.synchronize()
        err = check_close(f"(h) {'K4' if key == 'k4' else 'K1'} {what} ({label})", got, plain(),
                          F32_ATOL, F32_RTOL)
        vv = v if key == "k1" else tr(v)
        lib = sdpa(torch, qr, kr, vv, mask[:, None, None, :])
        times = median_pair(torch, {"kernel": kernel, "plain": plain, "sdpa": lib}, reps=3,
                            inner=5, rounds=1)
        bnd = bound(4.0 * b * h * d * tt * float(mask.sum(-1).float().mean()),
                    nbytes(q, k, v, got, mask), peak=PEAK_TF32_FLOPS / 3)
        print(f"  (h) {'K4' if key == 'k4' else 'K1'} {what}: kernel {times['kernel']:.4f} ms, "
              f"plain {times['plain']:.4f} ms, SDPA with the mask {times['sdpa']:.4f} ms "
              f"({sdpa_backend(torch, lib)}), bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
              f"3xTF32 at 495/3 TFLOP/s; {card})")
        records[key] = dict(label=label, shape=what, ms=times["kernel"], plain_ms=times["plain"],
                            library_ms=times["sdpa"], max_abs_err=err, **bnd)
        del q, k, v, qr, kr, got
        torch.cuda.empty_cache()
    print(f"  [structure PLMs] {time.perf_counter() - phase_t0:.1f} s in all; (g) "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return {"launches": {name: r["launches"] for name, r in runs.items()}, **records}


def mulan_logp_held(torch, fa, esm2, mulan, model, rows, feats, n):
    """MULAN's per-token log-probs of the first ``n`` masked rows with the
    kernels (K4 in the trunk, K1 in the adapter) and with the plain
    attention, held per token within MULAN_LOGP_ATOL; a planted fault, the
    adapter's last key tile (keys 192-251) skipped, must fail that check.
    Returns the max |kernel - plain|."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    rows, feats = rows[:n], feats[:n]
    plain = [mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd),
             mock.patch.object(mulan, "mha", fa.plain_mha)]

    def last_tile_skipped(q, k, v, key_mask=None, **kw):
        mask = key_mask.clone()
        mask[:, 192:] = False
        return fa.plain_mha(q, k, v, key_mask=mask, **kw)

    def token_logp(patches=()):
        with torch.no_grad(), contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            logp = torch.log_softmax(model(rows, feats), -1)
        return logp.gather(-1, rows[..., None])[..., 0]

    counts = saved_launches(fa.LAUNCHES, ln.LAUNCHES)
    got = token_logp()
    restore_launches(counts)  # the check's launches are not the path's
    want = token_logp(plain)
    err = check_close(f"(g) MULAN-small: {n} rows' per-token log-probs, kernels vs plain", got,
                      want, MULAN_LOGP_ATOL, 0.0)
    diff = float((token_logp([plain[0], mock.patch.object(mulan, "mha", last_tile_skipped)])
                  - want).abs().max())
    print(f"      planted fault, the adapter's last key tile skipped: max |diff| {diff:.4g} a "
          f"token (limit {MULAN_LOGP_ATOL:g})")
    if not diff > MULAN_LOGP_ATOL:
        fail("MULAN: the per-token check did not catch the adapter's skipped key tile")
    return err


def phase_slice_c(torch, dev, card, fa, check_close):
    """22. Structure slice C through the port's CLI at full width with seeded
    random weights, on phase 14's L=250 target, its 4,750 singles and phase
    20's helix in a PDB whose B-factors are 90 but 50 on 40 residues: (a)
    ``protssn`` with ``esm_checkpoint=esm2_t33_650M`` and the nine published
    members ``protssn_k{10,20,30}_h{512,768,1280}`` with seeded statistics
    (one ESM forward: 33 K4 + 33 rope_qk; each member's edges, host graph
    seconds and device ms); (b) ``s2f --checkpoint s2f``, ``s3f
    --checkpoint s3f`` with a 3,000-point seeded surface and ``s3f_msa
    --checkpoint s3f`` with phase 21's 16,384-row alignment (K5 once): the
    radius graph's edges, the surface graph's size and seconds; (c) ``aido``
    on the target with the alignment (8 forwards of 32 x 252) and on an
    L=1,000 target (48 forwards of 32 x 770), 8 K1 + 8 rope_qk a forward.
    Each run: the CLI wall and mutants/s, forwards and launches, peak
    memory, two forwards under the profiler. (d) AIDO's per-token log-probs
    of 8 rows, kernels against the plain attention, with the last key tile
    skipped shown to fail that check; the card against the CPU at full
    size: ProtSSN k20_h512's logits, S3F's node logits with its surface
    and S2F's scores (one edge dropped on the card shown to fail each), and
    AIDO's table rows of one chunk in bf16 within AIDO_BF16_FACTOR x the
    run's own bf16 noise. (e) K1 at AIDO's two shapes beside plain, SDPA and
    the bound, as ``grouped_attention:aido_T252`` / ``:aido_T770``."""
    from proteingym_tpu_torch.data.structures import (
        parse_pdb_backbone, parse_pdb_bfactors, synthetic_helix_backbone, write_pdb_backbone,
    )
    from proteingym_tpu_torch.models import esm2, protssn, s3f
    from proteingym_tpu_torch.models import structure_plms as sp
    from proteingym_tpu_torch.msa import weights as W
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.pipeline import cli

    s = SLICE_C
    batch, length = s["batch"], TRANCEPTION_SLICE["length"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    helix = synthetic_helix_backbone(length, seed=20)  # phase 20's helix
    helix[:, 1] += STRUCTURE_SLICE["ca_noise"] * np.random.RandomState(20).randn(length, 3)
    lo, hi = s["low_plddt"]
    plddt = np.full(length, 90.0)
    plddt[lo:hi] = 50.0
    long_seq, long_singles = synth_assay(s["long_length"], 23)
    assays = {"SC_L250": singles, "SC_L1000": long_singles}
    e650 = esm2.PRESETS["esm2_t33_650M"]
    esm_per = {"grouped_attention_bthd": e650.num_layers, "rope_qk": e650.num_layers}
    aido_cfg = sp.AidoConfig()
    aido_per = {"grouped_attention": aido_cfg.num_layers, "rope_qk": aido_cfg.num_layers}
    phase_t0 = time.perf_counter()
    print(f"[slice C] ProtSSN's 9 members, S2F, S3F, S3F-MSA (over ESM2-650M) and AIDO (seeded "
          f"random, full width) on phase 14's L={length} target and phase 20's helix; batch "
          f"{batch}; {card}")

    forwards = [0]
    kept, runs, errs, spans, sizes = {}, {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for d in ("dms", "pdb", "msa", "weights", "surface", "stats"):
            (root / d).mkdir()
        for dms_id, rows in assays.items():
            y = np.random.RandomState(22).randn(len(rows))
            write_csv_rows(root / "dms" / f"{dms_id}.csv", ["mutant", "DMS_score"],
                           [[x, repr(float(v))] for x, v in zip(rows, y)])
        write_pdb_backbone(root / "pdb" / "SC_L250.pdb", helix, seq, bfactors=plddt)
        write_a2m(root / "msa" / "SC.a2m", "SC", synth_family(codes, s["n_seqs"], seed=21))
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                        "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"],
                       [[dms_id, f"{dms_id}.csv", "SYNTH_SC", sq, len(sq), "SC.a2m", 1, len(sq),
                         0.2, "SC.npy"] for dms_id, sq in (("SC_L250", seq),
                                                           ("SC_L1000", long_seq))])
        rs = np.random.RandomState(24)
        n_pts = s["surface_points"]
        dirs = rs.randn(n_pts, 3)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        surf_pos = helix[rs.randint(0, length, n_pts), 1] + dirs * rs.uniform(2, 4, (n_pts, 1))
        np.savez(root / "surface" / "SC_L250.npz", position=surf_pos.astype(np.float32),
                 feature=rs.randn(n_pts, s["surface_features"]).astype(np.float32))
        stats = {}
        for k in (10, 20, 30):
            r_ = np.random.RandomState(k)
            stats[k] = root / "stats" / f"cath_k{k}_mean_attr.pt"
            torch.save({"pos_std": torch.from_numpy(r_.uniform(8, 12, 3)),
                        "edge_attr_mean": torch.from_numpy(r_.uniform(0, 0.5, 93)),
                        "edge_attr_std": torch.from_numpy(r_.uniform(0.5, 2.0, 93))}, stats[k])
        coords = parse_pdb_backbone(root / "pdb" / "SC_L250.pdb")[0]  # as the CLI reads it
        bf = parse_pdb_bfactors(root / "pdb" / "SC_L250.pdb")
        if not np.array_equal(bf, plddt.astype(np.float32)):
            fail("slice C: the PDB's B-factors do not read back")
        n_low = int((bf < 70).sum())
        print(f"  the PDB: {n_low} residues under pLDDT 70 (the ESM logits), {length - n_low} "
              "at or over it (the GVP-GNN's)")

        def run(model, dms_id, column, counted, checkpoint=None, extra=(), patches=(),
                msa=False):
            forwards[0] = 0
            flags = ["--structure-dir", str(root / "pdb")]
            if msa:
                flags += ["--msa-dir", str(root / "msa"), "--weights-dir", str(root / "weights")]
            r = cli_score(torch, cli, root, len(assays[dms_id]), model, dms_id, column,
                          (fa.LAUNCHES, W.LAUNCHES, ln.LAUNCHES), batch, checkpoint,
                          flags=flags, extra=extra,
                          patches=[counting(forwards, *counted), *patches])
            return dict(r, forwards=forwards[0])

        # (a) ProtSSN's nine members over ESM2-650M, one ESM forward
        members = [f"protssn_k{k}_h{h}" for k in (10, 20, 30) for h in (512, 768, 1280)]
        graphs, member_ms = [], []

        def timed_graph(fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                graphs.append((len(out[0]), time.perf_counter() - t0))
                return out
            return wrapper

        def timed_logp(fn):
            def wrapper(model, *args):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = fn(model, *args)
                end.record()
                torch.cuda.synchronize()
                member_ms.append(start.elapsed_time(end))
                return out
            return wrapper

        stat_list = ",".join(str(stats[int(m.split("_")[1][1:])]) for m in members)
        r = run("protssn", "SC_L250", "ProtSSN_ensemble", (esm2.EsmModel, "forward"),
                ",".join(members), extra=["esm_checkpoint=esm2_t33_650M",
                                          f"norm_stats={stat_list}"],
                patches=[keeping(protssn, "esm_embeddings", kept),
                         mock.patch.object(protssn, "init_random", spans_of(
                             torch, spans, "member inits", protssn.init_random)),
                         mock.patch.object(protssn, "score_mutants_egnn", spans_of(
                             torch, spans, "member scoring", protssn.score_mutants_egnn)),
                         mock.patch.object(protssn, "build_calpha_graph",
                                           timed_graph(protssn.build_calpha_graph)),
                         mock.patch.object(protssn, "egnn_log_probs",
                                           timed_logp(protssn.egnn_log_probs))])
        emb = kept.pop("esm_embeddings")
        cfg = dataclasses.replace(protssn.PROTSSN_PRESETS[s["protssn_cpu"]], input_dim=emb.shape[1])
        model = protssn.init_random(cfg, seed=0, device=dev)  # the CLI's member, rebuilt
        src, dst, edge_attr, pos = protssn.build_calpha_graph(coords[:, :3], cfg.k_neighbors)
        npos, nea = protssn.apply_norm_stats(pos, edge_attr, protssn.load_norm_stats(stats[20]))
        r["profile"] = profile_two(torch, fa, lambda: protssn.egnn_log_probs(
            model, emb, npos, src, dst, nea))
        report_run("a", "protssn, 9 members over esm2_t33_650M", r, card, "ProtSSN_ensemble", 1,
                   esm_per, detail=f"; the members' seeded inits {spans['member inits']:.2f} s, "
                   f"their score loops {spans['member scoring']:.2f} s, graphs "
                   f"{sum(g[1] for g in graphs):.2f} s, forwards {sum(member_ms) / 1e3:.2f} s; "
                   "the profiled forwards are k20_h512's")
        for name, (edges, secs), ms in zip(members, graphs, member_ms):
            print(f"      {name}: {edges} edges, graph {secs:.3f} s (host), device {ms:.2f} ms")
        runs["protssn"] = r
        cpu = protssn.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, cfg,
                                      device="cpu")

        def protssn_logits(net, edges):
            d = net.lin.weight.device
            f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=d)  # noqa: E731
            i = lambda x: torch.as_tensor(x[edges], dtype=torch.long, device=d)  # noqa: E731
            with torch.no_grad():
                return net(f(emb), f(npos), i(src), i(dst), f(nea[edges])).cpu()

        every = np.ones(len(src), bool)
        logp = protssn.egnn_log_probs(model, emb, npos, src, dst, nea)
        got = protssn_logits(model, every)
        t0 = time.perf_counter()
        want = protssn_logits(cpu, every)
        cpu_s = time.perf_counter() - t0
        scale = float(want.abs().max())
        saturated = float(((logp == 0) | (logp < -20.7)).float().mean())
        errs["ProtSSN card vs CPU"] = check_close(
            f"(d) ProtSSN {s['protssn_cpu']} logits, card vs CPU ({cpu_s:.2f} s on the CPU; |logit| "
            f"up to {scale:.4g}, {saturated:.1%} of the log-probs at 0 or log 1e-9)", got, want,
            PROTSSN_CPU_RTOL * scale, 0.0)
        moved = float((protssn_logits(model, np.arange(len(src)) != len(src) // 2)
                       - want).abs().max())
        print(f"      planted fault, one edge dropped on the card: max |diff| {moved:.4g} "
              f"(limit {PROTSSN_CPU_RTOL * scale:.4g})")
        if not moved > PROTSSN_CPU_RTOL * scale:
            fail("ProtSSN: the card-vs-CPU check did not catch a dropped edge")
        del model, cpu, got, want, logp
        torch.cuda.empty_cache()

        # (b) S2F, S3F with its surface, S3F-MSA (K5 once: no weights file yet)
        def sized(fn, key):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sizes[key] = (out, time.perf_counter() - t0)
                return out
            return wrapper

        for variant, column, msa in (("s2f", "S2F_score", False), ("s3f", "S3F_score", False),
                                     ("s3f_msa", "S3F_MSA_score", True)):
            logits_store, score_store = {}, {}
            r = run(variant, "SC_L250", column, (esm2.EsmModel, "forward"),
                    "s2f" if variant == "s2f" else "s3f", msa=msa,
                    extra=["esm_checkpoint=esm2_t33_650M",
                           *([] if variant == "s2f" else [f"surface_dir={root / 'surface'}"])],
                    patches=[keeping(s3f, "init_random", kept),
                             mock.patch.object(s3f, "radius_graph",
                                               sized(s3f.radius_graph, "radius")),
                             mock.patch.object(s3f, "build_surface_inputs",
                                               sized(s3f.build_surface_inputs, "surface")),
                             capturing(torch, s3f, "gvpgnn_node_logits", logits_store),
                             capturing(torch, s3f, "score_mutants_gvpgnn", score_store)])
            model = kept.pop("init_random")
            m_args, surface = logits_store["args"][1:], logits_store["kwargs"].get("surface")
            r["profile"] = profile_two(torch, fa, lambda: s3f.gvpgnn_node_logits(
                model, *m_args, surface=surface))
            (src, dst), radius_s = sizes["radius"]
            detail = f"; radius graph {len(src)} edges in {radius_s:.3f} s"
            if surface is not None:
                detail += (f"; surface {len(surface['position'])} points, {len(surface['src'])} "
                           f"edges, built in {sizes['surface'][1]:.2f} s (host)")
            detail += f"; GVP-GNN {logits_store['seconds']:.3f} s; the profiled forwards are its"
            report_run("b", f"{variant} --checkpoint {'s2f' if variant == 's2f' else 's3f'}", r,
                       card, column, 1, esm_per,
                       extra_launches={"cluster_counts": 1} if msa else None, detail=detail)
            runs[variant] = r
            if variant == "s3f_msa":
                continue
            cpu = s3f.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                                      model.config, device="cpu")
            emb_, pos_, src_, dst_ = m_args
            t0 = time.perf_counter()
            want = s3f.gvpgnn_node_logits(cpu, emb_.cpu(), pos_, src_, dst_, surface)
            cpu_s = time.perf_counter() - t0
            if variant == "s3f":
                errs["S3F card vs CPU"] = check_close(
                    f"(d) S3F node logits with the surface, card vs CPU ({cpu_s:.2f} s on the "
                    "CPU)", logits_store["out"].cpu(), want, SLICE_C_CPU_ATOL, 0.0)
            else:
                _, esm20, bfac, _, _ = score_store["args"]
                want_scores = s3f.score_mutants_gvpgnn(want, esm20, bfac, seq, singles)
                errs["S2F card vs CPU"] = check_close(
                    f"(d) S2F scores of all singles, card vs CPU ({cpu_s:.2f} s on the CPU)",
                    torch.as_tensor(r["scores"]), torch.as_tensor(want_scores),
                    SLICE_C_CPU_ATOL, 0.0)
            # the planted fault: the first edge out of residue 60 (pLDDT 90, so
            # its row's score reads the GVP-GNN's logits) dropped on the card
            keep = np.arange(len(src_)) != int(np.flatnonzero(np.asarray(src_) == 60)[0])
            dropped = s3f.gvpgnn_node_logits(model, emb_, pos_, src_[keep], dst_[keep], surface)
            if variant == "s3f":
                moved, of = float((dropped.cpu() - want).abs().max()), "the logits"
            else:  # S2F's check reads the scores: the fault's logits scored as the CLI does
                moved = float(np.abs(s3f.score_mutants_gvpgnn(dropped, esm20, bfac, seq, singles)
                                     - want_scores).max())
                of = "the scores"
            print(f"      planted fault, one edge out of residue 60 dropped on the card: max "
                  f"|diff| of {of} {moved:.4g} (limit {SLICE_C_CPU_ATOL:g})")
            if not moved > SLICE_C_CPU_ATOL:
                fail(f"{variant}: the card-vs-CPU check did not catch a dropped edge")
            del cpu, want, dropped
        del model
        torch.cuda.empty_cache()

        # (c) AIDO on the target with the alignment (its weights file from
        # (b)), then on the L=1,000 target without one
        for tag, dms_id, msa in (("aido", "SC_L250", True), ("aido_L1000", "SC_L1000", False)):
            n_res = len(seq) if dms_id == "SC_L250" else len(long_seq)
            want_fwd = sum(-(-min(sp.AIDO_WINDOW, n_res - st) // batch)
                           for st in sp.aido_sliding_starts(n_res))
            r = run("aido", dms_id, "AIDO_score", (sp.Aido, "forward"), msa=msa,
                    patches=[keeping(sp, "aido_init", kept)])
            model = kept.pop("aido_init")
            t_win = min(sp.AIDO_WINDOW, n_res) + 2
            grid = torch.as_tensor(np.tile(esm2.ALPHABET.tokenize(
                (seq if dms_id == "SC_L250" else long_seq)[:t_win - 2])[None], (batch, 1)),
                device=dev)
            r["profile"] = profile_two(torch, fa, lambda: model(grid))
            report_run("c", f"aido on L={n_res} ({'with' if msa else 'without'} the alignment; "
                       f"windows at {sp.aido_sliding_starts(n_res)}, T={t_win})", r, card,
                       "AIDO_score", want_fwd, aido_per)
            runs[tag] = r
        # (d) AIDO's per-token log-probs of 8 rows, kernels vs plain attention
        rows = torch.as_tensor(np.tile(esm2.ALPHABET.tokenize(seq)[None], (s["logp_rows"], 1)),
                               device=dev)
        rows[torch.arange(s["logp_rows"]), 1 + 29 * torch.arange(s["logp_rows"])] = \
            esm2.ALPHABET.mask_idx
        errs["AIDO per token"] = aido_logp_held(torch, fa, sp, model, rows)
        # (d) AIDO's table rows of the first chunk (32 grids of the L=250
        # target), the card's bf16 against the same bf16 module on the CPU
        # (its plain attention), within AIDO_BF16_FACTOR x the CPU's own bf16
        # noise against a float32 copy
        chunk = torch.as_tensor(np.tile(esm2.ALPHABET.tokenize(seq)[None], (batch, 1)))
        chunk[torch.arange(batch), 1 + torch.arange(batch)] = esm2.ALPHABET.mask_idx
        at = (torch.arange(batch), 1 + torch.arange(batch))
        aido_cpu = sp.aido_load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                                           aido_cfg, device="cpu")
        f32_cfg = dataclasses.replace(aido_cfg, dtype=torch.float32)
        aido_f32 = sp.aido_load_state_dict({k: v.cpu().float()
                                            for k, v in model.state_dict().items()}, f32_cfg,
                                           device="cpu")
        counts, chosen = saved_launches(fa.LAUNCHES, ln.LAUNCHES), []
        with torch.no_grad():
            with routes(torch, record=chosen):
                got = model(chunk.to(dev))[at].cpu()
            restore_launches(counts)  # the check's launches are not the path's
            t0 = time.perf_counter()
            with routes(torch, replay=chosen):
                want = aido_cpu(chunk)[at]
            cpu_s = time.perf_counter() - t0
            with routes(torch, replay=chosen):
                exact = aido_f32(chunk)[at]
        noise = float((want - exact).abs().max())
        print(f"      AIDO table rows against a float32 copy's: the CPU's bf16 {noise:.4g} at "
              f"most, the card's {float((got - exact).abs().max()):.4g}")
        errs["AIDO card vs CPU"] = check_close(
            f"(d) AIDO table rows of one chunk ({batch} grids, bf16, the card's routing "
            f"replayed), card vs CPU ({cpu_s:.1f} s on the CPU)", got, want,
            AIDO_BF16_FACTOR * noise, 0.0)
        with torch.no_grad(), routes(torch, replay=chosen), mock.patch.object(
                sp, "mha", lambda *a, **kw: last_key_tile_skipped(fa, *a, **kw)):
            moved = float((model(chunk.to(dev))[at].cpu() - want).abs().max())
        print(f"      planted fault, the last key tile skipped on the card: max |diff| {moved:.4g} "
              f"(limit {AIDO_BF16_FACTOR * noise:.4g})")
        if not moved > AIDO_BF16_FACTOR * noise:
            fail("AIDO: the card-vs-CPU check did not catch the skipped key tile")
        del model, aido_cpu, aido_f32

    # (e) K1 at AIDO's two shapes: (B, T, H, D) projections seen as (B, H,
    # T, D), every key live, the default scale (the pre-pass rounds q * 1/8)
    records = []
    for label, b, h, tt, d in K1_AIDO:
        gen = torch.Generator(device=dev).manual_seed(tt + d + h)
        q, k, v = (torch.randn(b, tt, h, d, generator=gen, device=dev).to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        key_mask = torch.ones(b, tt, dtype=torch.bool, device=dev)
        got = fa.grouped_mha(q, k, v, key_mask=key_mask)
        torch.cuda.synchronize()
        what = f"B{b} H{h} T{tt} D{d} bf16, key mask, every key live"
        err = check_close(f"(e) K1 {what} ({label})", got,
                          fa.plain_mha(q.float(), k.float(), v.float(), key_mask=key_mask),
                          BF16_ATOL, BF16_RTOL)
        fns = {"kernel": lambda: fa.grouped_mha(q, k, v, key_mask=key_mask),
               "plain": lambda: fa.plain_mha(q, k, v, key_mask=key_mask),
               "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)}
        times = median_pair(torch, fns, reps=3, inner=5, rounds=1)
        bnd = bound(4.0 * b * h * d * tt * tt, nbytes(q, k, v, got))
        print(f"  (e) K1 {what}: kernel {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
              f"SDPA without a mask {times['sdpa']:.4f} ms ({sdpa_backend(torch, fns['sdpa'])}), "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {card})")
        records.append(dict(label=label, shape=what, ms=times["kernel"], plain_ms=times["plain"],
                            library_ms=times["sdpa"], max_abs_err=err, **bnd))
        del q, k, v, got
        torch.cuda.empty_cache()
    print(f"  [slice C] {time.perf_counter() - phase_t0:.1f} s in all; (d) "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return {"launches": {name: r["launches"] for name, r in runs.items()}, "k1": records}


@contextlib.contextmanager
def routes(torch, record=None, replay=None):
    """The MoE's routing weights (``progen3.router_weights``, one (N, E)
    tensor a layer) appended to ``record`` as the model computes them, or
    taken from ``replay`` in the same order: a check that replays one run's
    routing compares everything but the router's discrete top-k choice."""
    from proteingym_tpu_torch.models import progen3

    fn, taken = progen3.router_weights, iter(replay or ())

    def wrapper(x32, router, num_experts, top_k):
        if replay is not None:
            return next(taken).to(x32.device)
        weights = fn(x32, router, num_experts, top_k)
        record.append(weights)
        return weights
    with mock.patch.object(progen3, "router_weights", wrapper):
        yield


def last_key_tile_skipped(fa, q, k, v, key_mask=None, **kw):
    """The plain attention with keys 192 on (the last 64-key tile of a
    252-token row) masked: the planted fault of phase 22's AIDO checks."""
    mask = key_mask.clone()
    mask[:, 192:] = False
    return fa.plain_mha(q, k, v, key_mask=mask, **kw)


def aido_logp_held(torch, fa, sp, model, rows):
    """AIDO's per-token log-probs of ``rows`` (one masked position each) with
    K1 and with the plain attention, the kernel run's routing replayed in
    the others, held per token within AIDO_LOGP_ATOL; a planted fault, the
    last key tile (keys 192-251) skipped, must fail that check. Returns the
    max |kernel - plain|."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    def last_tile_skipped(*args, **kw):
        return last_key_tile_skipped(fa, *args, **kw)

    chosen = []

    def token_logp(attention=None, replay=True):
        with torch.no_grad(), contextlib.ExitStack() as stack:
            if attention is not None:
                stack.enter_context(mock.patch.object(sp, "mha", attention))
            if attention is None or replay:
                stack.enter_context(routes(torch, record=chosen) if attention is None
                                    else routes(torch, replay=chosen))
            logp = torch.log_softmax(model(rows), -1)
        return logp.gather(-1, rows[..., None])[..., 0]

    counts = saved_launches(fa.LAUNCHES, ln.LAUNCHES)
    got = token_logp()
    restore_launches(counts)  # the check's launches are not the path's
    want = token_logp(fa.plain_mha)
    free = float((token_logp(fa.plain_mha, replay=False) - got).abs().max())
    print(f"      without the replay (each run routes for itself): max |diff| {free:.4g} a "
          "token")
    err = check_close(f"(d) AIDO: {len(rows)} rows' per-token log-probs, K1 vs plain", got, want,
                      AIDO_LOGP_ATOL, 0.0)
    diff = float((token_logp(last_tile_skipped) - want).abs().max())
    print(f"      planted fault, the last key tile skipped: max |diff| {diff:.4g} a token "
          f"(limit {AIDO_LOGP_ATOL:g})")
    if not diff > AIDO_LOGP_ATOL:
        fail("AIDO: the per-token check did not catch the skipped key tile")
    return err


# the shapes of phase 23: phase 14's L=250 target with its 4,750 singles
# (the ridges, VESPA, VespaG) and every 4th of them, 1,024 (ProteinNPT and
# Kermut: time), on phase 20's helix; ProtT5-XL's 4 table rows (of 250) on
# the CPU, ProteinNPT's 50 steps a fold (600 published, 200 before phase
# 24, then 100: time; each step is ~15 ms of host work), 5 steps of it
# on the card and the CPU with the same draws, the embedding ridge's
# features of 8 rows on the CPU (in float32: ESM2-650M's bf16 on 64 rows
# would take minutes of the host's cores)
SUPERVISED_SLICE = dict(batch=32, subset=1024, npt_steps=50, t5_cpu_rows=(0, 83, 166, 249),
                        feature_cpu_rows=8, npt_cpu_steps=5, profiled_npt_steps=20)
# (label, B, H, T, D) of K4 at ESM2-3B's rows, VespaG's trunk: 40 heads of 64
K4_ESM2_3B = ("esm2_3b", 1, 40, 252, 64)
# ProtT5-XL's masked log-odds, card against CPU: float32 without TF32 on both
# through 24 + 24 layers of d_ff 16384, summation order apart: 7.6e-3 on an
# H100 at 700 W (a chip run of this phase); T5's softmax scale put in (the
# planted fault) moved them by 2.35
VESPA_CPU_ATOL = 5e-2
# VespaG's float32 head (2560 -> 256 -> 20) on the same embeddings; a LeakyReLU
# slope of 0.2 for 0.01 moves the landscape by ~0.1
VESPAG_CPU_ATOL = 1e-4
# the ridges' out-of-fold predictions, card (cuSOLVER) against CPU (LAPACK),
# float32 Choleskys of the 5,000-wide one-hot Gram (counts up to ~3,800 on
# its diagonal beside lam 1) and the 1,280-wide embedding one on the same
# features: the one-hot ridge's read 1.5e-2 on an H100 at 700 W (a chip run
# of this phase); each row given its neighbour's target (the planted fault)
# must move them more
RIDGE_CPU_ATOL = 5e-2
# ESM2-650M's mean-pooled features, bf16 on the card against a float32 copy
# on the CPU: the card's own bf16 rounding through 33 layers; the last key
# tile dropped in every layer (the planted fault) moves them by O(0.1)
FEATURE_CPU_ATOL = 1e-1
# ProteinNPT's parameters after 5 Adam steps on the same draws (key biases
# aside: softmax ignores them, Adam turns their rounding into +-lr steps)
NPT_STEP_ATOL = 1e-4
# Kermut's hyperparameters after 50 Adam steps at lr 0.1 through a float32
# Cholesky of an ~820-wide Gram, and the fold's predictions with them
KERMUT_CPU_ATOL = 1e-2


def k4_record(torch, dev, fa, card, spec, tag):
    """K4 at ``spec`` (label, B, H, T, D) as ESM2's layers call it, bf16
    (B, T, H, D) q/k/v, q pre-scaled, RoPE in the pre-pass, every key live:
    held against the plain version, timed beside it, SDPA on the rotated
    q/k and the bound."""
    label, b, h, tt, d = spec
    gen = torch.Generator(device=dev).manual_seed(tt + h)
    q, k, v = (torch.randn(b, tt, h, d, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    q = (q.float() * d ** -0.5).to(torch.bfloat16)
    mask = torch.ones(b, tt, dtype=torch.bool, device=dev)
    call = dict(key_mask=mask, sm_scale=1.0, rope_base=10000.0)
    got = fa.grouped_mha_bthd(q, k, v, **call)
    torch.cuda.synchronize()
    what = f"B{b} H{h} T{tt} D{d} bf16, mask + RoPE (every key live)"
    err = check_close(f"({tag}) K4 {what} ({label})", got,
                      fa.plain_mha_bthd(q.float(), k.float(), v.float(), **call),
                      BF16_ATOL, BF16_RTOL)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    qr, kr = fa.rope_qk(tr(q), tr(k), 1.0, 10000.0)
    lib = sdpa(torch, qr, kr, tr(v), mask[:, None, None, :])
    times = median_pair(torch, {
        "plain": lambda: fa.plain_mha_bthd(q, k, v, **call),
        "kernel": lambda: fa.grouped_mha_bthd(tr(qr), tr(kr), v, key_mask=mask, sm_scale=1.0),
        "sdpa": lib,
        "call": lambda: fa.grouped_mha_bthd(q, k, v, **call),
    }, reps=3, inner=10, rounds=1)
    bnd = bound(4.0 * d * h * tt * float(mask.sum()), nbytes(q, k, v, got, mask))
    print(f"  ({tag}) K4 {what}: the call (pre-pass + loop) {times['call']:.4f} ms, the loop "
          f"alone {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, SDPA on the rotated "
          f"q/k {times['sdpa']:.4f} ms ({sdpa_backend(torch, lib)}), bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {card})")
    return dict(label=label, shape=what, ms=times["call"], loop_ms=times["kernel"],
                plain_ms=times["plain"], library_ms=times["sdpa"], max_abs_err=err, **bnd)


def key_tail_dropped(fa, tail=64):
    """``mha_natural`` with each row's last ``tail`` keys masked: the
    planted fault of phase 23's feature check."""
    def attention(q, k, v, key_mask=None, **kw):
        mask = key_mask.clone()
        mask[:, -tail:] = False
        return fa.mha_natural(q, k, v, key_mask=mask, **kw)
    return attention


def phase_supervised(torch, dev, card, fa, check_close):
    """23. The supervised track and the VESPA family at full width with seeded
    weights, on phase 14's L=250 target (4,750 singles) and every 4th of
    them (1,024), phase 20's helix as the structure: (a) ``vespa``,
    ``vespa_mode=full``, through the scorer's library call with a ProtT5-XL
    T5ForConditionalGeneration state dict (24 + 24 layers, HF names) in
    ``extra["params"]``, a ``prott5cons`` ConsCNN file and DEFAULT_BLEND
    (no kernel of the port: T5's (B, H, T, T) bias is plain attention): the
    masked log-odds table's seconds, 4 of its rows on the card against the
    CPU, T5's absent softmax scale put in shown to fail that check; (b)
    ``score --model vespag --checkpoint state_dict_v2.pt --extra
    esm_checkpoint=esm2_t36_3B`` (a seeded FNN 2560 -> 256 -> 20; one
    ESM2-3B forward, 36 K4 + 36 rope_qk): the landscape on the card
    against the CPU on the same embeddings (a LeakyReLU slope of 0.2 shown
    to fail), K4 at B1 H40 T252 D64 beside plain, SDPA and the bound; (c)
    ``ohe_ridge`` and ``embeddings_ridge --checkpoint esm2_t33_650M`` over
    all singles and three schemes (149 forwards of 33 K4 + 33 rope_qk):
    seconds, the features of 8 rows against a float32 CPU copy (the last
    key tile dropped shown to fail), the last scheme's out-of-fold
    predictions against the CPU's ridge on the same features; (d)
    ``proteinnpt --extra npt_steps=50`` on the 1,024: ms a step, the idle
    share of 20 profiled steps, 5 steps on the card and the CPU with the
    same draws per parameter (other draws shown to fail); (e) ``kermut
    --structure-dir`` on the 1,024 (50 Adam steps a fold): seconds, the last
    fold's hyperparameters and predictions against the CPU's fit, the
    distance term dropped shown to fail; (f) ``supervised-score --model
    OHE_ridge`` -> ``merge-supervised`` -> ``evaluate-supervised`` over
    (c)-(e)'s files, each one's wall."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    from proteingym_tpu_torch.data.mutants import apply_mutant
    from proteingym_tpu_torch.data.reference import load_reference
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
    from proteingym_tpu_torch.models import esm2, kermut, prot_t5, protein_npt, protssn
    from proteingym_tpu_torch.models import supervised_baselines as sb
    from proteingym_tpu_torch.models import vespa_heads, vespag
    from proteingym_tpu_torch.pipeline import cli, scorers

    s = SUPERVISED_SLICE
    batch, length = s["batch"], TRANCEPTION_SLICE["length"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 14's target
    seq = "".join(GAP_AA[c] for c in codes)
    singles = [f"{seq[p]}{p + 1}{a}" for p in range(length) for a in AA if a != seq[p]]
    subset = singles[::len(singles) // s["subset"]][:s["subset"]]
    helix = synthetic_helix_backbone(length, seed=20)  # phase 20's helix
    helix[:, 1] += STRUCTURE_SLICE["ca_noise"] * np.random.RandomState(20).randn(length, 3)
    y = np.random.RandomState(23).randn(len(singles))
    zero_shot = y + np.random.RandomState(24).randn(len(singles))
    schemes = sb.CV_SCHEMES
    phase_t0 = time.perf_counter()
    print(f"[supervised] VESPA (ProtT5-XL + ConsCNN), VespaG (over ESM2-3B), the OHE and "
          f"embedding ridges (ESM2-650M), ProteinNPT and Kermut (seeded, full width) on phase "
          f"14's L={length} target ({len(singles)} singles; {len(subset)} for ProteinNPT and "
          f"Kermut) and phase 20's helix; batch {batch}; {card}")
    runs, errs, walls = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for d in ("dms", "pdb"):
            (root / d).mkdir()
        at = {m: i for i, m in enumerate(singles)}
        for dms_id, rows in (("SUP_L250", singles), ("SUP_1024", subset)):
            write_csv_rows(root / "dms" / f"{dms_id}.csv", ["mutant", "DMS_score", "zero_shot_score"],
                           [[m, repr(float(y[at[m]])), repr(float(zero_shot[at[m]]))]
                            for m in rows])
            write_pdb_backbone(root / "pdb" / f"{dms_id}.pdb", helix, seq)
        write_csv_rows(root / "reference.csv",
                       ["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len", "taxon",
                        "coarse_selection_type", "MSA_Neff_L_category"],
                       [["SUP_L250", "SUP_L250.csv", "SUP_A", seq, length, "Human", "Activity",
                         "Low"],
                        ["SUP_1024", "SUP_1024.csv", "SUP_B", seq, length, "Virus", "Stability",
                         "High"]])
        reference = load_reference(root / "reference.csv")

        # (a) VESPA through the library call, ProtT5-XL's state dict in extra["params"]
        xl = prot_t5.PRESETS["prot_t5_xl"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t5 = prot_t5.init_random(xl, seed=0, device=dev, decoder_layers=xl.num_layers)
        state = t5.state_dict()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in t5.parameters())
        cons = vespa_heads.init_conscnn(seed=0, device=dev)
        torch.save({"0.weight": cons.conv1.weight[..., None].cpu(),
                    "0.bias": cons.conv1.bias.cpu(),
                    "3.weight": cons.conv2.weight[..., None].cpu(),
                    "3.bias": cons.conv2.bias.cpu()}, root / "prott5cons.pt")
        ctx = scorers.ScoreContext(record=reference["SUP_L250"], mutants=singles, device=dev,
                                   extra={"vespa_mode": "full", "params": state,
                                          "conscnn_checkpoint": str(root / "prott5cons.pt")})
        kept, table = {}, {}
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        ln.LAUNCHES["layer_norm"] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with keeping(prot_t5, "load_state_dict", kept), \
                capturing(torch, prot_t5, "masked_logodds", table):
            vespa = scorers.SCORERS["vespa"](ctx)["VESPA_score"]
        wall = time.perf_counter() - t0
        check_launches("vespa", {**fa.LAUNCHES, **ln.LAUNCHES}, {})
        runs["vespa"] = {"launches": {**fa.LAUNCHES, **ln.LAUNCHES}}
        if len(vespa) != len(singles) or not np.isfinite(vespa).all() or (vespa > 0).any():
            fail("vespa: scores not finite, not one per single, or above 0")
        del ctx, state, t5
        model = kept.pop("load_state_dict")
        print(f"  (a) vespa_mode=full: ProtT5-XL T5ForConditionalGeneration ({n_params / 1e9:.2f}B "
              f"parameters float32, seeded on the card in {init_s:.2f} s), {len(singles)} finite "
              f"VESPA_score in {wall:.2f} s, of which the masked log-odds table ({length} encoder "
              f"rows in chunks of 32, one 2-token decode each) {table['seconds']:.2f} s; no "
              f"kernel of the port (T5's bias is plain attention); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
        rows = list(s["t5_cpu_rows"])
        t0 = time.perf_counter()
        cpu_model = prot_t5.load_state_dict(model.state_dict(), device="cpu")
        want = prot_t5.masked_logodds(cpu_model, seq, positions=rows)
        cpu_s = time.perf_counter() - t0
        del cpu_model
        errs["ProtT5-XL log-odds card vs CPU"] = check_close(
            f"(a) ProtT5-XL masked log-odds, rows {rows}, card vs CPU ({cpu_s:.1f} s on the CPU)",
            torch.from_numpy(table["out"][rows]), torch.from_numpy(want), VESPA_CPU_ATOL, 0.0)
        real = prot_t5._attend
        with mock.patch.object(prot_t5, "_attend",
                               lambda q, k, v, b: real(q * q.shape[-1] ** -0.5, k, v, b)):
            bad = prot_t5.masked_logodds(model, seq, positions=rows)
        fault = float(np.abs(bad - want).max())
        print(f"  (a) the planted fault, T5's absent d_kv**-0.5 softmax scale put in: max |diff| "
              f"{fault:.3g} (limit {VESPA_CPU_ATOL:g})")
        if fault <= VESPA_CPU_ATOL:
            fail("vespa: the planted softmax-scale fault passes the card-vs-CPU check")
        del model, kept, table, bad
        torch.cuda.empty_cache()

        # (b) VespaG through the CLI over ESM2-3B
        e3b = esm2.PRESETS["esm2_t36_3B"]
        rs = np.random.RandomState(25)
        gain = math.sqrt(2.0 / (1 + 1e-2 ** 2))
        head_sd = {"net.0.weight": torch.from_numpy(
                       (rs.randn(256, e3b.embed_dim) * gain / math.sqrt(e3b.embed_dim))
                       .astype(np.float32)),
                   "net.0.bias": torch.from_numpy((0.01 * rs.randn(256)).astype(np.float32)),
                   "net.2.weight": torch.from_numpy(
                       (rs.randn(20, 256) * gain / math.sqrt(256)).astype(np.float32)),
                   "net.2.bias": torch.from_numpy((0.01 * rs.randn(20)).astype(np.float32))}
        torch.save(head_sd, root / "state_dict_v2.pt")
        emb = {}
        r = cli_score(torch, cli, root, len(singles), "vespag", "SUP_L250", "VespaG_score",
                      [fa.LAUNCHES, ln.LAUNCHES], batch, checkpoint=str(root / "state_dict_v2.pt"),
                      extra=["esm_checkpoint=esm2_t36_3B"],
                      patches=[capturing(torch, protssn, "esm_embeddings", emb)])
        r["forwards"] = emb["calls"]
        report_run("b", "vespag --checkpoint state_dict_v2.pt (ESM2-3B)", r, card, "VespaG_score",
                   1, {"grouped_attention_bthd": e3b.num_layers, "rope_qk": e3b.num_layers},
                   detail=f"; the embeddings {emb['seconds']:.2f} s")
        runs["vespag"] = r
        head = vespag.load_state_dict(head_sd, device=dev)
        land = vespag.landscape(head, emb["out"])
        if not np.allclose(vespag.score_mutants_reference(land, seq, singles), r["scores"],
                           atol=1e-6):
            fail("vespag: the CLI's scores are not its landscape's")
        want = vespag.landscape(vespag.load_state_dict(head_sd, device="cpu"), emb["out"].cpu())
        errs["VespaG landscape card vs CPU"] = check_close(
            "(b) VespaG landscape (250 x 20), card vs CPU on the same embeddings",
            torch.from_numpy(land), torch.from_numpy(want), VESPAG_CPU_ATOL, 0.0)
        with mock.patch.object(vespag, "LEAKY_SLOPE", 0.2):
            fault = float(np.abs(vespag.landscape(head, emb["out"]) - want).max())
        print(f"  (b) the planted fault, a LeakyReLU slope of 0.2: max |diff| {fault:.3g} "
              f"(limit {VESPAG_CPU_ATOL:g})")
        if fault <= VESPAG_CPU_ATOL:
            fail("vespag: the planted slope fault passes the card-vs-CPU check")
        del emb, head
        torch.cuda.empty_cache()
        record = k4_record(torch, dev, fa, card, K4_ESM2_3B, "b")

        # (c) the ridges through the CLI
        ohe, emb_ridge, feats = {}, {}, {}
        r = cli_score(torch, cli, root, len(singles), "ohe_ridge", "SUP_L250",
                      f"OHE_ridge_{schemes[0]}", [fa.LAUNCHES, ln.LAUNCHES], batch,
                      patches=[capturing(torch, sb, "ridge_cv_predict", ohe)])
        r["forwards"] = 0
        report_run("c", "ohe_ridge, 3 schemes x 5 folds", r, card, f"OHE_ridge_{schemes[0]}", 0,
                   {}, detail=f"; the ridges {ohe['seconds']:.2f} s (features "
                   f"{ohe['args'][0].shape[1]} wide)")
        runs["ohe_ridge"] = r
        e650 = esm2.PRESETS["esm2_t33_650M"]
        r = cli_score(torch, cli, root, len(singles), "embeddings_ridge", "SUP_L250",
                      f"Emb_ridge_{schemes[0]}", [fa.LAUNCHES, ln.LAUNCHES], batch,
                      checkpoint="esm2_t33_650M",
                      patches=[capturing(torch, sb, "ridge_cv_predict", emb_ridge),
                               capturing(torch, sb, "esm_embedding_features", feats)])
        r["forwards"] = -(-len(singles) // batch)
        report_run("c", "embeddings_ridge --checkpoint esm2_t33_650M", r, card,
                   f"Emb_ridge_{schemes[0]}", r["forwards"],
                   {"grouped_attention_bthd": e650.num_layers, "rope_qk": e650.num_layers},
                   detail=f"; the features {feats['seconds']:.2f} s, the ridges "
                   f"{emb_ridge['seconds']:.2f} s")
        runs["embeddings_ridge"] = r
        random_folds = sb.assign_folds(singles, schemes[0])
        for name, box in (("OHE", ohe), ("embedding", emb_ridge)):
            # fold_random_5 (the contiguous scheme holds out unseen positions:
            # the one-hot ridge predicts about the training mean there)
            features, targets = box["args"][:2]
            got = sb.ridge_cv_predict(features, targets, random_folds, device=dev)
            t0 = time.perf_counter()
            want = sb.ridge_cv_predict(features, targets, random_folds, device="cpu")
            errs[f"{name} ridge card vs CPU"] = check_close(
                f"(c) {name} ridge, {schemes[0]} out of fold, card vs CPU ("
                f"{time.perf_counter() - t0:.1f} s on the CPU)", torch.from_numpy(got),
                torch.from_numpy(want), RIDGE_CPU_ATOL, 0.0)
            bad = sb.ridge_cv_predict(features, np.roll(targets, 1), random_folds, device=dev)
            fault = float(np.abs(bad - want).max())
            print(f"  (c) the planted fault, each row given its neighbour's target: max |diff| "
                  f"{fault:.3g} (limit {RIDGE_CPU_ATOL:g})")
            if fault <= RIDGE_CPU_ATOL:
                fail(f"{name} ridge: the planted target fault passes the card-vs-CPU check")
        esm_card = feats["args"][0]
        n_rows = s["feature_cpu_rows"]
        rows8 = feats["args"][1][:n_rows]
        cpu_esm = esm2.load_fair_esm_state_dict(  # a float32 copy of the card's bf16 weights
            esm_card.state_dict(), dataclasses.replace(e650, dtype=torch.float32), device="cpu")
        t0 = time.perf_counter()
        want = sb.esm_embedding_features(cpu_esm, rows8, batch_size=n_rows)
        cpu_s = time.perf_counter() - t0
        del cpu_esm
        errs["embedding features card vs CPU"] = check_close(
            f"(c) ESM2-650M features of {n_rows} rows, bf16 card vs float32 CPU ({cpu_s:.1f} s)",
            torch.from_numpy(feats["out"][:n_rows]), torch.from_numpy(want), FEATURE_CPU_ATOL, 0.0)
        with mock.patch.object(esm2, "mha_natural", key_tail_dropped(fa)):
            bad = sb.esm_embedding_features(esm_card, rows8, batch_size=n_rows)
        fault = float(np.abs(bad - want).max())
        print(f"  (c) the planted fault, the last 64 keys of every row dropped in every layer: "
              f"max |diff| {fault:.3g} (limit {FEATURE_CPU_ATOL:g})")
        if fault <= FEATURE_CPU_ATOL:
            fail("embeddings_ridge: the planted key fault passes the card-vs-CPU check")
        del esm_card, feats, ohe, emb_ridge
        torch.cuda.empty_cache()

        # (d) ProteinNPT through the CLI on the 1,024
        spans = {}
        r = cli_score(torch, cli, root, len(subset), "proteinnpt", "SUP_1024",
                      f"ProteinNPT_{schemes[0]}", [fa.LAUNCHES, ln.LAUNCHES], batch,
                      extra=[f"npt_steps={s['npt_steps']}"],
                      patches=[mock.patch.object(protein_npt, "train", spans_of(
                          torch, spans, "train", protein_npt.train))])
        n_steps = len(schemes) * 5 * s["npt_steps"]
        r["forwards"] = 0
        report_run("d", f"proteinnpt --extra npt_steps={s['npt_steps']}", r, card,
                   f"ProteinNPT_{schemes[0]}", 0, {},
                   detail=f"; training {spans['train']:.2f} s for {n_steps} steps -> "
                   f"{spans['train'] / n_steps * 1e3:.2f} ms a step")
        runs["proteinnpt"] = r
        c = protein_npt.ProteinNptConfig()
        npt_feats = protein_npt.residue_features([apply_mutant(seq, m) for m in subset], length)
        npt_y = np.asarray([y[at[m]] for m in subset])
        npt_aux = sb.standardized_aux(np.asarray([zero_shot[at[m]] for m in subset]))
        prof_c = dataclasses.replace(c, steps=s["profiled_npt_steps"])
        prof_model = protein_npt.init_random(prof_c, seed=1, device=dev)
        _, pwall, busy, n_launch, _ = device_seconds(torch, lambda: protein_npt.train(
            prof_model, prof_c, npt_feats, npt_y, aux=npt_aux, seed=1))
        idle = "not read" if busy is None else f"{1.0 - busy / pwall:.3f}"
        print(f"  (d) {prof_c.steps} steps under the profiler: wall {pwall / prof_c.steps * 1e3:.2f}"
              f" ms a step, device "
              + ("not read" if busy is None else f"{busy / prof_c.steps * 1e3:.2f} ms")
              + f" a step, {n_launch / prof_c.steps:.0f} launches a step, idle share {idle}")
        cpu_m = protein_npt.init_random(c, seed=2, device="cpu")
        card_m = protein_npt.load_state_dict(cpu_m.state_dict(), c, device=dev)
        start = {k: v.clone() for k, v in cpu_m.state_dict().items()}
        draws = list(protein_npt.draw_batches(c, len(npt_y), s["npt_cpu_steps"],
                                              torch.Generator().manual_seed(3)))
        t0 = time.perf_counter()
        cpu_m, _ = protein_npt.train(cpu_m, c, npt_feats, npt_y, aux=npt_aux, draws=draws)
        cpu_s = time.perf_counter() - t0
        on_card = [(i.to(dev), h.to(dev)) for i, h in draws]
        card_m, _ = protein_npt.train(card_m, c, npt_feats, npt_y, aux=npt_aux, draws=on_card)
        want, got = cpu_m.state_dict(), card_m.state_dict()
        live = [k for k in want if not k.endswith(".k.bias")]
        worst = max(float((got[k].cpu() - want[k]).abs().max()) for k in live)
        moved = math.sqrt(sum(float(((want[k] - start[k]) ** 2).sum()) for k in live))
        apart = math.sqrt(sum(float(((got[k].cpu() - want[k]) ** 2).sum()) for k in live))
        print(f"  (d) {s['npt_cpu_steps']} Adam steps, the same draws, card vs CPU ({cpu_s:.1f} s on "
              f"the CPU): {len(live)} parameter tensors, largest |diff| {worst:.3g} (limit "
              f"{NPT_STEP_ATOL:g}), ||card - CPU|| / ||update|| {apart / moved:.3g}")
        if worst > NPT_STEP_ATOL:
            fail(f"proteinnpt: card and CPU parameters differ by {worst:.3g} after "
                 f"{s['npt_cpu_steps']} steps")
        errs["ProteinNPT steps card vs CPU"] = worst
        card_m = protein_npt.load_state_dict(start, c, device=dev)
        card_m, _ = protein_npt.train(card_m, c, npt_feats, npt_y, aux=npt_aux,
                                      draws=[on_card[0]] * len(on_card))
        fault = max(float((card_m.state_dict()[k].cpu() - want[k]).abs().max()) for k in live)
        print(f"  (d) the planted fault, step 0's draws in every step: largest |diff| {fault:.3g}")
        if fault <= NPT_STEP_ATOL:
            fail("proteinnpt: the planted draw fault passes the card-vs-CPU check")
        del cpu_m, card_m, prof_model
        torch.cuda.empty_cache()

        # (e) Kermut through the CLI on the 1,024
        fits, preds, mpnn_t = {}, {}, {}
        r = cli_score(torch, cli, root, len(subset), "kermut", "SUP_1024", f"kermut_{schemes[0]}",
                      [fa.LAUNCHES, ln.LAUNCHES], batch,
                      flags=["--structure-dir", str(root / "pdb")],
                      patches=[capturing(torch, kermut, "fit", fits),
                               capturing(torch, kermut, "predict", preds),
                               capturing(torch, kermut, "conditional_probs_from_mpnn", mpnn_t)])
        r["forwards"] = 0
        report_run("e", "kermut --structure-dir (gp_steps=50, n_orders=2)", r, card,
                   f"kermut_{schemes[0]}", 0, {},
                   detail=f"; the MPNN conditionals {mpnn_t['seconds']:.2f} s, {fits['calls']} "
                   f"fits {fits['seconds']:.2f} s, predictions {preds['seconds']:.2f} s")
        runs["kermut"] = r
        data, train, y_tr = fits["args"]
        steps = fits["kwargs"]["steps"]
        t0 = time.perf_counter()
        h_cpu = kermut.fit(data, train, y_tr, steps=steps, device="cpu")
        p_cpu = kermut.predict(h_cpu, data, train, y_tr, preds["args"][4], device="cpu")
        cpu_s = time.perf_counter() - t0
        names = list(kermut.HYPER_INIT)
        h_card = fits["out"]
        errs["Kermut hyperparameters card vs CPU"] = check_close(
            f"(e) Kermut's {len(names)} hyperparameters, last fold ({len(y_tr)} train), card vs "
            f"CPU ({cpu_s:.1f} s on the CPU)",
            torch.tensor([float(h_card[k]) for k in names]),
            torch.tensor([float(h_cpu[k]) for k in names]), KERMUT_CPU_ATOL, 0.0)
        errs["Kermut predictions card vs CPU"] = check_close(
            f"(e) Kermut's predictions of that fold ({len(p_cpu)}), card vs CPU",
            torch.from_numpy(preds["out"]), torch.from_numpy(p_cpu), KERMUT_CPU_ATOL, 0.0)
        print("  (e) fitted: " + ", ".join(f"{k} {float(h_card[k]):.4g}" for k in names))
        tables = fits["kwargs"]["tables"]
        tables.distance = torch.zeros_like(tables.distance)
        bad = kermut.fit(data, train, y_tr, steps=steps, tables=tables)
        fault = max(abs(float(bad[k]) - float(h_cpu[k])) for k in names)
        print(f"  (e) the planted fault, the distance term dropped: largest |diff| {fault:.3g} "
              f"(limit {KERMUT_CPU_ATOL:g})")
        if fault <= KERMUT_CPU_ATOL:
            fail("kermut: the planted distance fault passes the card-vs-CPU check")
        del fits, preds, tables, bad

        # (f) supervised-score -> merge-supervised -> evaluate-supervised
        sroot = root / "supervised"
        t0 = time.perf_counter()
        if cli.main(["supervised-score", "--model", "OHE_ridge", "--dms-reference",
                     str(root / "reference.csv"), "--dms-dir", str(root / "dms"), "--dms-id",
                     "SUP_L250", "--output-dir", str(sroot), "--device", "cuda"]) != 0:
            fail("supervised-score exited non-zero")
        walls["supervised-score"] = time.perf_counter() - t0
        models = {"OHE_ridge": None, "Emb_ridge": runs["embeddings_ridge"],
                  "ProteinNPT": runs["proteinnpt"], "Kermut": runs["kermut"]}
        prefixes = {"Emb_ridge": "Emb_ridge", "ProteinNPT": "ProteinNPT", "Kermut": "kermut"}
        for name, run in models.items():
            if run is None:
                continue
            with open(run["out"], newline="") as f:
                table_rows = list(csv.DictReader(f))
            for scheme in schemes:
                out = sroot / scheme / name.lower()
                out.mkdir(parents=True, exist_ok=True)
                write_csv_rows(out / run["out"].name, ["mutant", "y_pred", "DMS_score"],
                               [[x["mutant"], x[f"{prefixes[name]}_{scheme}"], x["DMS_score"]]
                                for x in table_rows])
        config = root / "supervised_config.json"
        config.write_text(json.dumps({"model_list_supervised_substitutions_DMS": {
            name: {"input_score_name": "y_pred", "location": name.lower(), "key": "mutant",
                   "label_name": "DMS_score", "model_type": "Supervised"} for name in models}}))
        t0 = time.perf_counter()
        if cli.main(["merge-supervised", "--dms-reference", str(root / "reference.csv"),
                     "--dms-dir", str(root / "dms"), "--scores-root", str(sroot), "--config",
                     str(config), "--output-dir", str(root / "merged"), "--device", "cuda"]) != 0:
            fail("merge-supervised exited non-zero")
        walls["merge-supervised"] = time.perf_counter() - t0
        long_rows = read_table(root / "merged" / "merged_scores_substitutions_DMS.csv")
        if len(long_rows) != 1 + 2 * len(models) * len(schemes):
            fail(f"merge-supervised: {len(long_rows) - 1} long rows, expected "
                 f"{2 * len(models) * len(schemes)}")
        t0 = time.perf_counter()
        if cli.main(["evaluate-supervised", "--dms-reference", str(root / "reference.csv"),
                     "--input-scoring-file", str(root / "merged" /
                                                  "merged_scores_substitutions_DMS.csv"),
                     "--output-dir", str(root / "bench"), "--no-html"]) != 0:
            fail("evaluate-supervised exited non-zero")
        walls["evaluate-supervised"] = time.perf_counter() - t0
        summary = read_table(root / "bench" / "Spearman" /
                             "Summary_performance_DMS_substitutions_Spearman.csv")
        if len(summary) != 1 + len(models):
            fail(f"evaluate-supervised: {len(summary) - 1} ranked models, expected {len(models)}")
        print("  (f) " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
              + f"; {len(long_rows) - 1} long rows, the Spearman leaderboard: "
              + ", ".join(f"{row[1]} {row[3]}" for row in summary[1:]))
    print(f"  [supervised] {time.perf_counter() - phase_t0:.1f} s in all; "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return {"launches": {name: r["launches"] for name, r in runs.items()}, "k4": record}


# the shapes of phase 24: ESM2-650M masked-LM training on 8 rows of phase
# 4's L=250 target (20 AdamW steps, the batch and its masks repeated);
# ProtSSN's surrogate at ProtssnConfig's defaults (node 1,280, hidden 512, 6
# layers, k = 20) on phase 20's target and helix for 100 steps (the JAX
# default), its first 3 steps on the card and the CPU with the same draws;
# ``score --mesh data=1,model=1`` at phase 4's chunk of 16; ring attention
# at B1 H20 T4096 D64 with the last 96 keys masked; ProGen3-3b's widths cut
# to 8 of its 28 layers (time) on 16 singles of phase 14's target; a
# profiled CLI run of ESM2-8M on 24 singles of an L=60 target
PARALLEL_SLICE = dict(train_rows=8, train_steps=20, protssn_steps=100, protssn_cpu_steps=3,
                      protssn_profiled_steps=20, ring=(1, 20, 4096, 64), ring_masked=96,
                      mesh_bias_std=0.05, progen3_layers=8, progen3_rows=16, profile_length=60,
                      profile_mutants=24)
# (a) one bf16 AdamW step against the same step computed in float32 on the
# card, same batch and masks: the disagreement sum |g32| |d16 - d32| / sum
# |g32| |d32| over every parameter (d an update, g32 the float32 step's
# gradient). Adam's first step is about lr sign(g), so an entry whose
# gradient is within bf16 noise of 0 steps the other way; weighting by |g32|
# counts it by the little gradient it carries. Readings of a chip run of
# this phase on an H100 at 700 W: 2.9e-5; the loss taken over the unmasked
# positions (the planted fault) 8.5e-2, its update still agreeing where the
# LM head's and the embeddings' large gradients point alike
ESM_TRAIN_DISAGREE_TOL = 1e-3
# (b) ProtSSN's first 3 Adam steps (lr 1e-3) card against CPU on the same
# draws: the first loss (float32 sums in other orders) and the update
# disagreement of (a) with the CPU's last gradient as the weight. At
# ProtssnConfig's defaults the JAX package's own losses from its init run
# to ~1e7-1e9 (tests/test_torch_protssn_train.py holds the port's first
# two against them on the CPU), so float32 noise flips many small-gradient
# entries' Adam steps (a per-entry bound would be 2 lr a step) and each
# step carries the flips of the one before. Readings of 3 steps on an H100
# at 700 W: disagreement 1.24e-2, other draws on the card (the planted
# fault) 0.70; the gate sits between the two
PROTSSN_LOSS_RTOL, PROTSSN_DISAGREE_TOL = 1e-5, 0.1
# (c) ``score --mesh data=1,model=1`` against phase 4's scores of the same
# assay without --mesh, card against card, bf16. The sharded layers run
# Megatron's row-parallel path at every model size: out_proj's and fc2's
# bias-free product, summed over the group (of one here), then the bias.
# ``F.linear`` of a (B, T, D) input is a product and then a bias add too,
# so the two paths run the same bf16 operations. Readings of a chip run on
# an H100 at 700 W: max |diff| 0; a doubled all-reduce (the planted
# fault) 0.105
MESH_SCORES_ATOL = 1e-6
# (c) the same on seeded nonzero biases (std 0.05) in every layer, the
# sharded model's scores against the unsharded model's, bf16: the
# row-parallel bias is added to the product's bf16 result after the sum,
# the unsharded layer's inside the product, so a few outputs a layer round
# one bf16 ulp apart, which 33 layers carry to ~4e-2 in a log-prob (as
# TABLE_ATOL allows) and twice that in a score, a difference of two.
# Readings of a chip run on an H100 at 700 W: 7.73e-2; the bias added twice
# (the planted fault) 0.59; the gate sits between the two
MESH_BIAS_ATOL = 0.2
# (e) the expert-parallel forward against ProGen3.forward on one rank:
# float32 logits, the one-rank all-reduce an identity
EXPERT_LOGITS_ATOL = 1e-5
# the symbol of K4's bf16 loop in a torch.profiler trace
K4_SYMBOL = "hopper_attention_kernel"


def update_disagreement(start, d16_model, d32_model):
    """sum |g32| |d16 - d32| / sum |g32| |d32| over every parameter of two
    trainers' models that started at ``start`` (float64 sums on the
    reference's device), with d32_model the reference and g32 its last
    gradient. A master cast at use is named by its parametrization
    (``...q_proj.parametrizations.weight.original``); it is matched by the
    plain name."""
    num = den = 0.0
    p16 = {n.replace(".parametrizations.", ".").replace(".original", ""): p
           for n, p in d16_model.named_parameters()}
    for name, p32 in d32_model.named_parameters():
        w = p32.grad.double().abs()
        d32 = p32.detach().double() - start[name]
        d16 = p16[name].detach().to(p32.device).double() - start[name]
        num += float((w * (d16 - d32).abs()).sum())
        den += float((w * d32.abs()).sum())
    return num / den


def phase_parallel(torch, dev, card, fa, check_close, esm_run):
    """24. The last slice: (a) ESM2-650M masked-LM training (``esm_train``,
    bf16 compute on float32 masters, AdamW, the plain attention): 20 steps
    on a repeated batch of 8 x 252 tokens (ms a step, tokens/s, peak
    memory, the loss falling), one bf16 step's update against the same step
    in float32 on the card (``update_disagreement``), the loss taken over
    the unmasked positions shown to fail that check; (b) ProtSSN's
    ``train_denoising`` at ProtssnConfig's defaults on phase 20's helix with
    ESM2-650M embeddings (33 K4 + 33 rope_qk) for 100 steps (ms a step,
    idle share of 20 profiled steps, final loss), 3 steps card vs CPU
    with the same draws, other draws shown to fail; (c) ``score --mesh
    data=1,model=1`` through the CLI on phase 4's assay over a one-rank
    NCCL group (a FileStore): the scores against phase 4's without --mesh
    to ``MESH_SCORES_ATOL``, K4's launches under ``esm_mesh``, a doubled
    all-reduce shown to fail; (d) ring attention on the one-rank group at B1 H20 T4096 D64
    against the plain attention, the key mask dropped shown to fail; (e)
    ProGen3's expert-parallel forward at progen3-3b's widths (8 of 28
    layers) against ``ProGen3.forward``, the float32 K1's launches under
    ``progen3_expert``, experts held at the wrong indices shown to fail;
    (f) ``score --profile-dir`` on ESM2-8M: the trace names K4's loop, a
    run with the plain attention shown to fail that check. The records
    ``grouped_attention_bthd:esm_mesh`` and
    ``grouped_attention:f32_progen3_expert``."""
    from proteingym_tpu_torch.ops import layer_norm as ln
    import torch.distributed as dist

    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
    from proteingym_tpu_torch.devices import no_tf32
    from proteingym_tpu_torch.models import esm2, esm_scoring, esm_train, progen3, protssn
    from proteingym_tpu_torch.ops import gnn
    from proteingym_tpu_torch.ops.ring_attention import ring_attention
    from proteingym_tpu_torch.parallel import mesh as pmesh
    from proteingym_tpu_torch.pipeline import cli

    s = PARALLEL_SLICE
    phase_t0 = time.perf_counter()
    seq, mutants, scores_250, chunk = esm_run
    config = esm2.PRESETS["esm2_t33_650M"]
    print(f"[parallel] phase 24: ESM2-650M training, ProtSSN's denoising trainer, score "
          f"--mesh, ring attention, expert-parallel ProGen3-3b (8 of 28 layers: depth cut for "
          f"time), score --profile-dir ({card})")
    launches = {}

    def reset():
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        ln.LAUNCHES["layer_norm"] = 0

    # (a) masked-LM training of ESM2-650M
    t0 = time.perf_counter()
    model = esm2.init_random(config, seed=0, device=dev)  # the CLI preset's weights
    rs = np.random.RandomState(24)
    rows = [seq] + ["".join(AA[i] for i in rs.randint(0, 20, len(seq)))
                    for _ in range(s["train_rows"] - 1)]
    tokens = torch.as_tensor(np.stack([esm2.ALPHABET.tokenize(r) for r in rows]),
                             dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev)
    init, step = esm_train.make_train_step(config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init(model)
    reset()
    losses, times = [], []
    for _ in range(s["train_steps"]):
        gen.manual_seed(7)  # the repeated batch: the same masks each step
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(state, tokens, generator=gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches["esm_train"] = {**fa.LAUNCHES, **ln.LAUNCHES}
    check_launches("esm_train (the plain attention)", launches["esm_train"], {})

    def two_steps():
        for _ in range(2):
            gen.manual_seed(7)
            step(state, tokens, generator=gen)
        return 2
    prof = profile_forwards(torch, fa, two_steps)
    losses = [float(x) for x in losses]
    step_ms = statistics.median(times[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  (a) esm_train on {tuple(tokens.shape)} tokens, bf16 compute on float32 masters, "
          f"AdamW (lr 1e-4, wd 1e-4): {step_ms:.2f} ms a step (median of steps 2-"
          f"{s['train_steps']}; the first {times[0] * 1e3:.1f} ms), "
          f"{tokens.numel() / step_ms * 1e3:.0f} tokens/s, peak device memory {peak:.2f} GiB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({card})")
    if prof is not None:
        print(f"      two steps under torch.profiler: idle share {prof['idle']:.1%}, device "
              f"{prof['ms']:.2f} ms a step, GEMMs {prof['gemm']:.1%}; the costliest kernels: "
              f"{prof['top']}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] - 0.1):
        fail(f"(a) the loss did not fall on the repeated batch: {losses}")
    del state
    torch.cuda.empty_cache()

    gen.manual_seed(11)
    masked = esm_train.mask_batch(gen, tokens)
    start = {n: p.detach().double() for n, p in model.named_parameters()}
    init32, step32 = esm_train.make_train_step(dataclasses.replace(config, dtype=torch.float32))
    s32 = init32(model)
    loss32 = float(step32(s32, tokens, masked=masked))
    s16 = init(model)
    loss16 = float(step(s16, tokens, masked=masked))
    dis = update_disagreement(start, s16.model, s32.model)
    del s16
    torch.cuda.empty_cache()
    special = (tokens == esm2.ALPHABET.cls_idx) | (tokens == esm2.ALPHABET.eos_idx)
    faulty = init(model)
    step(faulty, tokens, masked=(masked[0], ~masked[1] & ~special))  # planted fault
    dis_fault = update_disagreement(start, faulty.model, s32.model)
    del faulty, s32, start
    torch.cuda.empty_cache()
    print(f"  (a) one step bf16 vs float32 on the card, same batch and masks: losses {loss16:.6f} "
          f"/ {loss32:.6f}, update disagreement {dis:.4g} (gate {ESM_TRAIN_DISAGREE_TOL:g}); "
          f"the loss over the unmasked positions (planted fault) {dis_fault:.4g}")
    if not dis <= ESM_TRAIN_DISAGREE_TOL:
        fail(f"(a) the bf16 step's update disagrees with float32's: {dis:.4g}")
    if not dis_fault > ESM_TRAIN_DISAGREE_TOL:
        fail(f"(a) the planted fault passed the update check: {dis_fault:.4g}")
    t_a = time.perf_counter() - t0

    # (b) ProtSSN's denoising trainer
    t0 = time.perf_counter()
    length = TRANCEPTION_SLICE["length"]
    codes = np.random.RandomState(13).randint(1, 21, length)  # phase 14's target
    target = "".join(GAP_AA[c] for c in codes)
    helix = synthetic_helix_backbone(length, seed=20)  # phase 20's helix
    helix[:, 1] += STRUCTURE_SLICE["ca_noise"] * np.random.RandomState(20).randn(length, 3)
    ca = helix[:, 1].astype(np.float32)
    native = np.asarray([AA.index(c) for c in target])
    reset()
    emb = protssn.esm_embeddings(model, target)
    launches["protssn_train"] = {**fa.LAUNCHES, **ln.LAUNCHES}
    check_launches("protssn_train (the embeddings)", launches["protssn_train"],
                   {"grouped_attention_bthd": config.num_layers, "rope_qk": config.num_layers})
    pc = protssn.ProtssnConfig()
    net = protssn.init_params(pc, seed=0, device=dev)
    first = {k: v.clone() for k, v in net.state_dict().items()}
    with no_tf32():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        protssn.train_denoising(net, pc, emb, ca, native, steps=s["protssn_steps"], seed=0)
        wall = time.perf_counter() - t1
        _, pwall, busy, _, _ = device_seconds(torch, lambda: protssn.train_denoising(
            net, pc, emb, ca, native, steps=s["protssn_profiled_steps"], seed=1))
    first_loss, final_loss = float(net.losses[0]), float(net.losses[-1])
    idle = "not measured" if busy is None else f"{1 - busy / pwall:.1%}"
    print(f"  (b) train_denoising at node {pc.node_dim}, hidden {pc.hidden_dim}, "
          f"{pc.num_layers} layers, k {pc.k_neighbors}, L={length}: {s['protssn_steps']} steps "
          f"in {wall:.2f} s ({wall / s['protssn_steps'] * 1e3:.2f} ms a step), idle share "
          f"{idle} over {s['protssn_profiled_steps']} profiled steps; loss {first_loss:.1f} -> "
          f"{final_loss:.1f} after {s['protssn_steps']} steps, least "
          f"{float(net.losses.min()):.1f} ({card})")
    # the JAX init (He-normal in every layer) grows the surrogate's features
    # through 6 residual layers: the JAX package's own losses at these
    # widths run to ~1e7-1e9 on the CPU (tests/test_torch_protssn_train.py)
    # and Adam at lr 1e-3 does not settle within 100 steps, so a falling loss
    # is not asked, a finite one is
    if not np.isfinite(net.losses).all():
        fail(f"(b) non-finite denoising losses: {net.losses}")
    draws = np.random.RandomState(25).rand(s["protssn_cpu_steps"], length, 1) < 0.25
    other = np.random.RandomState(26).rand(s["protssn_cpu_steps"], length, 1) < 0.25
    results = {}
    for where, noise in (("card", draws), ("cpu", draws), ("fault", other)):
        m = gnn.egnn_load_state_dict(first, pc.egnn(), device="cpu" if where == "cpu" else dev)
        with no_tf32():
            protssn.train_denoising(m, pc, emb if where != "cpu" else emb.cpu(), ca, native,
                                    steps=s["protssn_cpu_steps"], noise=noise)
        results[where] = m
    start = {k: v.cpu().double() for k, v in first.items()}
    loss_rel = abs(float(results["card"].losses[0]) - float(results["cpu"].losses[0])) \
        / abs(float(results["cpu"].losses[0]))
    dis = update_disagreement(start, results["card"], results["cpu"])
    dis_fault = update_disagreement(start, results["fault"], results["cpu"])
    worst = params_against(results["card"], results["cpu"], start, WAVENET_CPU_ATOL)
    print(f"  (b) {s['protssn_cpu_steps']} step(s) card vs CPU, same draws: first loss within "
          f"{loss_rel:.3g} relative (rtol {PROTSSN_LOSS_RTOL:g}; losses card "
          f"{results['card'].losses.tolist()}, CPU {results['cpu'].losses.tolist()}), update "
          f"disagreement {dis:.4g} (gate {PROTSSN_DISAGREE_TOL:g}; per tensor: "
          f"{held_to(worst, WAVENET_CPU_ATOL, WAVENET_CPU_MAX)[0]}); other draws on the card "
          f"(planted fault) {dis_fault:.4g}")
    if not (loss_rel <= PROTSSN_LOSS_RTOL and dis <= PROTSSN_DISAGREE_TOL):
        fail("(b) ProtSSN's trainer on the card disagrees with the CPU")
    if not dis_fault > PROTSSN_DISAGREE_TOL:
        fail("(b) the planted fault passed the card-vs-CPU check")
    del results, net
    t_b = time.perf_counter() - t0

    # (c) score --mesh data=1,model=1 through the CLI on a one-rank NCCL group
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, [("SYNTH_L250", seq, mutants)])
        reset()
        t1 = time.perf_counter()
        rc = cli.main(["score", "--model", "esm", "--checkpoint", "esm2_t33_650M",
                       "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
                       "--output-dir", str(root / "out"), "--batch-size", str(chunk),
                       "--device", "cuda", "--quiet", "--fail-fast", "--mesh", "data=1,model=1"])
        mesh_wall = time.perf_counter() - t1
        if rc != 0:
            fail(f"score --mesh exited {rc}")
        launches["esm_mesh"] = {**fa.LAUNCHES, **ln.LAUNCHES}
        meshed = read_scores(root / "out" / "SYNTH_L250.csv", "esm2_t33_650M_score",
                             len(mutants))
    n_fwd = n_chunk_forwards(len(seq), chunk)
    check_launches("esm_mesh", launches["esm_mesh"],
                   {"grouped_attention_bthd": config.num_layers * n_fwd,
                    "rope_qk": config.num_layers * n_fwd})
    mesh = pmesh.make_mesh(1, 1, device=dev)
    diff = float(np.abs(meshed - scores_250).max())
    sharded = esm2.make_sharded_apply_fn(model, mesh)
    toks = esm2.ALPHABET.tokenize(seq)
    with mock.patch.object(esm2, "reduce_from_group", lambda x, group: 2 * x):  # planted
        table = esm_scoring.masked_marginal_table(sharded, toks, chunk=chunk,
                                                  window=config.max_positions, pad_to_multiple=64)
    fault_diff = float(np.abs(esm_scoring.score_mutants_from_table(table, mutants, seq)
                              - scores_250).max())
    print(f"  (c) score --mesh data=1,model=1 (NCCL, world {dist.get_world_size()}, "
          f"{dist.get_backend()}): {len(meshed)} scores in {mesh_wall:.2f} s, against phase "
          f"4's without --mesh max |diff| {diff:.3g} (atol {MESH_SCORES_ATOL:g}); launches "
          f"{launches['esm_mesh']}; a doubled all-reduce (planted fault) {fault_diff:.3g}")
    if not diff <= MESH_SCORES_ATOL:
        fail(f"(c) score --mesh differs from the unsharded scores by {diff:.3g}")
    if not fault_diff > MESH_SCORES_ATOL:
        fail("(c) the planted fault passed the mesh check")
    # the preset's biases are 0, which hides where a row-parallel layer adds
    # its bias: the same scores with seeded nonzero biases in every layer,
    # through the sharded and the unsharded model
    with torch.no_grad():
        bgen = torch.Generator(device=dev).manual_seed(24)
        for name, p in model.named_parameters():
            if name.startswith("layers.") and name.endswith(".bias"):
                p.copy_(s["mesh_bias_std"] * torch.randn(p.shape, generator=bgen, device=dev))

    def biased_scores(fn):
        t = esm_scoring.masked_marginal_table(fn, toks, chunk=chunk, window=config.max_positions,
                                              pad_to_multiple=64)
        return esm_scoring.score_mutants_from_table(t, mutants, seq)
    want_b = biased_scores(model)
    bias_diff = float(np.abs(biased_scores(esm2.make_sharded_apply_fn(model, mesh))
                             - want_b).max())
    with mock.patch.object(esm2, "_row_parallel",  # planted: the bias inside the summed product
                           lambda x, lin, m: esm2.reduce_from_group(lin(x), m.model_group)
                           + lin.bias):
        bias_fault = float(np.abs(biased_scores(esm2.make_sharded_apply_fn(model, mesh))
                                  - want_b).max())
    print(f"  (c) with seeded biases (std {s['mesh_bias_std']:g}) in every layer, the sharded "
          f"model against the unsharded: max |diff| {bias_diff:.3g} (atol "
          f"{MESH_BIAS_ATOL:g}); the bias added twice (planted fault) {bias_fault:.3g}")
    if not bias_diff <= MESH_BIAS_ATOL:
        fail(f"(c) with biases the sharded model differs by {bias_diff:.3g}")
    if not bias_fault > MESH_BIAS_ATOL:
        fail("(c) the planted bias fault passed the mesh check")
    del sharded, table, model
    torch.cuda.empty_cache()
    t_c = time.perf_counter() - t0

    # (d) ring attention on the one-rank group
    t0 = time.perf_counter()
    b, h, tt, d = s["ring"]
    rgen = torch.Generator(device=dev).manual_seed(tt)
    q, k, v = (torch.randn(b, h, tt, d, generator=rgen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    key_mask = torch.ones(b, tt, dtype=torch.bool, device=dev)
    key_mask[:, -s["ring_masked"]:] = False
    got = ring_attention(q, k, v, key_mask=key_mask)
    torch.cuda.synchronize()
    want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=key_mask)
    ring_err = check_close(f"(d) ring B{b} H{h} T{tt} D{d} bf16, mask", got, want,
                           BF16_ATOL, BF16_RTOL)
    unmasked = ring_attention(q, k, v)  # the planted fault: the key mask dropped
    fault_err = float((unmasked.float() - want).abs().max())
    if not bool(((unmasked.float() - want).abs() > BF16_ATOL + BF16_RTOL * want.abs()).any()):
        fail("(d) the planted fault passed the ring check")
    del want, unmasked
    rt = median_pair(torch, {
        "ring": lambda: ring_attention(q, k, v, key_mask=key_mask),
        "plain": lambda: fa.plain_mha(q, k, v, key_mask=key_mask),
    }, reps=3, inner=2, rounds=1)
    print(f"  (d) ring attention, one rank: {rt['ring']:.3f} ms (float32 fold), plain "
          f"{rt['plain']:.3f} ms; the key mask dropped (planted fault) max |diff| "
          f"{fault_err:.3g} ({card})")
    del q, k, v, got
    torch.cuda.empty_cache()
    t_d = time.perf_counter() - t0

    # (e) the expert-parallel ProGen3 forward
    t0 = time.perf_counter()
    pcfg = dataclasses.replace(progen3.PRESETS["progen3-3b"], num_layers=s["progen3_layers"])
    pg = progen3.init_random(pcfg, seed=0, device=dev)
    singles = [f"{target[p]}{p + 1}{a}" for p in range(0, length, 16) for a in "AW"
               if a != target[p]][:s["progen3_rows"]]
    tok = progen3.ProGen3Tokenizer()
    from proteingym_tpu_torch.data.mutants import apply_mutant
    ptoks = torch.as_tensor(np.stack([tok.encode_clm(apply_mutant(target, m))
                                      for m in singles]), dtype=torch.long, device=dev)
    with torch.no_grad(), no_tf32():
        dense = pg(ptoks)
        reset()
        got = progen3.expert_sharded_apply(pg, ptoks)
        torch.cuda.synchronize()
        launches["progen3_expert"] = {**fa.LAUNCHES, **ln.LAUNCHES}
        moe = pg.model.layers[0].block_sparse_moe
        held = moe.experts
        # the planted fault: the experts held at the wrong routing indices
        moe.experts = torch.nn.ModuleList(list(held)[::-1])
        wrong = pg(ptoks)
        moe.experts = held
    check_launches("progen3_expert", launches["progen3_expert"],
                   {"grouped_attention": pcfg.num_layers})
    ediff = float((got - dense).abs().max())
    efault = float((wrong - dense).abs().max())
    print(f"  (e) expert_sharded_apply ({pcfg.num_experts} experts over a group of "
          f"{dist.get_world_size()}, {pcfg.num_layers} of 28 layers at hidden "
          f"{pcfg.hidden_dim}, FFN {pcfg.ffn_dim}) on {tuple(ptoks.shape)} tokens against "
          f"ProGen3.forward: max |diff| {ediff:.3g} (atol {EXPERT_LOGITS_ATOL:g}); launches "
          f"{launches['progen3_expert']}; experts at the wrong indices (planted fault) "
          f"{efault:.3g}")
    if not ediff <= EXPERT_LOGITS_ATOL:
        fail(f"(e) the expert-parallel forward differs by {ediff:.3g}")
    if not efault > EXPERT_LOGITS_ATOL:
        fail("(e) the planted fault passed the expert check")
    t_shape = ptoks.shape[1]
    del pg, dense, got, wrong
    torch.cuda.empty_cache()
    k1 = f32_k1_record(torch, dev, fa, card, ("progen3_expert", s["progen3_rows"],
                                              pcfg.num_heads, t_shape, pcfg.head_dim), "e")
    t_e = time.perf_counter() - t0

    # (f) score --profile-dir
    t0 = time.perf_counter()
    pseq, pmuts = synth_assay(s["profile_length"], 5)
    pmuts = pmuts[::len(pmuts) // s["profile_mutants"]][:s["profile_mutants"]]
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, [("PROF", pseq, pmuts)])
        for tag, patches in (("kernel", ()), ("plain", (mock.patch.object(
                esm2, "mha_natural", fa.plain_mha_bthd),))):
            reset()
            with contextlib.ExitStack() as stack:
                for p in patches:
                    stack.enter_context(p)
                rc = cli.main(["score", "--model", "esm", "--checkpoint", "esm2_t6_8M",
                               "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
                               "--output-dir", str(root / f"out_{tag}"), "--batch-size", "16",
                               "--device", "cuda", "--quiet", "--fail-fast", "--profile-dir",
                               str(root / f"tb_{tag}")])
            if rc != 0:
                fail(f"score --profile-dir exited {rc}")
            if tag == "kernel":
                launches["esm_profile"] = {**fa.LAUNCHES, **ln.LAUNCHES}
            traces = list((root / f"tb_{tag}").glob("*.pt.trace.json"))
            if len(traces) != 1:
                fail(f"(f) {len(traces)} trace files in --profile-dir, expected 1")
            events = json.loads(traces[0].read_text())["traceEvents"]
            found[tag] = sum(K4_SYMBOL in str(e.get("name", "")) for e in events)
            found[f"{tag}_mb"] = traces[0].stat().st_size / 2**20
    small = esm2.PRESETS["esm2_t6_8M"]
    n_fwd = n_chunk_forwards(len(pseq), 16)
    check_launches("esm_profile", launches["esm_profile"],
                   {"grouped_attention_bthd": small.num_layers * n_fwd,
                    "rope_qk": small.num_layers * n_fwd})
    print(f"  (f) score --profile-dir: a {found['kernel_mb']:.2f} MiB Chrome trace naming "
          f"{K4_SYMBOL} {found['kernel']} times ({small.num_layers} x {n_fwd} launches); with "
          f"the plain attention (planted fault) {found['plain']} times")
    if found["kernel"] == 0:
        fail(f"(f) the trace does not name {K4_SYMBOL}")
    if found["plain"] != 0:
        fail("(f) the planted fault passed the trace check")
    t_f = time.perf_counter() - t0

    record = k4_record(torch, dev, fa, card, ("esm_mesh", chunk, config.num_heads,
                                              K4_TIMED[0][2], config.head_dim), "c")
    pmesh.shutdown()
    print(f"  [parallel] {time.perf_counter() - phase_t0:.1f} s in all: (a) {t_a:.1f} s, "
          f"(b) {t_b:.1f} s, (c) {t_c:.1f} s, (d) {t_d:.1f} s, (e) {t_e:.1f} s, (f) "
          f"{t_f:.1f} s; ring err {ring_err:.3g}")
    return {"launches": launches, "k4": record, "k1": k1}


def main() -> int:
    script_t0 = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this check runs only on a GPU "
             "(there is no CPU fallback)")
    if not (REPO / "proteingym_tpu_torch").is_dir():
        fail(f"{REPO} is not a checkout of the repository "
             "(proteingym_tpu_torch/ is missing)")
    sys.path.insert(0, str(REPO))

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(card)
    from proteingym_tpu_torch.ops import _build
    from proteingym_tpu_torch.ops import flash_attention as fa
    from proteingym_tpu_torch.ops import layer_norm as ln

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, triton {triton_version}, "
          f"nvcc: {nvcc[-1] if nvcc else 'not read'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"[build] {', '.join(SOURCES)} ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc, in parallel: " + ", ".join(
              f"{n} {_build.BUILD_SECONDS.get(n, 0.0):.2f} s" for n in SOURCES) + ")")
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())

    # ---- 3. kernel vs plain ----------------------------------------------
    print("[kernel] grouped_attention vs plain reference_mha on the card")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, t, d, dtype=torch.bfloat16):
        # (B, T, H, D) memory seen as (B, H, T, D), as the model hands it in
        mk = lambda: torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
        return tuple(x.permute(0, 2, 1, 3) for x in (mk(), mk(), mk()))

    def lengths_mask(b, t, lengths):
        return torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]

    def compare(name, q, k, v, atol=BF16_ATOL, rtol=BF16_RTOL, **kw):
        got = fa.grouped_mha(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
        if "segment_ids" in kw:  # live rows: padding rows are never consumed
            live = kw["segment_ids"] > 0
            got, want = got.transpose(1, 2)[live], want.transpose(1, 2)[live]
        return check_close(name, got, want, atol, rtol)

    errs = []
    b, h, t, d = 16, 20, 256, 64
    q, k, v = qkv(b, h, t, d)
    mask = lengths_mask(b, t, [252 - 3 * i for i in range(b)])
    headline = dict(key_mask=mask, rope_base=10000.0)
    errs.append(compare("headline B16 H20 T256 D64 mask+rope", q, k, v, **headline))
    q4, k4, v4 = qkv(4, 20, 1024, 64)
    errs.append(compare("T1024 mask+rope", q4, k4, v4,
                        key_mask=lengths_mask(4, 1024, [1024, 1000, 700, 513]),
                        rope_base=10000.0))
    qs, ks, vs = qkv(2, 4, 300, 64)
    seg = torch.zeros(2, 300, dtype=torch.int32, device=dev)
    seg[0, :90], seg[0, 90:200], seg[0, 200:290] = 1, 2, 3
    seg[1, :150], seg[1, 150:260] = 1, 2
    errs.append(compare("segmented mask+rope", qs, ks, vs, key_mask=seg > 0,
                        segment_ids=seg, rope_base=10000.0))
    errs.append(compare("segmented", qs, ks, vs, key_mask=seg > 0, segment_ids=seg))
    qc, kc, vc = qkv(2, 8, 200, 64)
    errs.append(compare("causal", qc, kc, vc, causal=True))
    qa, ka, va = qkv(1, 20, 384, 64)
    slopes = 2.0 ** (-8.0 * torch.arange(1, 21, device=dev) / 20)
    alibi = slopes[:, None] * torch.arange(384, device=dev)[None, :]  # >= 0, up to ~290
    errs.append(compare("ALiBi bias + causal", qa, ka, va, bias=alibi, causal=True))
    qm, km, vm = qkv(2, 4, 100, 32)
    dead = torch.ones(2, 100, dtype=torch.bool, device=dev)
    dead[1] = False  # every key of batch row 1 masked
    errs.append(compare("fully masked row, ragged T=100", qm, km, vm, key_mask=dead))
    for hd in fa.HEAD_DIMS:  # each head dim has its own TMA box and swizzle
        qd, kd, vd = qkv(2, 4, 77, hd)
        errs.append(compare(f"head dim {hd}, T=77 mask+rope", qd, kd, vd,
                            key_mask=lengths_mask(2, 77, [77, 60]), rope_base=10000.0))
        qd, kd, vd = qkv(2, 4, 1037, hd)
        dead = lengths_mask(2, 1037, [1037, 1037])
        dead[1, :150] = False  # rows 0..149 of batch row 1 see no live key
        errs.append(compare(f"head dim {hd}, T=1037 causal, rows with no live key", qd, kd, vd,
                            key_mask=dead, causal=True))
    qf, kf, vf = qkv(2, 4, 100, 32, dtype=torch.float32)
    errs.append(compare("float32 T=100 mask+rope", qf, kf, vf, atol=F32_ATOL,
                        rtol=F32_RTOL, key_mask=lengths_mask(2, 100, [100, 81]),
                        rope_base=10000.0))
    max_abs_err = max(errs)

    t = median_pair(torch, {
        "plain": lambda: fa.plain_mha(q, k, v, **headline),
        "kernel": lambda: fa.grouped_mha(q, k, v, **headline),
    }, reps=5, inner=10, rounds=3)
    ms, plain_ms = t["kernel"], t["plain"]
    print(f"  headline time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(medians of 30 samples of 10 queued calls, {card})")

    # ---- 4. slice: ESM2-650M, L=250, all single mutants --------------------
    from proteingym_tpu_torch.models import esm2, esm_scoring
    from proteingym_tpu_torch.pipeline import cli

    print("[slice] score --model esm --checkpoint esm2_t33_650M, L=250")
    seq, mutants = synth_assay(250, 0)
    seq_long, mutants_long = synth_assay(1100, 1)
    config = esm2.PRESETS["esm2_t33_650M"]
    chunk = 16
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, [("SYNTH_L250", seq, mutants)])
        torch.cuda.reset_peak_memory_stats()
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        ln.LAUNCHES["layer_norm"] = 0
        t0 = time.perf_counter()
        run_cli(cli, ref, dms_dir, root / "out", "esm2_t33_650M", chunk)
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **ln.LAUNCHES}
        scores = read_scores(root / "out" / "SYNTH_L250.csv",
                             "esm2_t33_650M_score", len(mutants))
    n_fwd = n_chunk_forwards(250, chunk)
    expected = config.num_layers * n_fwd
    print(f"  {len(scores)} finite scores; CLI wall {wall:.2f} s incl. weight init; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches {launches} (expected {config.num_layers} layers x {n_fwd} "
          f"forwards = {expected} of K4 and of its rope_qk pre-pass, "
          f"{esm_norms(config)} x {n_fwd} of the layer norm)")
    check_launches("esm slice", launches, {"grouped_attention_bthd": expected,
                                           "rope_qk": expected,
                                           "layer_norm": esm_norms(config) * n_fwd})

    model = esm2.init_random(config, seed=0, device=dev)
    tokens = esm2.ALPHABET.tokenize(seq)

    def table_and_scores():
        table = esm_scoring.masked_marginal_table(
            model, tokens, chunk=chunk, window=config.max_positions,
            pad_to_multiple=64)
        return table, esm_scoring.score_mutants_from_table(table, mutants, seq)

    table, rescored = table_and_scores()  # warm
    if not np.allclose(rescored, scores, atol=1e-5):
        fail("scores recomputed outside the CLI differ from the CLI's")
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table_and_scores()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    table_s = statistics.median(runs)
    print(f"  table + scores: {table_s:.4f} s median of 3 -> "
          f"{len(mutants) / table_s:.2f} mutants/s ({card})")

    with mock.patch.object(esm2, "mha_natural", fa.plain_mha_bthd):
        table_plain = esm_scoring.masked_marginal_table(
            model, tokens, chunk=32, window=config.max_positions,
            pad_to_multiple=64)
    check_close("table, all 252 rows, kernel vs plain attention",
                table, table_plain, TABLE_ATOL, 0.0)
    del model, table, table_plain
    torch.cuda.empty_cache()

    # ---- 5. windowed path: esm2_t6_8M at L=1100 ---------------------------
    print("[windowed] score --model esm --checkpoint esm2_t6_8M, L=1100")
    small = esm2.PRESETS["esm2_t6_8M"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ref, dms_dir = write_assays(root, [("SYNTH_L1100", seq_long, mutants_long)])
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        ln.LAUNCHES["layer_norm"] = 0
        run_cli(cli, ref, dms_dir, root / "out", "esm2_t6_8M", chunk)
        win_launches = {**fa.LAUNCHES, **ln.LAUNCHES}
        read_scores(root / "out" / "SYNTH_L1100.csv", "esm2_t6_8M_score",
                    len(mutants_long))
    n_fwd_long = n_chunk_forwards(1100, chunk)
    expected_long = small.num_layers * n_fwd_long
    print(f"  {len(mutants_long)} finite scores; launches {win_launches} "
          f"(expected {small.num_layers} x {n_fwd_long} = {expected_long} of K4 and of rope_qk, "
          f"{esm_norms(small)} x {n_fwd_long} of the layer norm)")
    check_launches("windowed", win_launches, {"grouped_attention_bthd": expected_long,
                                              "rope_qk": expected_long,
                                              "layer_norm": esm_norms(small) * n_fwd_long})

    phase_s = {"1-5": time.perf_counter() - script_t0}

    def timed(name, phase, *args):
        t = time.perf_counter()
        result = phase(*args)
        phase_s[name] = time.perf_counter() - t
        return result

    k5 = timed("cluster_counts", phase_cluster_counts, torch, dev, card)
    norm = timed("layer_norm", phase_layer_norm, torch, dev, card)
    k2 = timed("long_attention", phase_long_attention, torch, dev, card, fa, qkv, lengths_mask,
               check_close)
    poet_run = timed("poet", phase_poet, torch, dev, card, fa, check_close)
    k3_k4 = timed("k3_k4", phase_k3_k4, torch, dev, card, fa, qkv, lengths_mask, check_close)
    packed = timed("packed", phase_packed, torch, card, fa, cli, esm2, scores)
    seg_packed = timed("segment_packed", phase_segment_packed, torch, dev, card, fa, esm2,
                       check_close, packed["scores"])
    wt = timed("wt_pppl", phase_wt_pppl, torch, dev, card, fa, cli, esm2, esm_scoring,
               (seq, mutants, scores, chunk))
    timed("evaluate_real", phase_merge_evaluate_real, cli, wt)
    timed("evaluate_scale", phase_evaluate_scale, torch, dev, card, cli)
    timed("clinical", phase_clinical, cli)
    msa_run = timed("msa_transformer", phase_msa_transformer, torch, dev, card, fa, check_close)
    tr_run = timed("tranception", phase_tranception, torch, dev, card, fa, check_close)
    indel_run = timed("indels", phase_indels, torch, dev, card, fa, check_close)
    trainers = timed("trainers", phase_trainers, torch, dev, card, fa)
    baselines = timed("baselines", phase_baselines, torch, dev, card, fa)
    zoo = timed("zoo", phase_zoo, torch, dev, card, fa, check_close)
    mlm = timed("mlm", phase_mlm, torch, dev, card, fa, check_close)
    structure = timed("structure", phase_structure, torch, dev, card, fa, check_close)
    plms = timed("structure_plms", phase_structure_plms, torch, dev, card, fa, check_close)
    slice_c = timed("slice_c", phase_slice_c, torch, dev, card, fa, check_close)
    supervised = timed("supervised", phase_supervised, torch, dev, card, fa, check_close)
    parallel = timed("parallel", phase_parallel, torch, dev, card, fa, check_close,
                     (seq, mutants, scores, chunk))
    print("[time] seconds by phase (the build and phases 1-5 as one): "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; {time.perf_counter() - script_t0:.1f} s in all so far ({card})")

    if "jax" in sys.modules:
        fail("the port imported jax")
    # the guard below covers the modules of every phase, phases 15-24's too
    missing = [m for m in ("proteingym_tpu_torch.native", "proteingym_tpu_torch.models.hmm",
                           "proteingym_tpu_torch.models.potts",
                           "proteingym_tpu_torch.models.wavenet",
                           "proteingym_tpu_torch.models.gemme", "proteingym_tpu_torch.models.siterm",
                           "proteingym_tpu_torch.models.rsalor",
                           "proteingym_tpu_torch.models.provean",
                           "proteingym_tpu_torch.data.structures",
                           "proteingym_tpu_torch.models.ar_zoo",
                           "proteingym_tpu_torch.models.progen3",
                           "proteingym_tpu_torch.models.unirep",
                           "proteingym_tpu_torch.models.esmc", "proteingym_tpu_torch.models.esm3",
                           "proteingym_tpu_torch.models.xtrimo",
                           "proteingym_tpu_torch.models.carp",
                           "proteingym_tpu_torch.models.gvp_transformer",
                           "proteingym_tpu_torch.models.protein_mpnn",
                           "proteingym_tpu_torch.models.saprot",
                           "proteingym_tpu_torch.ops.tridi",
                           "proteingym_tpu_torch.models.prosst",
                           "proteingym_tpu_torch.models.prosst_quantizer",
                           "proteingym_tpu_torch.models.mulan",
                           "proteingym_tpu_torch.models.structure_plms",
                           "proteingym_tpu_torch.ops.gvp", "proteingym_tpu_torch.ops.gnn",
                           "proteingym_tpu_torch.models.state_dict",
                           "proteingym_tpu_torch.models.protssn",
                           "proteingym_tpu_torch.models.s3f",
                           "proteingym_tpu_torch.models.prot_t5",
                           "proteingym_tpu_torch.models.vespa_heads",
                           "proteingym_tpu_torch.models.vespag",
                           "proteingym_tpu_torch.models.supervised_baselines",
                           "proteingym_tpu_torch.models.protein_npt",
                           "proteingym_tpu_torch.models.kermut",
                           "proteingym_tpu_torch.merge.supervised",
                           "proteingym_tpu_torch.metrics.supervised",
                           "proteingym_tpu_torch.models.esm_train",
                           "proteingym_tpu_torch.parallel.mesh",
                           "proteingym_tpu_torch.ops.ring_attention",
                           "proteingym_tpu_torch.pipeline.profiler")
               if m not in sys.modules]
    if missing:
        fail(f"modules the phases drive were not loaded: {missing}")
    jax_package = sorted(m for m in sys.modules
                         if m == "proteingym_tpu" or m.startswith("proteingym_tpu."))
    if jax_package:
        fail(f"modules of the JAX package were loaded: {jax_package}")
    k1_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "call_ms")
    measured = {
        # K1's main path is PoET's self tier; the ESM headline shape beside it
        "grouped_attention": dict(
            max_abs_err=max(max_abs_err, k2["k1_self_err"], msa_run["k1_err"],
                            tr_run["k1_err"], indel_run["k1"]["max_abs_err"], zoo["k1_err"],
                            mlm["k1_err"], plms["k1"]["max_abs_err"],
                            *(rec["max_abs_err"] for rec in slice_c["k1"])),
            shape="B8 H16 T4352 D64, 16 segments + causal",
            **{key: k2["k1"][key] for key in k1_keys},
            other_shapes=[{"shape": "B16 H20 T256 D64 mask+rope, pre-pass + loop",
                           "ms": ms, "plain_ms": plain_ms}, msa_run["k1"]]),
        "flash_attention": dict(max_abs_err=max(k2["max_abs_err"], mlm["k2"]["max_abs_err"]),
                                ms=k2["ms"],
                                plain_ms=k2["plain_ms"], library_ms=k2["library_ms"],
                                bound_ms=k2["bound_ms"], bound_by=k2["bound_by"],
                                call_ms=k2["call_ms"], sdpa_causal_ms=k2["sdpa_causal_ms"]),
        **k3_k4,
        "cluster_counts": dict(max_abs_err=0.0, **k5),
    }
    by_path = {"esm": launches, "esm_windowed": win_launches,
               "poet": poet_run["launches"], "esm_packed": packed["launches"],
               "esm_segment_packed": seg_packed["launches"], "esm_wt": wt["wt_launches"],
               "esm_pppl": wt["pppl_launches"], "msa_transformer": msa_run["launches"],
               "trancepteve": tr_run["launches"], "tranception_windows": tr_run["long_launches"],
               "eve": tr_run["eve_launches"], "trancepteve_indel": indel_run["a"]["launches"],
               "tranception_indel": indel_run["a_tranception"]["launches"],
               **trainers["launches"], **baselines["launches"], **zoo["launches"],
               **mlm["launches"], **structure["launches"], **plms["launches"],
               **slice_c["launches"], **supervised["launches"], **parallel["launches"]}
    records = [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(c.get(name, 0) for c in by_path.values()),
        **measured[name],
        "launches_by_path": {path: c.get(name, 0) for path, c in by_path.items()},
    } for name, (source, replaces) in KERNELS.items()]
    # K1 at Tranception's two shapes, each with the launches of its path
    source, replaces = KERNELS["grouped_attention"]
    for rec, path in zip(tr_run["k1"], ("trancepteve", "tranception_windows")):
        records.append({"name": f"grouped_attention:{rec['shape'].split()[2]}_tranception",
                        "route": "cuda", "source": source, "replaces": replaces,
                        "launches": by_path[path]["grouped_attention"], "counter":
                        "grouped_attention", "path": path, **rec})
    # K1 at the indel bucket, with the launches of the trancepteve --indel-mode path
    records.append({"name": f"grouped_attention:T{K1_INDEL[2]}_indel", "route": "cuda",
                    "source": source, "replaces": replaces,
                    "launches": by_path["trancepteve_indel"]["grouped_attention"],
                    "counter": "grouped_attention", "path": "trancepteve_indel",
                    **indel_run["k1"]})
    # the float32 K1 at the AR zoo's shapes, each with the launches of its path
    for rec in zoo["k1"]:
        path = rec["label"]
        records.append({"name": f"grouped_attention:f32_{path}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": by_path[path]["grouped_attention"],
                        "counter": "grouped_attention", "path": path, **rec})
    # K1 at phase 19's four shapes, each with the launches of its path
    for rec, path in zip(mlm["k1"], ("esmc", "xtrimopglm", "xtrimopglm_ar", "esm3")):
        records.append({"name": f"grouped_attention:{rec['label']}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": by_path[path]["grouped_attention"],
                        "counter": "grouped_attention", "path": path, **rec})
    # the float32 K1 at ESM-IF1's decoder rows, with the launches of the esm_if1 path
    records.append({"name": "grouped_attention:f32_esm_if1", "route": "cuda", "source": source,
                    "replaces": replaces, "launches": by_path["esm_if1"]["grouped_attention"],
                    "counter": "grouped_attention", "path": "esm_if1", **structure["k1"]})
    # K4 at SaProt-650M's rows, with the launches of the saprot path
    source4, replaces4 = KERNELS["grouped_attention_bthd"]
    records.append({"name": "grouped_attention_bthd:saprot_650m", "route": "cuda",
                    "source": source4, "replaces": replaces4,
                    "launches": by_path["saprot"]["grouped_attention_bthd"],
                    "counter": "grouped_attention_bthd", "path": "saprot", **structure["k4"]})
    # K4 at ESM2-3B's rows (VespaG's trunk), with the launches of the vespag path
    records.append({"name": f"grouped_attention_bthd:{supervised['k4']['label']}",
                    "route": "cuda", "source": source4, "replaces": replaces4,
                    "launches": by_path["vespag"]["grouped_attention_bthd"],
                    "counter": "grouped_attention_bthd", "path": "vespag", **supervised["k4"]})
    # the float32 K4 and K1 at MULAN-small's trunk and adapter, with the launches of the mulan path
    for rec, counter in ((plms["k4"], "grouped_attention_bthd"), (plms["k1"], "grouped_attention")):
        src, rep_ = KERNELS[counter]
        records.append({"name": f"{counter}:{rec['label']}", "route": "cuda", "source": src,
                        "replaces": rep_, "launches": by_path["mulan"][counter],
                        "counter": counter, "path": "mulan", **rec})
    # bf16 K1 at AIDO's two shapes, with the launches of the aido path of each
    for rec, path in zip(slice_c["k1"], ("aido", "aido_L1000")):
        records.append({"name": f"grouped_attention:{rec['label']}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": by_path[path]["grouped_attention"],
                        "counter": "grouped_attention", "path": path, **rec})
    # K4 at the chunk of score --mesh, and the float32 K1 at the expert-parallel
    # ProGen3-3b's rows, each with the launches of its path
    records.append({"name": "grouped_attention_bthd:esm_mesh", "route": "cuda",
                    "source": source4, "replaces": replaces4,
                    "launches": by_path["esm_mesh"]["grouped_attention_bthd"],
                    "counter": "grouped_attention_bthd", "path": "esm_mesh", **parallel["k4"]})
    records.append({"name": "grouped_attention:f32_progen3_expert", "route": "cuda",
                    "source": source, "replaces": replaces,
                    "launches": by_path["progen3_expert"]["grouped_attention"],
                    "counter": "grouped_attention", "path": "progen3_expert", **parallel["k1"]})
    # K2 in float32 at ESM3's rows past 1,024 tokens, with the launches of that path
    source, replaces = KERNELS["flash_attention"]
    records.append({"name": "flash_attention:esm3_long", "route": "cuda", "source": source,
                    "replaces": replaces, "launches": by_path["esm3_long"]["flash_attention"],
                    "counter": "flash_attention", "path": "esm3_long", **mlm["k2"]})
    records.append({"name": "layer_norm", "route": "cuda", "source": LAYER_NORM_SOURCE,
                    "replaces": None,
                    "launches": sum(c.get("layer_norm", 0) for c in by_path.values()), **norm,
                    "launches_by_path": {path: c.get("layer_norm", 0)
                                         for path, c in by_path.items()}})
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
